#!/usr/bin/env python3
"""Run the PyTorch port's alignment paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. setup: a CUDA card must be present; prints its nvidia-smi name and
     power limit and the torch / CUDA versions;
  1. build: nvcc builds the CUDA kernels from basal_tpu_torch/csrc while
     g++ builds the port's C++ host engine (basal_tpu_torch/native); both
     times are printed, then ptxas -v's registers, shared memory, stack
     frame and spills of every kernel instantiation; the phase fails if
     any of the six (two kernels, three rule modes) uses local memory;
  2. kernels vs plain versions on the card: every wave of a real batch
     must equal the plain PyTorch version exactly.  Count kernel: reads of
     64-150 bp, some with Ns, under C:T, A:CGT, C:T -3 and A:G -N.  Gap
     kernel: the same with planted deletions and insertions, under T:- -g 3,
     C:T -g 1, A:CGT -g 2 and C:T -3 -g 2.  Then each kernel and its plain
     version are timed at C = 2^20 candidates, W = 7 words (100 bp),
     U = 8192 rows over a 50 Mbp reference (the count kernel in all three
     modes, the gap kernel at gap 3), beside the least time the card could
     take for the same work (``bound``), and both kernels once more over
     a 2 Gbp reference, out of L2 (four waves of different candidates in
     turn).  A kernel's time is the card's own: the
     mean duration of its launches in torch.profiler's kernel events.  The
     CUDA events around back-to-back wrapper calls are printed beside it as
     the time per call, host included;
  2c. the fetch watchdog on a real CUDA event: a TorchDeviceContext over
     the 50 Mbp timing reference, armed with a measured cost of 1e-12 s
     per candidate and BASAL_TPU_WATCHDOG_MIN=0, is handed the gap-3
     timing wave the moment it is launched; its fetch must raise and count
     one stall.  A second wave on the same context, with the watchdog off,
     must then equal the plain version;
  2b. the dp x rs mesh: on real waves (count kernel under C:T, gap kernel
     under T:- -g 3), ShardedTorchDeviceContext at 1x4, 2x2 and 4x1 over
     [cuda:i % cards] must equal TorchDeviceContext element for element,
     with one launch per wave of a dp slice and rs shard; the wall per
     wave of both is printed;
  3. main path: 200k 100 bp A:G reads against a 50 Mbp random reference
     through basal_tpu_torch's run_single_end with every wave forced onto
     the card (BASAL_TPU_HOST_EVAL=0); the SAM must be byte-identical to
     the run that evaluates every candidate with the C++ host evaluator;
     then the device-forced run once more under torch.profiler for the
     card's busy time, the count kernel's launches (one per wave), busy
     time and time per launch, and the candidates per wave;
  3b. gapped single-end: 200k 100 bp BID-seq reads (-M T:- -g 3) the same
     way, through the gap kernel, and under torch.profiler as in 3;
  3c. paired-end: 100k pairs of 100 bp through run_pair_end, -M C:T (count
     kernel) and -M C:T -g 2 with planted deletions (gap kernel), each
     device-forced against the host evaluator;
  3d. two processes (python -m basal_tpu_torch.parallel.worker, gloo
     backend, both on the card) align phase 3's reads device-forced, each
     its read window, with the seed index split between them and routed
     (TorchRoutedSeedIndex); their SAM, concatenated, must be
     byte-identical to phase 3's device-forced SAM, and the rs mesh that
     spans the two processes must equal the single context;
  3e. dryrun_multichip(4) of basal_tpu_torch.entry over [cuda:i % cards];
  3f. the toolkit halves of the examples/ recipes, in this process, on the
     port's card-aligned output.  GLORI/eTAM: phase 3's device-forced SAM
     through bamutil view (to BAM), view -F 0xE04, sort and index, then
     avgmod -M A:G -T RNA; the reads had half their A's turned to G, so
     sum(N_mod) / sum(N_total) over the sites must lie in 0.40-0.60.
     BID-seq: the first 50k reads of phase 3b aligned by the port's CLI to
     BAM (-M T:- -n 1 -g 3 -R -u -S 1), device-forced and with the host
     evaluator, whose decoded BAMs must be equal (@PG aside); then view -F
     0xE04, sort, shiftD, sort and avgmod -M T:- -D M -T RNA -y 7 -m 1
     (the 50k reads cover the 50 Mbp at 0.1x, so the default depth of 4
     would leave almost no site); it must write sites, some of them with
     deletions counted as modified.  Each step's wall is printed;
  3g. where a fault could hide: SE multiway (-M A:CGT) and SE nt3 (-M C:T
     -3) on 50k reads of 64-150 bp, each device-forced against the host
     evaluator as in 3; SE A:G with -p 4, device-forced, whose SAM must
     equal phase 3's -p 1 device-forced SAM;
  4. neither jax nor basal_tpu may have been imported.

Each path of phase 3 starts with every launch count at 0; a path fails if
its kernel did not launch once per device wave, or if a fetch watchdog of
its device contexts counted a stall.  Whether pandas imports is printed:
the toolkit's fdr and regmod need it, and are not run here.

Data is made with numpy from a fixed seed under build/chip_smoke/ and
removed at exit.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
GENOME = 50_000_000      # bench.py's realistic genome size
N_READS = 200_000        # 5 batches: BATCH_NUM = 50k, cut at reader chunks
N_PAIRS = 100_000
N_SMALL = 50_000         # reads of the multiway, nt3 and BID-seq recipe runs
READLEN = 100
N_FRAC = 0.02            # reads given one N (exception rows in the blob)
WAVE_READS = 20_000      # reads per phase-2 configuration
PHASE2 = [("C:T", False, False), ("A:CGT", False, False),
          ("C:T", True, False), ("A:G", False, True)]
PHASE2_GAP = [("T:-", 3, False), ("C:T", 1, False), ("A:CGT", 2, False),
              ("C:T", 2, True)]            # (rule, gap, nt3)
BENCH_C, BENCH_W, BENCH_U, BENCH_GAP = 1 << 20, 7, 8192, 3
# the count kernel's timing shape out of L2: 1 GB of packed words, 20x the
# L2; a 31-bit loc addresses at most 2^31 bases per shard.  Its waves of
# different candidates alternate, each touching some 64 MB of sectors, so a
# launch finds little of the last ones' windows in the 50 MB L2
GENOME_OUT_OF_L2 = 2_000_000_000
WAVES_OUT_OF_L2 = 4
NT = b"ACGT"
# an H100 SXM's published peaks (700 W): device memory, and 32-bit lanes
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
# integer operations per read word of one alignment (funnel shift, rule,
# masks, lane bits, popcount), and per position a bit walk extracts,
# counted from csrc/count_kernel.cu and csrc/gap_kernel.cu
OPS_PER_WORD = 16
OPS_PER_POSITION = 4


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def kernel_resources(report):
    """ptxas -v's registers, shared memory, stack frame and spill bytes of
    each kernel instantiation, by "kernel<mode id>"."""
    import re
    res, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            name = m.group(1)
            k = re.search(r"(count_blob_kernel|gap_blob_kernel)ILi(\d+)E",
                          name)
            cur = res.setdefault(f"{k.group(1)}<{k.group(2)}>", {}) \
                if k else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                       spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return res


def local_memory_gate(resources):
    """Phase 1's gate on kernel_resources' result: every instantiation of
    both kernels must be there with 0 bytes of stack frame, spill stores
    and spill loads.  Modes 0, 1, 2 are oneway, multiway, nt3; W is a
    runtime argument, so each instantiation is the one every W launches.
    Raises AssertionError naming the offenders."""
    fields = ("stack", "spill_st", "spill_ld")
    bad = {name: resources.get(name) for name in
           (f"{k}<{m}>" for k in ("count_blob_kernel", "gap_blob_kernel")
            for m in range(3))
           if any(resources.get(name, {}).get(f, 1) for f in fields)}
    if bad:
        raise AssertionError(f"kernels missing from the ptxas report or "
                             f"using local memory: {bad}")


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def write_fasta(path, g):
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        n = len(g) // 60 * 60
        f.write(b"\n".join(g[:n].reshape(-1, 60).view("S60").ravel()) + b"\n")
        if n < len(g):
            f.write(g[n:].tobytes() + b"\n")


def write_fastq(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


def convert(rng, reads, rule):
    """Apply the rule's conversion (rate 0.5) and 0.5% substitutions."""
    import numpy as np
    frm, tos = rule.split(":")
    conv = (reads == ord(frm)) & (rng.random(reads.shape) < 0.5)
    to = np.frombuffer(tos.encode(), np.uint8)
    reads = np.where(conv, rng.choice(to, size=reads.shape), reads)
    nt = np.frombuffer(NT, np.uint8)
    err = rng.random(reads.shape) < 0.005
    return np.where(err, rng.choice(nt, size=reads.shape), reads).astype(
        np.uint8)


def add_ns(rng, reads, lens):
    """One N in about N_FRAC of the reads."""
    import numpy as np
    hit = np.flatnonzero(rng.random(len(reads)) < N_FRAC)
    reads[hit, (rng.random(hit.size) * lens[hit]).astype(np.int64)] = ord("N")


def bench_reads(rng, g, n):
    """n 100 bp reads as bench.py makes them, with -M A:G conversions."""
    import numpy as np
    pos = rng.integers(0, len(g) - READLEN, n)
    reads = g[pos[:, None] + np.arange(READLEN)[None, :]]
    reads = convert(rng, reads, "A:G")
    add_ns(rng, reads, np.full(n, READLEN))
    return [r.tobytes() for r in reads]


def mixed_reads(rng, g, n, rule):
    """n reads of 64-150 bp with the rule's conversions, some with Ns."""
    import numpy as np
    lens = rng.integers(64, 151, n)
    pos = rng.integers(0, len(g) - 150, n)
    reads = convert(rng, g[pos[:, None] + np.arange(150)[None, :]], rule)
    add_ns(rng, reads, lens)
    return rows(reads, lens)


def compact(win, drop, n):
    """Rows of ``win`` without the ``drop`` bases, cut to n: (matrix,
    lengths).  A row that keeps fewer than n bases is that much shorter."""
    import numpy as np
    order = np.argsort(drop, axis=1, kind="stable")   # kept bases first
    kept = np.take_along_axis(win, order, axis=1)[:, :n]
    return kept, np.minimum(n, (~drop).sum(axis=1))


def rows(mat, lens):
    """Read sequences as bytes: row i of ``mat`` cut to lens[i]."""
    return [r[:ln].tobytes() for r, ln in zip(mat, lens)]


def gapped_reads(rng, g, n, rule, gap):
    """n reads of 64-150 bp: a third with a deletion and a third with an
    insertion of 1..gap bases at 15..48; the rule's conversions and 0.5%
    substitutions (T:-: each T dropped with p = 0.04 instead, as BID-seq
    reads are made); about N_FRAC with one N."""
    import numpy as np
    frm, tos = rule.split(":")
    span = 150 + 8
    pos = rng.integers(0, len(g) - span, n)
    win = g[pos[:, None] + np.arange(span)[None, :]]
    col = np.arange(span)[None, :]
    kind = rng.integers(0, 3, n)                 # 0 none, 1 del, 2 ins
    j = rng.integers(15, 64 - 15, n)[:, None]
    d = rng.integers(1, gap + 1, n)[:, None]
    drop = (kind[:, None] == 1) & (col >= j) & (col < j + d)
    if tos == "-":
        drop |= (win == ord(frm)) & (rng.random(win.shape) < 0.04)
    reads, _ = compact(win, drop, span)
    # insertion rows: reads[:j] + d random bases + reads[j:]
    ins = rng.choice(np.frombuffer(NT, np.uint8), size=(n, gap))
    inside = (col >= j) & (col < j + d)
    src = np.where(col < j, col, np.where(inside, 0, col - d))
    grown = np.where(inside, ins[np.arange(n)[:, None],
                                 np.clip(col - j, 0, gap - 1)],
                     np.take_along_axis(reads, src, axis=1))
    reads = np.where((kind == 2)[:, None], grown, reads)
    if tos != "-":
        reads = convert(rng, reads, rule)
    lens = rng.integers(64, 151, n)
    add_ns(rng, reads, lens)
    return rows(reads, lens)


def bidseq_reads(rng, g, n):
    """n 100 bp BID-seq reads as tools/gapbench.py makes them: a window of
    L+8 bases, each T dropped with p = 0.04, cut to L, 0.3% substitutions;
    about N_FRAC with one N."""
    import numpy as np
    span = READLEN + 8
    pos = rng.integers(0, len(g) - span, n)
    win = g[pos[:, None] + np.arange(span)[None, :]]
    reads, lens = compact(win, (win == ord("T"))
                          & (rng.random(win.shape) < 0.04), READLEN)
    err = rng.random(reads.shape) < 0.003
    reads = np.where(err, rng.choice(np.frombuffer(NT, np.uint8),
                                     size=reads.shape), reads)
    add_ns(rng, reads, lens)
    return rows(reads, lens)


def pe_reads(rng, g, n, gap=0):
    """n pairs of 100 bp from C:T-converted fragments of 150..399 bp
    (tests/test_differential_pe.py:19's simulator): read 1 the fragment's
    5' end, read 2 the reverse complement of its 3' end; 1% substitutions,
    10% orphans whose mate 2 is random.  With ``gap``, a third of the read
    1s lose 1..gap bases at 15..84."""
    import numpy as np
    nt = np.frombuffer(NT, np.uint8)
    ins = rng.integers(150, 400, n)
    pos = rng.integers(0, len(g) - 400, n)
    frag = g[pos[:, None] + np.arange(400)[None, :]]
    conv = (frag == ord("C")) & (rng.random(frag.shape) < 0.5)
    frag = np.where(conv, ord("T"), frag).astype(np.uint8)
    sub = ~conv & (rng.random(frag.shape) < 0.01)
    frag = np.where(sub, rng.choice(nt, size=frag.shape), frag)
    span = READLEN + gap
    r1 = frag[:, :span]
    col = np.arange(span)[None, :]
    j = rng.integers(15, 85, n)[:, None]
    d = rng.integers(1, gap + 1, n)[:, None] if gap else 0
    cut = (rng.random(n) < 1 / 3)[:, None] & (col >= j) & (col < j + d)
    r1, l1 = compact(r1, cut, READLEN)
    comp = np.zeros(256, np.uint8)
    comp[nt] = np.frombuffer(b"TGCA", np.uint8)
    tail = (ins - READLEN)[:, None] + np.arange(READLEN)[None, :]
    r2 = comp[np.take_along_axis(frag, tail, axis=1)][:, ::-1]
    orphan = rng.random(n) < 0.1
    r2[orphan] = rng.choice(nt, size=(int(orphan.sum()), READLEN))
    return rows(r1, l1), [r.tobytes() for r in r2]


def write_pairs(path1, path2, r1, r2):
    for path, seqs, mate in ((path1, r1, 1), (path2, r2, 2)):
        with open(path, "wb") as f:
            for i, s in enumerate(seqs):
                f.write(b"@p%d/%d\n%s\n+\n%s\n" % (i, mate, s,
                                                     b"I" * len(s)))


def wave_candidates(p, fasta, fq, device):
    """(aligner, encoded batch, loc, plane, row) of the first batch of fq:
    every candidate of every stratum, as the device-forced path ships
    them."""
    import numpy as np
    from basal_tpu_torch.align.pipeline import TorchSingleEndAligner
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.index.seedindex import build_index
    from basal_tpu_torch.reads.encode import encode_batch
    from basal_tpu_torch.reads.io import open_reads
    ref = load_reference(str(fasta), p)
    aligner = TorchSingleEndAligner(p, ref, build_index(ref, p),
                                    device=device)
    reader = open_reads(str(fq), p, readset=0)
    enc = encode_batch(p, reader.next_batch())
    reader.close()
    nb = aligner.native
    groups, _goff, _total = nb.build_groups(enc, enc.reads.indices)
    off = np.full(groups.shape[0], -1, np.int64)
    loc, plane, row = nb.fill_groups(enc, groups,
                                     np.arange(groups.shape[0]), off)
    return aligner, enc, loc, plane.astype(np.int32), row


def kernel_checks(fasta, g, work, device, n_reads=WAVE_READS):
    """Phase 2a: every wave of a real batch, kernel == plain version.
    Returns the largest absolute difference (0 when all are equal)."""
    import numpy as np
    import torch
    from basal_tpu_torch.align.pipeline import blob_to_device
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob

    rng = np.random.default_rng(SEED + 1)
    worst = 0
    for rule, nt3, n_mis in PHASE2:
        name = rule + (" -3" if nt3 else "") + (" -N" if n_mis else "")
        p = AlignParams(conversion=rule, randseed=1, nt3=nt3, n_mis=n_mis,
                        batch_reads=n_reads)
        fq = work / "waves.fq"
        write_fastq(fq, mixed_reads(rng, g, n_reads, rule))
        aligner, enc, loc, plane, row = wave_candidates(p, fasta, fq, device)
        ctx = aligner.dev
        n_waves = n_cand = n_exc = n_zero = 0
        for blob, C, U, E in ctx.wave_blobs(enc, loc, plane, row):
            shape = dict(mode=ctx.mode, W=enc.W, nw=ctx.nw, C=C, U=U, E=E)
            dblob, _staging = blob_to_device(blob, device)
            before = extend_counts_blob.launches
            got = extend_counts_blob(ctx.ref32, dblob, **shape)
            want = extend_kernel_blob(ctx.ref32, dblob, **shape)
            if device.type == "cuda" and extend_counts_blob.launches != before + 1:
                raise AssertionError("the count kernel did not launch")
            diff = int((got.int() - want.int()).abs().max()) if C else 0
            worst = max(worst, diff)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel != plain version "
                                     f"(max abs diff {diff}, C={C})")
            n_waves += 1
            n_cand += C
            n_exc += int(((blob[C + U + 1:C + 2 * U + 1] >> 20) & 0xFFF)
                         .astype(bool).sum())
            n_zero += int((want == 0).sum())
        if n_cand == 0 or n_exc == 0 or n_zero == 0:
            raise AssertionError(f"{name}: degenerate waves: {n_cand} cand, "
                                 f"{n_exc} N rows, {n_zero} zero counts")
        log(f"kernel == plain [{name}]: {n_waves} waves, {n_cand} candidates "
            f"({n_zero} with 0 mismatches), {n_exc} N rows, W={enc.W}")
    return worst


def gap_kernel_checks(fasta, g, work, device, n_reads=WAVE_READS):
    """Phase 2a, gap kernel: every wave of a real gapped batch, kernel ==
    plain version on counts, pos0 and pos1.  Returns the largest absolute
    difference (0 when all are equal)."""
    import numpy as np
    import torch
    from basal_tpu_torch.align.pipeline import blob_to_device
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend import (K_POS, candidate_rows,
                                            carve_blob, extend_kernel_blob)
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob

    rng = np.random.default_rng(SEED + 3)
    worst = 0
    for rule, gap, nt3 in PHASE2_GAP:
        name = f"{rule}{' -3' if nt3 else ''} -g {gap}"
        p = AlignParams(conversion=rule, randseed=1, nt3=nt3, gap=gap,
                        batch_reads=n_reads)
        fq = work / "gap_waves.fq"
        write_fastq(fq, gapped_reads(rng, g, n_reads, rule, gap))
        aligner, enc, loc, plane, row = wave_candidates(p, fasta, fq, device)
        ctx = aligner.dev
        n_waves = n_cand = n_exc = n_full0 = n_full1 = n_zero = 0
        for blob, C, U, E in ctx.wave_blobs(enc, loc, plane, row):
            shape = dict(mode=ctx.mode, gap=gap, W=enc.W, nw=ctx.nw, C=C,
                         U=U, E=E)
            dblob, _staging = blob_to_device(blob, device)
            before = extend_gap_blob.launches
            got = extend_gap_blob(ctx.ref32, dblob, **shape)
            want = extend_kernel_blob(ctx.ref32, dblob, **shape)
            if extend_gap_blob.launches != before + 1:
                raise AssertionError("the gap kernel did not launch")
            for part, a, b in zip(("counts", "pos0", "pos1"), got, want):
                diff = int((a.int() - b.int()).abs().max()) if C else 0
                worst = max(worst, diff)
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: gap kernel != plain "
                                         f"version on {part} (max abs diff "
                                         f"{diff}, C={C})")
            carved = carve_blob(dblob, mode=ctx.mode, W=enc.W, C=C, U=U, E=E)
            rl = carved[8][candidate_rows(carved[2], C)]
            counts, pos0, pos1 = (t.long() for t in want)
            n_waves += 1
            n_cand += C
            n_exc += int(((blob[C + U + 1:C + 2 * U + 1] >> 20) & 0xFFF)
                         .astype(bool).sum())
            n_full0 += int((pos0[:, K_POS - 1] < rl).sum())
            n_full1 += int((pos1[:, :, K_POS - 1] < rl[:, None]).any(1).sum())
            n_zero += int((counts == 0).sum())
        if min(n_cand, n_exc, n_full0, n_full1, n_zero) == 0:
            raise AssertionError(f"{name}: degenerate waves: {n_cand} cand, "
                                 f"{n_exc} N rows, {n_full0} / {n_full1} "
                                 f"with >= {K_POS} mismatches in the main / "
                                 f"a shifted alignment, {n_zero} exact")
        log(f"gap kernel == plain [{name}]: {n_waves} waves, {n_cand} "
            f"candidates ({n_zero} exact, {n_full0} / {n_full1} with >= "
            f"{K_POS} mismatches in the main / a shifted alignment), "
            f"{n_exc} N rows, W={enc.W}")
    return worst


def synthetic_reference(device, genome=GENOME):
    """(ref32 on the device, nw): both planes of a random packed reference
    of ``genome`` bases, made with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 2)
    nw = genome // 16 + 4
    ref32 = rng.integers(0, 1 << 32, 2 * nw, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(ref32).to(device), nw


def synthetic_wave(mode, device, ref, C=BENCH_C, W=BENCH_W, U=BENCH_U,
                   seed=SEED + 2):
    """A wave at the timing shape over ``ref`` (synthetic_reference's):
    (ref32, blob, shape) with candidates spread over both planes, U equal
    rows of 100 bp reads without Ns."""
    import numpy as np
    import torch
    ref32, nw = ref
    rng = np.random.default_rng(seed)
    loc = rng.integers(16, 16 * (nw - W - 4), C).astype(np.uint32)
    plane = rng.integers(0, 2, C).astype(np.uint32)
    parts = [(loc | (plane << np.uint32(31))).view(np.int32),
             np.linspace(0, C, U + 1).astype(np.int32),
             np.full(U, READLEN, np.int32)]
    n_planes = 2 if mode == "multiway" else 1
    parts.append(rng.integers(0, 1 << 32, n_planes * U * W,
                              dtype=np.uint32).view(np.int32))
    parts.append(np.zeros(W, np.int32))     # E = 1 unused exception row
    blob = np.concatenate(parts)
    return (ref32, torch.from_numpy(blob).to(device),
            dict(mode=mode, W=W, nw=nw, C=C, U=U, E=1))


def bound(blob, shape, gap=0):
    """(ms, "bytes" or "operations"): the least time the card could take for
    one call at this wave: every byte the call must move (the blob, each
    distinct reference word its windows touch, the outputs) over the
    memory rate, against its integer operations over the lane rate."""
    import torch
    C, W, nw = shape["C"], shape["W"], shape["nw"]
    locp = blob[:C].long() & 0xFFFFFFFF
    first = (locp >> 31) * nw + ((locp & 0x7FFFFFFF) >> 4)
    # the count kernel reads words first..first+W, the gap kernel one more
    # on either side
    span = torch.arange(-1, W + 2, device=blob.device) if gap else \
        torch.arange(0, W + 1, device=blob.device)
    words = (first[:, None] + span[None, :]).clamp_(0, 2 * nw - 1)
    n_words = int(torch.unique(words).numel())
    out = C * (1 + 2 * 14 + 2 * gap * 14 * 2) if gap else C
    nbytes = blob.numel() * 4 + 4 * n_words + out
    aligns = 1 + 2 * gap
    ops = C * W * aligns * OPS_PER_WORD + C * 14 * aligns * OPS_PER_POSITION \
        * (gap > 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters):
    """Mean ms per call, host included: CUDA events around ``iters``
    back-to-back calls (after one warm-up).  Where a wrapper's host work per
    call exceeds its kernel's time, the card waits between launches and
    this times the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(prof, name):
    """Durations (ms, the card's clock) of the CUDA kernels of a
    torch.profiler trace whose name holds ``name``."""
    import torch
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]


def recorded(session, name, want):
    """Run ``session()``, a torch.profiler session that returns (result,
    durations of kernel ``name``'s launches), until it recorded all ``want``
    launches, at most three times: CUPTI drops an event now and then, and
    once in a while a whole session's.  Returns the session that recorded
    the most; raises if one recorded more than ``want``, or the best under
    half of them."""
    best = None
    for _ in range(3):
        res, durs = session()
        if len(durs) > want:
            raise AssertionError(f"the profiler recorded {len(durs)} "
                                 f"launches of {name}, want {want}")
        if best is None or len(durs) > len(best[1]):
            best = res, durs
        if len(durs) == want:
            break
        log(f"the profiler recorded {len(durs)} of {want} launches of {name}")
    if 2 * len(best[1]) < want:
        raise AssertionError(f"three profiler sessions recorded at most "
                             f"{len(best[1])} of {want} launches of {name}")
    return best


def device_ms(fn, name, iters, per_call=1):
    """Mean device ms of one launch of kernel ``name``, from torch.profiler's
    kernel events over ``iters`` calls of ``fn`` (after one warm-up), each
    launching it ``per_call`` times (``recorded``'s sessions)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()

    def session():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return None, kernel_events(prof, name)

    durs = recorded(session, name, iters * per_call)[1]
    return sum(durs) / len(durs)


def timed_kernel(name, kern, plain, iters, plain_iters, per_call=1):
    """Kernel and plain version in turns (plain, kernel, kernel, kernel,
    plain): (device ms per launch, [event-timed ms per launch, host
    included] x 2, [plain ms per launch] x 2)."""
    p1 = time_ms(plain, plain_iters) / per_call
    c1 = time_ms(kern, iters) / per_call
    dev = device_ms(kern, name, iters, per_call)
    c2 = time_ms(kern, iters) / per_call
    p2 = time_ms(plain, plain_iters) / per_call
    return dev, [c1, c2], [p1, p2]


def check_counts(ref32, blobs, shape, what):
    """The count kernel == its plain version on each blob."""
    import torch
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    for blob in blobs:
        got = extend_counts_blob(ref32, blob, **shape)
        want = extend_kernel_blob(ref32, blob, **shape)
        if not torch.equal(got, want):
            diff = int((got.int() - want.int()).abs().max())
            raise AssertionError(f"{what}: kernel != plain (max abs diff "
                                 f"{diff})")


def count_timing(device, ref, label, waves=1, iters=50, plain_iters=5):
    """Phase 2, timing, count kernel: each mode at the timing shape over
    ``ref``, kernel == plain first.  With ``waves`` > 1, that many waves of
    different candidates alternate, so that a launch finds little of the
    last one's windows in L2.  Returns {mode: {device_ms, call_ms,
    plain_ms, bound_ms, bound_by}}, ms per 2^20 candidates, call_ms and
    plain_ms as [first, second] timing."""
    import torch
    from basal_tpu_torch.ops.extend import MODES, extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    out = {}
    for mode in MODES:
        made = [synthetic_wave(mode, device, ref, seed=SEED + 20 + k)
                for k in range(waves)]
        ref32, shape = made[0][0], made[0][2]
        blobs = [m[1] for m in made]
        check_counts(ref32, blobs, shape, f"{mode} at the {label} shape")
        dev, calls, plains = timed_kernel(
            "count_blob_kernel",
            lambda: [extend_counts_blob(ref32, b, **shape) for b in blobs],
            lambda: [extend_kernel_blob(ref32, b, **shape) for b in blobs],
            iters, plain_iters, per_call=waves)
        b_ms, b_by = bound(blobs[0], shape)
        s = (1 << 20) / shape["C"]
        out[mode] = dict(device_ms=dev * s, call_ms=[c * s for c in calls],
                         plain_ms=[p * s for p in plains], bound_ms=b_ms * s,
                         bound_by=b_by)
        log(f"timing count [{mode}, {label}] C={shape['C']} W={shape['W']} "
            f"U={shape['U']}, {waves} wave(s): device {dev * s:.4f} ms, per "
            f"call host included {calls[0] * s:.4f} / {calls[1] * s:.4f} "
            f"ms, plain {plains[0] * s:.4f} / {plains[1] * s:.4f} ms, bound "
            f"{b_ms * s:.4f} ms ({b_by}), device at "
            f"{100 * b_ms / dev:.1f}% of it, per 2^20 candidates")
        del made, blobs
    torch.cuda.empty_cache()
    return out


def gap_kernel_timing(device, ref, label, waves=1, iters=20, plain_iters=3):
    """Phase 2, timing, gap kernel: kernel == plain, then both at the
    timing shape over ``ref``, gap 3, oneway, in turns; with ``waves`` > 1
    that many waves of different candidates alternate, as in count_timing.
    Returns {device_ms, call_ms, plain_ms, bound_ms, bound_by} as
    count_timing does."""
    import torch
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    made = [synthetic_wave("oneway", device, ref, seed=SEED + 2 + k)
            for k in range(waves)]
    ref32, shape = made[0][0], made[0][2]
    shape["gap"] = BENCH_GAP
    blobs = [m[1] for m in made]
    for blob in blobs:
        got = extend_gap_blob(ref32, blob, **shape)
        want = extend_kernel_blob(ref32, blob, **shape)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"gap kernel != plain at the {label} shape")
        del got, want
    dev, calls, plains = timed_kernel(
        "gap_blob_kernel",
        lambda: [extend_gap_blob(ref32, b, **shape) for b in blobs],
        lambda: [extend_kernel_blob(ref32, b, **shape) for b in blobs],
        iters, plain_iters, per_call=waves)
    s = (1 << 20) / shape["C"]
    b_ms, b_by = bound(blobs[0], shape, gap=BENCH_GAP)
    log(f"timing [gap {BENCH_GAP} oneway, {label}] C={shape['C']} "
        f"W={shape['W']} U={shape['U']}, {waves} wave(s): device "
        f"{dev * s:.4f} ms, per call host included {calls[0] * s:.4f} / "
        f"{calls[1] * s:.4f} ms, plain {plains[0] * s:.4f} / "
        f"{plains[1] * s:.4f} ms, bound {b_ms * s:.4f} ms ({b_by}), device "
        f"at {100 * b_ms / dev:.1f}% of it, per 2^20 candidates")
    del made, blobs
    torch.cuda.empty_cache()
    return dict(device_ms=dev * s, call_ms=[c * s for c in calls],
                plain_ms=[p * s for p in plains], bound_ms=b_ms * s,
                bound_by=b_by)


def watchdog_check(device, ref):
    """Phase 2c: the fetch watchdog on a real CUDA event.  A context over
    ``ref`` (synthetic_reference's), armed as after a measured fetch with
    1e-12 s per candidate and BASAL_TPU_WATCHDOG_MIN=0, gets the gap-3
    timing wave the moment it is launched: the copy of its 207 MB of
    results alone takes milliseconds, far past the 8.4 us timeout, so the
    fetch must raise and count one stall.  Then, the card drained and the
    watchdog off, a second wave on the same context must equal the plain
    version.  Returns (timeout s, s from fetch to the raise)."""
    import types

    import numpy as np
    import torch
    from basal_tpu_torch.align.pipeline import TorchDeviceContext, download
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob

    _, blob, shape = synthetic_wave("oneway", device, ref)
    shape["gap"] = BENCH_GAP
    host = types.SimpleNamespace(
        ref32=ref[0].cpu().numpy().view(np.uint32).reshape(2, -1))
    ctx = TorchDeviceContext(host, AlignParams(conversion="C:T", randseed=1,
                                               gap=BENCH_GAP), device)
    if ctx.mode != shape["mode"] or ctx.nw != shape["nw"]:
        raise AssertionError(f"context {ctx.mode} nw {ctx.nw} for {shape}")
    ctx.meas_t, ctx.meas_n, ctx._meas_skip = 1e-12, 1, 0
    C, U, E = shape["C"], shape["U"], shape["E"]

    def wave():
        out = extend_gap_blob(ctx.ref32, blob, **shape)
        return download(C, U, E, out, time.time(), (blob,))

    knobs = ("BASAL_TPU_WATCHDOG", "BASAL_TPU_WATCHDOG_MIN")
    saved = {k: os.environ.pop(k, None) for k in knobs}
    os.environ["BASAL_TPU_WATCHDOG_MIN"] = "0"
    timeout = ctx.watchdog_timeout(C)
    w = wave()
    t0 = time.perf_counter()
    try:
        ctx.fetch([w])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    t_raise = time.perf_counter() - t0
    torch.cuda.synchronize()
    del w
    if raised is None or "stalled" not in raised or ctx.stalls != 1:
        raise AssertionError(f"the watchdog did not fire: {raised!r}, "
                             f"stalls {ctx.stalls}")
    log(f"watchdog: timeout {timeout:.3g} s, raised after {t_raise:.6f} s, "
        f"stalls {ctx.stalls}: {raised}")
    os.environ["BASAL_TPU_WATCHDOG"] = "0"
    got = ctx.fetch([wave()])
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v
    want = extend_kernel_blob(ctx.ref32, blob, **shape)
    for part, a, b in zip(("counts", "pos0", "pos1"), got, want):
        if not np.array_equal(a, b.cpu().numpy().astype(np.int32)):
            raise AssertionError(f"after a stall, {part} != plain version")
    if ctx.stalls != 1:
        raise AssertionError(f"stalls {ctx.stalls} after the second fetch")
    log(f"watchdog: the same context then fetched a wave of {C} candidates "
        f"equal to the plain version, watchdog off")
    del ctx, blob
    torch.cuda.empty_cache()
    return timeout, t_raise


def device_profile(run):
    """Run ``run()`` under torch.profiler: (wall s, the card's busy time by
    kind (ms): kernels, host-to-device and device-to-host copies, all;
    {port kernel: its launches' durations (ms)}; run()'s result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy = {"kernel": 0.0, "HtoD": 0.0, "DtoH": 0.0, "all": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy["all"] += ms
        kind = ("HtoD" if "HtoD" in e.name else "DtoH" if "DtoH" in e.name
                else "kernel" if "Memcpy" not in e.name
                and "Memset" not in e.name else None)
        if kind:
            busy[kind] += ms
    launched = {k: kernel_events(prof, k)
                for k in ("count_blob_kernel", "gap_blob_kernel")}
    return wall, busy, launched, res


def device_vs_host(label, argv, files, fasta, work, device, n_reads,
                   kernel, min_aligned, profile=False):
    """Phase 3: one of the port's paths (run_single_end, or run_pair_end
    with -b) twice on the same input: device-forced, every launch count
    set to 0 before it and read after, then with the C++ host evaluator.
    The SAM bodies must be byte-identical, and ``kernel``'s launches must
    equal the device waves.  With ``profile``, the device-forced run once
    more under torch.profiler."""
    from basal_tpu_torch.align.pipeline import (TorchDeviceContext,
                                                run_single_end)
    from basal_tpu_torch.cli import params_from_args, parse_args
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    from basal_tpu_torch.pairs.pipeline import run_pair_end

    wrappers = {"count": extend_counts_blob, "gap": extend_gap_blob}
    argv = ["-d", str(fasta), "-a", str(files[0])] + (
        ["-b", str(files[1])] if len(files) > 1 else []) + argv + [
        "-S", "1", "-u", "-V", "0"]
    params = params_from_args(argv, *parse_args(argv))
    pe = params.pairend
    run = run_pair_end if pe else run_single_end

    def drive(out, timings):
        with open(out, "wb") as fh:
            return run(params, str(fasta), *map(str, files), out_fh=fh,
                       command_line="chip_smoke", timings=timings,
                       device=device)

    result = {}
    for mode in ("0", "1"):
        os.environ["BASAL_TPU_HOST_EVAL"] = mode
        timings = {}
        for w in wrappers.values():
            w.launches = 0
        aligner = drive(work / f"{label}_{mode}.sam", timings)
        wall = time.time() - timings["t_align_start"]
        launches = {k: w.launches for k, w in wrappers.items()}
        st = aligner.stage
        if pe:
            n_al = aligner.pair_stats()[0]
            visit = st["cand_enum"] - st["cand_host"] - st["cand_device"]
        else:
            n_al = aligner.stats()[0]
            visit = st["cand_visit"]
        dev = aligner._dev
        stalls = dev.stalls if dev is not None else 0
        log(f"{label} BASAL_TPU_HOST_EVAL={mode}: ref "
            f"{timings['t_ref']:.3f} s, index {timings['t_index']:.3f} s, "
            f"align {wall:.3f} s = {n_reads / wall:.1f} "
            f"{'pairs' if pe else 'reads'}/s; aligned {n_al}/{n_reads}; "
            f"candidates device {st['cand_device']} host {st['cand_host']} "
            f"visit {visit}; launches {launches}; stalls {stalls}; batches "
            + ", ".join(f"{k} {v}" for k, v in st.items()
                        if "batches" in k and v))
        if mode == "0":
            if not isinstance(dev, TorchDeviceContext):
                raise AssertionError("waves did not go through "
                                     "TorchDeviceContext")
            if not (st["cand_device"] > 0 and st["cand_host"] == 0
                    and visit == 0):
                raise AssertionError(f"not every candidate ran on the "
                                     f"device: {st}")
            want = {k: dev.up_waves if k == kernel else 0 for k in wrappers}
            if not dev.up_waves > 0 or launches != want:
                raise AssertionError(f"launches {launches} for "
                                     f"{dev.up_waves} {kernel} waves")
            if n_al < min_aligned * n_reads:
                raise AssertionError(f"only {n_al} of {n_reads} aligned")
            if stalls:
                raise AssertionError(f"{label}: {stalls} fetch stalls")
            result.update(launches=launches[kernel], align_s=wall,
                          rate=n_reads / wall, waves=dev.up_waves,
                          cand=st["cand_device"], up_bytes=dev.up_bytes,
                          down_bytes=dev.down_bytes)
        else:
            if st["cand_device"] != 0:
                raise AssertionError("host-evaluator run used the device")
            result["host_rate"] = n_reads / wall
    if profile:
        os.environ["BASAL_TPU_HOST_EVAL"] = "0"
        name = f"{kernel}_blob_kernel"
        waves = result["waves"]

        def session():
            wall, busy, launched, aligner = device_profile(
                lambda: drive(work / f"{label}_prof.sam", {}))
            if aligner._dev.up_waves != waves or aligner._dev.stalls:
                raise AssertionError(f"{label}: {aligner._dev.up_waves} "
                                     f"waves under the profiler, {waves} "
                                     f"before; {aligner._dev.stalls} "
                                     f"stalls")
            return (wall, busy, aligner), launched[name]

        (wall, busy, aligner), durs = recorded(session, name, waves)
        dev = aligner._dev
        cand = aligner.stage["cand_device"]
        mean = sum(durs) / len(durs)
        # busy over every wave: the recorded launches' mean times the waves,
        # which is their sum when the session recorded all of them
        result.update(prof_wall=wall, busy=busy, kernel_busy=mean * waves,
                      kernel_n=len(durs), kernel_us=1e3 * mean,
                      cand_per_wave=cand / waves, cand_max=dev.up_cand_max)
        log(f"{label} under torch.profiler: run {wall:.3f} s, card busy "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in busy.items())
            + f"; idle share {1 - busy['all'] / 1e3 / wall:.5f}")
        log(f"{label} {name} under torch.profiler: {len(durs)} of {waves} "
            f"launches recorded, busy {mean * waves:.4f} ms over the waves, "
            f"{result['kernel_us']:.2f} us per launch (largest "
            f"{1e3 * max(durs):.2f}); {cand} candidates, "
            f"{result['cand_per_wave']:.1f} per wave, largest wave "
            f"{result['cand_max']}")
    os.environ.pop("BASAL_TPU_HOST_EVAL")

    def body(path):
        with open(path, "rb") as f:
            return [ln for ln in f if not ln.startswith(b"@PG")]

    dev_sam, host_sam = (body(work / f"{label}_{m}.sam") for m in "01")
    n_body = sum(not ln.startswith(b"@") for ln in dev_sam)
    if n_body != n_reads * len(files):
        raise AssertionError(f"{n_body} SAM records for {n_reads} "
                             f"{'pairs' if pe else 'reads'}")
    if dev_sam != host_sam:
        raise AssertionError(f"{label}: device-forced SAM differs from "
                             f"host evaluator")
    log(f"{label}: SAM device-forced == host evaluator, {len(dev_sam)} "
        f"lines; blob {result['up_bytes']} B up, results "
        f"{result['down_bytes']} B down over {result['waves']} waves")
    return result


MESHES = ((1, 4), (2, 2), (4, 1))


def mesh_checks(fasta, g, work, device, n_reads=WAVE_READS):
    """Phase 2b: the sharded context at each of MESHES over [cuda:i % cards]
    against the single context on the same real candidates, count kernel
    (C:T) and gap kernel (T:- -g 3).  Each context runs twice; the second
    run is timed.  Returns {kernel: {"single": ms per wave, "1x4": ...}}."""
    import numpy as np
    import torch
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    from basal_tpu_torch.parallel.mesh import (ShardedTorchDeviceContext,
                                               make_mesh)

    rng = np.random.default_rng(SEED + 5)
    k = torch.cuda.device_count()
    devices = [torch.device("cuda", i % k) for i in range(4)]
    walls = {}
    for kernel, rule, gap in (("count", "C:T", 0), ("gap", "T:-", 3)):
        p = AlignParams(conversion=rule, randseed=1, gap=gap,
                        batch_reads=n_reads)
        fq = work / "mesh_waves.fq"
        write_fastq(fq, gapped_reads(rng, g, n_reads, rule, gap) if gap
                    else mixed_reads(rng, g, n_reads, rule))
        aligner, enc, loc, plane, row = wave_candidates(p, fasta, fq, device)
        counter = extend_gap_blob if gap else extend_counts_blob

        def timed(ctx):
            ctx.extend(enc, loc, plane, row)            # warm-up
            torch.cuda.synchronize()
            w0, l0 = ctx.up_waves, counter.launches
            t0 = time.perf_counter()
            out = ctx.extend(enc, loc, plane, row)
            wall = time.perf_counter() - t0
            return out, ctx.up_waves - w0, counter.launches - l0, wall

        want, n_waves, _, wall = timed(
            TorchDeviceContext(aligner.ref, p, device))
        walls[kernel] = {"single": wall / n_waves * 1e3}
        for n_dp, n_rs in MESHES:
            ctx = ShardedTorchDeviceContext(
                aligner.ref, p, make_mesh(n_dp, n_rs, devices[:n_dp * n_rs]))
            got, waves, launches, wall = timed(ctx)
            name = f"{n_dp}x{n_rs}"
            if launches != waves * n_rs or waves < n_dp:
                raise AssertionError(f"mesh {name} {kernel}: {launches} "
                                     f"launches for {waves} waves x {n_rs}")
            for part, a, b in zip(("counts", "pos0", "pos1"), got, want):
                if a is None and b is None:
                    continue
                if not np.array_equal(a, b):
                    bad = int((a != b).sum())
                    raise AssertionError(f"mesh {name} {kernel}: {part} "
                                         f"differ on {bad} elements")
            walls[kernel][name] = wall / waves * 1e3
            log(f"mesh {name} == single [{kernel} kernel, {rule}"
                f"{f' -g {gap}' if gap else ''}]: {loc.size} candidates, "
                f"{waves} waves, {launches} launches; wall per wave "
                f"{walls[kernel][name]:.3f} ms (single context "
                f"{walls[kernel]['single']:.3f} ms over {n_waves} waves)")
    return walls


def multiprocess_run(fasta, fq, work, single_sam, n_reads=N_READS):
    """Phase 3d: two worker processes (gloo, both on the card) align fq
    device-forced with the routed seed index; the concatenated SAM must be
    phase 3's single-process SAM (single_sam), byte for byte, @PG aside.
    Returns the workers' stats."""
    import socket
    wdir = work / "mh"
    wdir.mkdir()
    cfg = {"params": {"conversion": "A:G", "randseed": 1, "out_unmap": True,
                      "verbose_level": 0},
           "ref": str(fasta), "reads": str(fq), "n_reads": n_reads,
           "backend": "gloo", "device": "cuda", "mesh_check": True,
           "local_devices": 2, "cmdline": "chip_smoke"}
    (wdir / "mh_cfg.json").write_text(json.dumps(cfg))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BASAL_TPU_HOST_EVAL": "0"}
    log(f"multi-process: 2 workers, backend gloo (two ranks share the one "
        f"card; NCCL needs a card per rank), device cuda")
    t0 = time.perf_counter()
    logs = [(wdir / f"worker{pid}.out", wdir / f"worker{pid}.err")
            for pid in range(2)]
    procs = []
    for pid, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "basal_tpu_torch.parallel.worker",
                 str(pid), "2", str(port), str(wdir)], cwd=ROOT, env=env,
                stdout=fo, stderr=fe))
    deadline = time.monotonic() + 600
    try:
        # a worker that dies leaves the other blocked in a collective:
        # stop both as soon as one fails
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(
            f"workers rc={[p.returncode for p in procs]} after {wall:.1f} s\n"
            + "\n".join(f"--- worker {pid} {f.name}:\n"
                        f"{f.read_text()[-2500:]}"
                        for pid, pair in enumerate(logs) for f in pair))
    stats = [json.loads((wdir / f"stats_p{i}.json").read_text())
             for i in range(2)]

    def body(data):
        return [ln for ln in data.splitlines(keepends=True)
                if not ln.startswith(b"@PG")]

    merged = b"".join((wdir / f"out_p{i}.sam").read_bytes() for i in range(2))
    if body(merged) != body(single_sam.read_bytes()):
        raise AssertionError("2-process SAM differs from the single-process "
                             "device-forced SAM")
    for st in stats:
        m = st["mesh"]
        if not (st["launches"]["count"] > 0 and st["exchanged_queries"] > 0
                and st["exchanged_locs"] > 0 and st["stalls"] == 0 and m["ok"]
                and m["launches"] == m["waves"] > 0):
            raise AssertionError(f"worker {st['pid']}: {st}")
    t_align = max(st["t_align"] for st in stats)
    n_lines = merged.count(b"\n")
    log(f"multi-process: SAM of 2 processes == single process, {n_lines} "
        f"lines; {n_reads / t_align:.1f} reads/s (slowest align "
        f"{t_align:.3f} s; phase wall {wall:.3f} s)")
    for st in stats:
        m = st["mesh"]
        log(f"  p{st['pid']} on {st['device']}: {st['reads']} reads, card "
            f"context and kernel load {st['t_device_init']:.3f} s, ref "
            f"{st['t_ref']:.3f} s, index shard {st['t_index']:.3f} s, align "
            f"{st['t_align']:.3f} s; routing {st['routing_rounds']} rounds, "
            f"t_exchange {st['t_exchange']:.3f} s, t_wait "
            f"{st['t_wait']:.3f} s, {st['exchanged_queries']} queries, "
            f"{st['exchanged_locs']} locs; launches {st['launches']} over "
            f"{st.get('device_waves', 0)} waves, stalls {st['stalls']}; mesh "
            f"check "
            f"{m['candidates']} candidates, {m['waves']} waves, "
            f"{m['t_mesh_extend']:.3f} s")
    return {"rate": n_reads / t_align, "wall": wall, "stats": stats}


def dryrun():
    """Phase 3e: dryrun_multichip(4) over [cuda:i % cards]; the kernels must
    launch in it."""
    from basal_tpu_torch.entry import dryrun_multichip
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    for w in (extend_counts_blob, extend_gap_blob):
        w.launches = 0
    report = dryrun_multichip(4)
    launches = (extend_counts_blob.launches, extend_gap_blob.launches)
    if min(launches) == 0:
        raise AssertionError(f"dryrun_multichip launched {launches}")
    if any(report[k]["stalls"] for k in ("counts", "gap")):
        raise AssertionError(f"dryrun_multichip stalled: {report}")
    log(f"dryrun_multichip(4): ok {report}; launches count/gap {launches}")


def sam_body(data: bytes):
    """SAM lines without @PG (its command line differs between runs)."""
    return [ln for ln in data.splitlines(keepends=True)
            if not ln.startswith(b"@PG")]


def threaded_run(fasta, fq, single_sam, work, device, n_reads=N_READS,
                 n_workers=4):
    """Phase 3g, -p 4: run_single_end with four worker aligners, every
    wave forced onto the card; launches must equal the waves summed over
    the four aligners' contexts, and the SAM must be phase 3's -p 1
    device-forced SAM (single_sam), @PG aside."""
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.cli import params_from_args, parse_args
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    argv = ["-d", str(fasta), "-a", str(fq), "-M", "A:G", "-p",
            str(n_workers), "-S", "1", "-u", "-V", "0"]
    params = params_from_args(argv, *parse_args(argv))
    os.environ["BASAL_TPU_HOST_EVAL"] = "0"
    for w in (extend_counts_blob, extend_gap_blob):
        w.launches = 0
    timings = {}
    out = work / f"se A:G p{n_workers}.sam"
    with open(out, "wb") as fh:
        first = run_single_end(params, str(fasta), str(fq), out_fh=fh,
                               command_line="chip_smoke", timings=timings,
                               device=device)
    wall = time.time() - timings["t_align_start"]
    launches = (extend_counts_blob.launches, extend_gap_blob.launches)
    os.environ.pop("BASAL_TPU_HOST_EVAL")
    peers = first.peers
    devs = [a._dev for a in peers if a._dev is not None]
    waves = sum(d.up_waves for d in devs)
    stalls = sum(d.stalls for d in devs)
    host = sum(a.stage["cand_host"] + a.stage["cand_visit"] for a in peers)
    log(f"se A:G -p {n_workers}: align {wall:.3f} s = "
        f"{n_reads / wall:.1f} reads/s; {len(devs)} of {len(peers)} "
        f"aligners used the card; waves {waves}, launches count/gap "
        f"{launches}, stalls {stalls}, host candidates {host}")
    if len(peers) != n_workers or not waves or launches != (waves, 0) \
            or stalls or host:
        raise AssertionError(f"-p {n_workers}: {len(peers)} aligners, "
                             f"{waves} waves, launches {launches}, stalls "
                             f"{stalls}, host candidates {host}")
    if sam_body(out.read_bytes()) != sam_body(single_sam.read_bytes()):
        raise AssertionError(f"-p {n_workers} SAM differs from -p 1")
    log(f"se A:G -p {n_workers}: SAM == -p 1 device-forced SAM")
    return {"rate": n_reads / wall, "waves": waves, "launches": launches[0]}


def toolkit_steps(label, steps, work):
    """Run each (name, main, argv) toolkit step in this process, its
    stderr to ``work/toolkit.log``; returns {name: wall s}."""
    import contextlib
    times = {}
    with open(work / "toolkit.log", "a") as err, \
            contextlib.redirect_stderr(err):
        for name, fn, argv in steps:
            t0 = time.perf_counter()
            rc = fn([str(a) for a in argv])
            times[name] = time.perf_counter() - t0
            if rc not in (0, None):
                raise AssertionError(f"{label} {name}: exit {rc}")
    log(f"{label} toolkit steps: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    return times


def avgmod_rows(path):
    """(rows, sum N_mod, sum N_total) of an _AvgMod.tsv."""
    lines = Path(path).read_text().splitlines()
    if not lines or not lines[0].startswith("chr\tpos"):
        raise AssertionError(f"{path}: no AvgMod header")
    cols = [ln.split("\t") for ln in lines[1:]]
    return (len(cols), sum(int(c[6]) for c in cols),
            sum(int(c[7]) for c in cols))


def glori_recipe(fasta, sam, work):
    """Phase 3f, GLORI/eTAM: the toolkit half of
    examples/pipeline-eTAM-GLORI.sh on phase 3's device-forced SAM (no
    transcriptome, so no mergeBAM).  bench_reads turned each A of the
    forward strand into G with p = 0.5, so the unconverted share of the
    covered A sites, sum(N_mod) / sum(N_total), lies near 0.5 whichever
    strand avgmod -T RNA reads them on."""
    from basal_tpu_torch.toolkit import bamutil
    from basal_tpu_torch.toolkit import cli as kit
    d = work / "glori"
    d.mkdir()
    times = toolkit_steps("glori", [
        ("view SAM to BAM", bamutil.main,
         ["view", sam, "-o", d / "smp.map2genome.bam"]),
        ("view -F 0xE04", bamutil.main,
         ["view", d / "smp.map2genome.bam", "-F", "0xE04",
          "-o", d / "smp.genomeAlign.unsorted.bam"]),
        ("sort", bamutil.main, ["sort", d / "smp.genomeAlign.unsorted.bam",
                                "-o", d / "smp.genomeAlign.bam"]),
        ("index", bamutil.main, ["index", d / "smp.genomeAlign.bam"]),
        ("avgmod", kit.main, ["avgmod", d / "smp.genomeAlign.bam", fasta,
                              "-o", d / "smp", "-M", "A:G", "-T", "RNA"]),
    ], work)
    n_rows, n_mod, n_total = avgmod_rows(d / "smp_AvgMod.tsv")
    ratio = n_mod / max(n_total, 1)
    log(f"glori: {n_rows} sites in smp_AvgMod.tsv, sum(N_mod) / "
        f"sum(N_total) = {n_mod} / {n_total} = {ratio:.6f}")
    if not n_rows or not 0.40 <= ratio <= 0.60:
        raise AssertionError(f"glori: {n_rows} sites, ratio {ratio}")
    return {"times": times, "rows": n_rows, "ratio": ratio}


def bidseq_recipe(fasta, fq_bid, work, device, n_reads=N_SMALL):
    """Phase 3f, BID-seq: the first n_reads of phase 3b's reads aligned by
    the port's CLI to BAM as examples/pipeline-BID-seq.sh aligns them,
    device-forced (gap kernel, one launch per wave) and with the host
    evaluator: the decoded BAMs must be equal, @PG aside.  Then the
    recipe's toolkit steps on the genome BAM (no transcriptome, so no
    mergeBAM), with avgmod at -m 1: 50k reads cover the 50 Mbp at 0.1x.
    bidseq_reads dropped each T with p = 0.04, so under -D M some covered
    T sites must count as modified (deletions)."""
    from basal_tpu_torch import cli
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    from basal_tpu_torch.toolkit import bamutil
    from basal_tpu_torch.toolkit import cli as kit
    from basal_tpu_torch.toolkit.bamio import decode_bam_to_sam
    d = work / "bid"
    d.mkdir()
    with open(fq_bid, "rb") as f:
        head = b"".join(f.readline() for _ in range(4 * n_reads))
    (d / "reads.fq").write_bytes(head)
    argv = ["-a", str(d / "reads.fq"), "-d", str(fasta), "-M", "T:-", "-n",
            "1", "-g", "3", "-R", "-u", "-S", "1", "-V", "0"]
    walls, dev_launches = {}, None
    for mode in ("0", "1"):
        os.environ["BASAL_TPU_HOST_EVAL"] = mode
        for w in (extend_counts_blob, extend_gap_blob):
            w.launches = 0
        t0 = time.perf_counter()
        aligner = cli.main(argv + ["-o", str(d / f"bid_{mode}.bam")])
        walls[mode] = time.perf_counter() - t0
        launches = (extend_counts_blob.launches, extend_gap_blob.launches)
        st, dev = aligner.stage, aligner._dev
        waves = dev.up_waves if dev is not None else 0
        stalls = dev.stalls if dev is not None else 0
        log(f"bid CLI BASAL_TPU_HOST_EVAL={mode}: {walls[mode]:.3f} s "
            f"(reference, index and align) = {n_reads / walls[mode]:.1f} "
            f"reads/s; candidates device {st['cand_device']} host "
            f"{st['cand_host']} visit {st['cand_visit']}; waves {waves}, "
            f"launches count/gap {launches}, stalls {stalls}")
        if mode == "0" and not (waves and launches == (0, waves)
                                and st["cand_host"] == 0
                                and st["cand_visit"] == 0 and not stalls):
            raise AssertionError(f"bid CLI device-forced: {st}")
        if mode == "0":
            dev_launches = launches[1]
        if mode == "1" and (st["cand_device"] or any(launches)):
            raise AssertionError("bid CLI host-evaluator run used the card")
    os.environ.pop("BASAL_TPU_HOST_EVAL")
    bams = [decode_bam_to_sam(str(d / f"bid_{m}.bam")).encode("latin1")
            for m in "01"]
    body = sam_body(bams[0])
    n_body = sum(not ln.startswith(b"@") for ln in body)
    same = body == sam_body(bams[1])
    if n_body != n_reads or not same:
        raise AssertionError(f"bid: {n_body} records; device-forced BAM "
                             f"== host evaluator's: {same}")
    log(f"bid: BAM device-forced == host evaluator, {n_body} records")
    times = toolkit_steps("bid", [
        ("view -F 0xE04", bamutil.main,
         ["view", d / "bid_0.bam", "-F", "0xE04", "-o", d / "smp.tmp.bam"]),
        ("sort", bamutil.main, ["sort", d / "smp.tmp.bam",
                                "-o", d / "smp.genomeAlign.bam"]),
        ("shiftD", kit.main, ["shiftD", d / "smp.genomeAlign.bam",
                              "-o", d / "smp.gshift"]),
        ("sort shifted", bamutil.main,
         ["sort", d / "smp.gshift.bam",
          "-o", d / "smp.genomeAlign.corrected.bam"]),
        ("avgmod", kit.main, ["avgmod", d / "smp.genomeAlign.corrected.bam",
                              fasta, "-o", d / "smp", "-M", "T:-", "-D", "M",
                              "-T", "RNA", "-y", "7", "-m", "1"]),
    ], work)
    n_rows, n_mod, n_total = avgmod_rows(d / "smp_AvgMod.tsv")
    log(f"bid: {n_rows} sites in smp_AvgMod.tsv, sum(N_mod) / sum(N_total) "
        f"= {n_mod} / {n_total}")
    if not (n_rows and n_mod):
        raise AssertionError(f"bid: avgmod wrote {n_rows} sites, {n_mod} "
                             f"modified")
    return {"times": times, "rows": n_rows, "cli_s": walls,
            "launches": dev_launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "basal_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # phase 0: setup
    smi = nvidia_smi_line()
    device = torch.device("cuda")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    try:
        import pandas
        log(f"pandas {pandas.__version__} imports (the toolkit's fdr and "
            f"regmod need it; neither runs here)")
    except ImportError as e:
        log(f"pandas does not import ({e}): the toolkit's fdr and regmod "
            f"would fail here; neither runs here")

    # phase 1: build the kernels and the host engine side by side
    from concurrent.futures import ThreadPoolExecutor

    from basal_tpu_torch import native
    from basal_tpu_torch.ops import _build

    def timed(load):
        t0 = time.perf_counter()
        lib = load()
        return lib, time.perf_counter() - t0

    libs = {"kernel library": (_build.library_path(), _build.load),
            "host engine": (native.library_path(), native.get_lib)}
    built = {k: not so.exists() for k, (so, _) in libs.items()}
    with ThreadPoolExecutor(2) as pool:
        futs = {k: pool.submit(timed, load) for k, (_, load) in libs.items()}
        for k, fut in futs.items():
            lib, secs = fut.result()
            if lib is None:
                raise AssertionError(f"the {k} did not build")
            log(f"{k} {libs[k][0].relative_to(ROOT)} "
                f"{'built' if built[k] else 'loaded'} in {secs:.3f} s")
    resources = kernel_resources(_build.resource_report())
    for name, r in sorted(resources.items()):
        log(f"ptxas {name}: {r}")
    local_memory_gate(resources)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=ROOT / "build") as tmp:
        work = Path(tmp)
        rng = np.random.default_rng(SEED)
        g = rng.choice(np.frombuffer(NT, np.uint8), size=GENOME)
        fasta = work / "ref.fa"
        write_fasta(fasta, g)
        fq = work / "reads.fq"
        write_fastq(fq, bench_reads(rng, g, N_READS))
        fq_bid = work / "bidseq.fq"
        write_fastq(fq_bid, bidseq_reads(rng, g, N_READS))
        fq_multi = work / "multiway.fq"
        write_fastq(fq_multi, mixed_reads(rng, g, N_SMALL, "A:CGT"))
        fq_nt3 = work / "nt3.fq"
        write_fastq(fq_nt3, mixed_reads(rng, g, N_SMALL, "C:T"))
        pairs = {}
        for gap in (0, 2):
            pairs[gap] = (work / f"r1_g{gap}.fq", work / f"r2_g{gap}.fq")
            write_pairs(*pairs[gap], *pe_reads(rng, g, N_PAIRS, gap=gap))

        # phase 2: kernels against their plain versions
        worst = kernel_checks(fasta, g, work, device)
        worst_gap = gap_kernel_checks(fasta, g, work, device)
        ref = synthetic_reference(device)
        times = count_timing(device, ref, "50 Mbp")
        gap_times = gap_kernel_timing(device, ref, "50 Mbp")
        watchdog = watchdog_check(device, ref)
        del ref
        ref = synthetic_reference(device, GENOME_OUT_OF_L2)
        times_out = count_timing(device, ref, "2 Gbp",
                                 waves=WAVES_OUT_OF_L2, iters=25,
                                 plain_iters=2)
        gap_out = gap_kernel_timing(device, ref, "2 Gbp",
                                    waves=WAVES_OUT_OF_L2, iters=10,
                                    plain_iters=1)
        del ref
        torch.cuda.empty_cache()
        mesh_walls = mesh_checks(fasta, g, work, device)

        # phase 3: the paths, device-forced against the host evaluator
        main = device_vs_host("se A:G", ["-M", "A:G"], (fq,), fasta, work,
                              device, N_READS, "count", 0.9, profile=True)
        bid = device_vs_host("se T:- -g 3", ["-M", "T:-", "-g", "3"],
                             (fq_bid,), fasta, work, device, N_READS, "gap",
                             0.5, profile=True)
        pe = device_vs_host("pe C:T", ["-M", "C:T"], pairs[0], fasta, work,
                            device, N_PAIRS, "count", 0.5)
        pe_gap = device_vs_host("pe C:T -g 2", ["-M", "C:T", "-g", "2"],
                                pairs[2], fasta, work, device, N_PAIRS,
                                "gap", 0.5)
        multi = multiprocess_run(fasta, fq, work, work / "se A:G_0.sam")
        dryrun()
        glori = glori_recipe(fasta, work / "se A:G_0.sam", work)
        bid_kit = bidseq_recipe(fasta, fq_bid, work, device)
        multiway = device_vs_host("se A:CGT", ["-M", "A:CGT"], (fq_multi,),
                                  fasta, work, device, N_SMALL, "count", 0.3)
        nt3 = device_vs_host("se C:T -3", ["-M", "C:T", "-3"], (fq_nt3,),
                             fasta, work, device, N_SMALL, "count", 0.3)
        threaded = threaded_run(fasta, fq, work / "se A:G_0.sam", work,
                                device)

    # phase 4: neither jax nor the JAX package
    for name in ("jax", "basal_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")

    for label, r, n, unit in (("se A:G", main, N_READS, "reads"),
                              ("se T:- -g 3", bid, N_READS, "reads"),
                              ("pe C:T", pe, N_PAIRS, "pairs"),
                              ("pe C:T -g 2", pe_gap, N_PAIRS, "pairs"),
                              ("se A:CGT", multiway, N_SMALL, "reads"),
                              ("se C:T -3", nt3, N_SMALL, "reads")):
        log(f"{label}: {r['rate']:.1f} {unit}/s device-forced, "
            f"{r['host_rate']:.1f} with the host evaluator, over {n} {unit} "
            f"({r['waves']} waves, {r['cand']} candidates, {r['up_bytes']} "
            f"blob bytes up, {r['down_bytes']} result bytes down) on {smi}")
    log(f"se A:G over 2 processes (gloo, routed index): "
        f"{multi['rate']:.1f} reads/s against {main['rate']:.1f} in one "
        f"process; routing t_exchange "
        + " / ".join(f"{st['t_exchange']:.3f}" for st in multi["stats"])
        + " s, t_wait "
        + " / ".join(f"{st['t_wait']:.3f}" for st in multi["stats"])
        + f" s on {smi}")
    log(f"se A:G -p 4: {threaded['rate']:.1f} reads/s device-forced "
        f"against {main['rate']:.1f} at -p 1 ({threaded['waves']} waves) "
        f"on {smi}")
    for label, r in (("glori", glori), ("bid", bid_kit)):
        log(f"{label} toolkit steps on the card machine's host: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in r["times"].items())
            + f"; {r['rows']} sites on {smi}")
    log(f"bid CLI to BAM over {N_SMALL} reads: device-forced "
        f"{bid_kit['cli_s']['0']:.3f} s, host evaluator "
        f"{bid_kit['cli_s']['1']:.3f} s (reference and index included); "
        f"watchdog timeout {watchdog[0]:.3g} s, raised after "
        f"{watchdog[1]:.6f} s on {smi}")
    for kernel, w in mesh_walls.items():
        log(f"mesh wall per wave [{kernel} kernel]: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in w.items())
            + f" on {smi}")
    for label, r in (("se A:G", main), ("se T:- -g 3", bid)):
        log(f"{label} card kernel busy {r['kernel_busy']:.4f} ms over "
            f"{r['kernel_n']} recorded launches of {r['waves']}, "
            f"{r['kernel_us']:.2f} us per launch, "
            f"{r['cand_per_wave']:.1f} candidates per wave (largest "
            f"{r['cand_max']}); idle share "
            f"{1 - r['busy']['all'] / 1e3 / r['prof_wall']:.5f} on {smi}")
    for mode in times:
        for label, t in (("50 Mbp", times[mode]), ("2 Gbp", times_out[mode])):
            log(f"count kernel [{mode}, {label}]: device {t['device_ms']:.4f} "
                f"ms, per call host included "
                + " / ".join(f"{c:.4f}" for c in t["call_ms"])
                + f" ms, bound {t['bound_ms']:.4f} ms per 2^20 on {smi}")
    for label, t in (("50 Mbp", gap_times), ("2 Gbp", gap_out)):
        log(f"gap kernel [gap {BENCH_GAP} oneway, {label}]: device "
            f"{t['device_ms']:.4f} ms, per call host included "
            + " / ".join(f"{c:.4f}" for c in t["call_ms"])
            + f" ms, bound {t['bound_ms']:.4f} ms per 2^20 on {smi}")
    one, one_out = times["oneway"], times_out["oneway"]
    kernels = [{
        "name": "count_blob_kernel", "route": "cuda",
        "source": "basal_tpu_torch/csrc/count_kernel.cu",
        "replaces": "basal_tpu/ops/extend_pallas.py:35",
        "launches": main["launches"], "max_abs_err": worst,
        "ms": one["device_ms"], "plain_ms": sum(one["plain_ms"]) / 2,
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "library_ms": None, "device_ms": one["device_ms"],
        "call_ms": sum(one["call_ms"]) / 2,
        "ms_out_of_l2": one_out["device_ms"],
        "bound_ms_out_of_l2": one_out["bound_ms"]}, {
        "name": "gap_blob_kernel", "route": "cuda",
        "source": "basal_tpu_torch/csrc/gap_kernel.cu",
        "replaces": "basal_tpu/ops/extend_pallas.py:137",
        "launches": bid["launches"], "max_abs_err": worst_gap,
        "ms": gap_times["device_ms"],
        "plain_ms": sum(gap_times["plain_ms"]) / 2,
        "bound_ms": gap_times["bound_ms"], "bound_by": gap_times["bound_by"],
        "library_ms": None, "device_ms": gap_times["device_ms"],
        "call_ms": sum(gap_times["call_ms"]) / 2,
        "ms_out_of_l2": gap_out["device_ms"],
        "bound_ms_out_of_l2": gap_out["bound_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
