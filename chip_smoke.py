#!/usr/bin/env python3
"""Run the PyTorch port's single-end main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. setup: a CUDA card must be present; prints its nvidia-smi name and
     power limit and the torch / CUDA versions;
  1. build: nvcc builds the CUDA kernels from basal_tpu_torch/csrc;
  2. kernel vs plain version on the card: real waves of encoded reads
     (64-150 bp, some with Ns) under C:T, A:CGT, C:T -3 and A:G -N must
     equal the plain PyTorch version exactly; then both are timed at
     C = 2^20 candidates, W = 7 words (100 bp), U = 8192 rows;
  3. main path: 200k 100 bp A:G reads against a 50 Mbp random reference
     through basal_tpu_torch's run_single_end with every wave forced onto
     the card (BASAL_TPU_HOST_EVAL=0); the SAM must be byte-identical to
     the run that evaluates every candidate with the C++ host evaluator;
  4. jax must never have been imported.

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
N_READS = 200_000        # 4 batches of BATCH_NUM = 50k
READLEN = 100
N_FRAC = 0.02            # reads given one N (exception rows in the blob)
WAVE_READS = 20_000      # reads per phase-2 configuration
PHASE2 = [("C:T", False, False), ("A:CGT", False, False),
          ("C:T", True, False), ("A:G", False, True)]
BENCH_C, BENCH_W, BENCH_U = 1 << 20, 7, 8192
NT = b"ACGT"


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


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
    return [r[:ln].tobytes() for r, ln in zip(reads, lens)]


def kernel_checks(fasta, g, work, device, n_reads=WAVE_READS):
    """Phase 2a: every wave of a real batch, kernel == plain version.
    Returns the largest absolute difference (0 when all are equal)."""
    import numpy as np
    import torch
    from basal_tpu.config import AlignParams
    from basal_tpu.index.reference import load_reference
    from basal_tpu.index.seedindex import build_index
    from basal_tpu.reads.encode import encode_batch
    from basal_tpu.reads.io import open_reads
    from basal_tpu_torch.align.pipeline import (TorchSingleEndAligner,
                                                blob_to_device)
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
        ref = load_reference(str(fasta), p)
        index = build_index(ref, p)
        aligner = TorchSingleEndAligner(p, ref, index, device=device)
        reader = open_reads(str(fq), p, readset=0)
        enc = encode_batch(p, reader.next_batch())
        reader.close()
        nb = aligner.native
        groups, _goff, _total = nb.build_groups(enc, enc.reads.indices)
        off = np.full(groups.shape[0], -1, np.int64)
        loc, plane, row = nb.fill_groups(enc, groups,
                                         np.arange(groups.shape[0]), off)
        ctx = aligner.dev
        n_waves = n_cand = n_exc = n_zero = 0
        for blob, C, U, E in ctx.wave_blobs(enc, loc, plane.astype(np.int32),
                                            row):
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


def synthetic_wave(mode, device, C=BENCH_C, W=BENCH_W, U=BENCH_U,
                   genome=GENOME):
    """A wave at the timing shape: random reference words, candidates
    spread over both planes, U equal rows of 100 bp reads without Ns."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 2)
    nw = genome // 16 + 4
    ref32 = rng.integers(0, 1 << 32, 2 * nw, dtype=np.uint32).view(np.int32)
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
    return (torch.from_numpy(ref32).to(device),
            torch.from_numpy(blob).to(device),
            dict(mode=mode, W=W, nw=nw, C=C, U=U, E=1))


def time_ms(fn, iters):
    """Mean ms per call on the card (CUDA events, after one warm-up)."""
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


def kernel_timing(device):
    """Phase 2b: kernel and plain version at the timing shape, in turns
    (plain, kernel, kernel, plain); ms per 2^20 candidates per mode."""
    import torch
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    out = {}
    for mode in ("oneway", "multiway", "nt3"):
        ref32, blob, shape = synthetic_wave(mode, device)
        got = extend_counts_blob(ref32, blob, **shape)
        want = extend_kernel_blob(ref32, blob, **shape)
        if not torch.equal(got, want):
            raise AssertionError(f"{mode}: kernel != plain at timing shape")
        kern = lambda: extend_counts_blob(ref32, blob, **shape)
        plain = lambda: extend_kernel_blob(ref32, blob, **shape)
        p1 = time_ms(plain, 5)
        k1 = time_ms(kern, 50)
        k2 = time_ms(kern, 50)
        p2 = time_ms(plain, 5)
        scale = (1 << 20) / shape["C"]
        out[mode] = ((k1 + k2) / 2 * scale, (p1 + p2) / 2 * scale)
        log(f"timing [{mode}] C={shape['C']} W={shape['W']} U={shape['U']}: "
            f"kernel {k1 * scale:.4f} / {k2 * scale:.4f} ms, plain "
            f"{p1 * scale:.4f} / {p2 * scale:.4f} ms per 2^20 candidates")
        del ref32, blob
        torch.cuda.empty_cache()
    return out


def main_path(fasta, fq, work, device, n_reads):
    """Phase 3: the port's run_single_end, device-forced, then the host
    evaluator on the same input; SAM bodies must be byte-identical."""
    from basal_tpu.cli import parse_args
    from basal_tpu_torch.align.pipeline import (TorchDeviceContext,
                                                run_single_end)
    from basal_tpu_torch.cli import params_from_args
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob

    argv = ["-a", str(fq), "-d", str(fasta), "-M", "A:G", "-S", "1", "-u",
            "-V", "0"]
    result = {}
    for mode in ("0", "1"):
        os.environ["BASAL_TPU_HOST_EVAL"] = mode
        params = params_from_args(argv, *parse_args(argv))
        out = work / f"host_eval_{mode}.sam"
        timings = {}
        extend_counts_blob.launches = 0
        with open(out, "wb") as fh:
            aligner = run_single_end(params, str(fasta), str(fq), out_fh=fh,
                                     command_line="chip_smoke",
                                     timings=timings, device=device)
        wall = time.time() - timings["t_align_start"]
        launches = extend_counts_blob.launches
        st = aligner.stage
        n_al, _, _ = aligner.stats()
        log(f"run_single_end BASAL_TPU_HOST_EVAL={mode}: ref "
            f"{timings['t_ref']:.3f} s, index {timings['t_index']:.3f} s, "
            f"align {wall:.3f} s = {n_reads / wall:.1f} reads/s; "
            f"aligned {n_al}/{n_reads}; candidates device "
            f"{st['cand_device']} host {st['cand_host']} visit "
            f"{st['cand_visit']}; kernel launches {launches}")
        if mode == "0":
            dev = aligner._dev
            if not isinstance(dev, TorchDeviceContext):
                raise AssertionError("waves did not go through "
                                     "TorchDeviceContext")
            if not (st["cand_device"] > 0 and st["cand_host"] == 0
                    and st["cand_visit"] == 0):
                raise AssertionError(f"not every candidate ran on the "
                                     f"device: {st}")
            if device.type == "cuda" and not 0 < launches == dev.up_waves:
                raise AssertionError(f"{launches} kernel launches for "
                                     f"{dev.up_waves} waves")
            if n_al < 0.9 * n_reads:
                raise AssertionError(f"only {n_al} of {n_reads} aligned")
            result.update(launches=launches, align_s=wall,
                          reads_per_s=n_reads / wall,
                          waves=dev.up_waves, cand=st["cand_device"],
                          up_bytes=dev.up_bytes)
        elif st["cand_device"] != 0:
            raise AssertionError("host-evaluator run used the device")
    os.environ.pop("BASAL_TPU_HOST_EVAL")

    def body(path):
        with open(path, "rb") as f:
            return [ln for ln in f if not ln.startswith(b"@PG")]

    dev_sam, host_sam = body(work / "host_eval_0.sam"), body(
        work / "host_eval_1.sam")
    n_body = sum(not ln.startswith(b"@") for ln in dev_sam)
    if n_body != n_reads:
        raise AssertionError(f"{n_body} SAM records for {n_reads} reads")
    if dev_sam != host_sam:
        raise AssertionError("device-forced SAM differs from host evaluator")
    log(f"SAM device-forced == host evaluator: {len(dev_sam)} lines compared")
    return result


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

    # phase 1: build
    from basal_tpu_torch.ops import _build
    so = _build.library_path()
    built = not so.exists()
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel library {so.relative_to(ROOT)} "
        f"{'built' if built else 'loaded'} in "
        f"{time.perf_counter() - t0:.3f} s")

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

        # phase 2: kernel against the plain version
        worst = kernel_checks(fasta, g, work, device)
        times = kernel_timing(device)

        # phase 3: main path
        main = main_path(fasta, fq, work, device, N_READS)

    # phase 4: no jax
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    log(f"main path: {main['reads_per_s']:.1f} reads/s over {N_READS} reads "
        f"({main['waves']} waves, {main['cand']} candidates, "
        f"{main['up_bytes']} blob bytes) on {smi}")
    kernels = [{
        "name": "count_blob_kernel", "route": "cuda",
        "source": "basal_tpu_torch/csrc/count_kernel.cu",
        "replaces": "basal_tpu/ops/extend_pallas.py:35",
        "launches": main["launches"], "max_abs_err": worst,
        "ms": times["oneway"][0], "plain_ms": times["oneway"][1]}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
