"""Paired-end alignment pipeline on a PyTorch device.

PyTorch counterpart of ``basal_tpu.pairs.pipeline``.  The lockstep pairing,
replay and PE SAM formatter are the port's copies of basal_tpu's
(``pairs.aligner``, ``native``); this module owns what touches the device.
Both mates' candidate waves go through one ``TorchDeviceContext`` (the
count kernel, or with ``-g`` the gap kernel), on the device named as for
single-end (``align.pipeline.resolve_device``).

Two methods of basal_tpu's PairEndAligner, which ``pairs.aligner`` leaves
out, are re-hosted here line for line with the port's placement policy,
which decides on the torch device.
Several visible cards give the sharded context (``parallel.mesh``), and
``run_pair_end``'s ``index_factory`` takes the routed index of a
multi-process run (``parallel.multihost``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

from .. import malloc_window
from ..align.aligner import _maybe_start_thp
from ..align.pipeline import (TorchDeviceContext, device_context,
                              host_eval_policy, resolve_device)
from ..align.sam import sam_header
from ..config import AlignParams
from ..index.reference import load_reference
from ..index.device_build import build_index_on
from ..reads.encode import encode_batch
from ..reads.io import RawBatch, open_reads
from .aligner import PairEndAligner, PairThreadedRunner, _pe_stage_report


class TorchPairEndAligner(PairEndAligner):
    """PairEndAligner whose device is a torch device: ``dev`` builds the
    port's device context (``align.pipeline.device_context``), and the
    placement decisions of ``align_batch`` and ``_align_batch_native`` key
    on ``self.device``."""

    def __init__(self, params: AlignParams, ref, index, use_native=None,
                 device=None):
        self.device = resolve_device(device)
        super().__init__(params, ref, index, use_native)

    @property
    def dev(self) -> TorchDeviceContext:
        """Device context, created on first device dispatch."""
        if self._dev is None:
            self._dev = device_context(self.ref, self.p, self.device)
        return self._dev

    def align_batch(self, reads_a, reads_b) -> bytes:
        """basal_tpu's PairEndAligner.align_batch (candidate-volume guard
        with state restoration), placement by the port's policy."""
        p = self.p
        self.total_reads += len(reads_a)
        _maybe_start_thp(self)
        if (len(reads_a) > 512 and self.native_a is not None
                and not p.rrbs_flag):
            raw = isinstance(reads_a, RawBatch)
            ridx = (reads_a.indices if raw else
                    np.array([r.index for r in reads_a], dtype=np.uint32))
            orig = None if raw else [(r.seq, r.qual) for r in reads_a]
            state0 = self.native_a.state.copy()
            sst0 = self.native_a.seed_state.copy()
            rst0 = self.native_a.reg_state.copy()
            enc_a = encode_batch(p, reads_a)
            ens = getattr(self.index, "ensure_batch", None)
            if ens is not None:  # routed index: fetch mate a's k-mers first
                ens(enc_a, extra=self._stale_seeds(self.native_a,
                                                   self.sched_a))
            groups, goff, total = self.native_a.build_groups(enc_a, ridx)
            if (total and host_eval_policy(self.device, total)) \
                    or total <= self.MAX_BATCH_CANDS:
                return self._align_batch_inner(
                    reads_a, reads_b, pre_a=(enc_a, groups, goff, total))
            self.stage["batches_split"] += 1
            self.native_a.state[:] = state0
            self.native_a.seed_state[:] = sst0
            self.native_a.reg_state[:] = rst0
            if orig is not None:
                for r, (s, q) in zip(reads_a, orig):
                    r.seq, r.qual = s, q
            n_split = -(-int(total) // self.MAX_BATCH_CANDS)
            step = max(256, len(reads_a) // n_split)
            out = []
            for i in range(0, len(reads_a), step):
                out.append(self._align_batch_inner(
                    reads_a[i:i + step], reads_b[i:i + step]))
            return b"".join(out)
        return self._align_batch_inner(reads_a, reads_b)

    def _align_batch_native(self, enc_a, enc_b, built_a=None) -> bytes:
        """basal_tpu's PairEndAligner._align_batch_native (lazy lockstep or
        bulk waves of both mates), placement by the port's policy."""
        from ..native import (host_eval_candidates,
                              host_eval_candidates_gap, replay_pe)
        p = self.p
        B = len(enc_a.reads)
        if p.rrbs_flag:
            waves = self._pe_rrbs_native(enc_a, enc_b)
            return self._emit_pe_waves(enc_a, enc_b, waves)
        built = []
        total_all = 0
        for enc, nat in ((enc_a, self.native_a), (enc_b, self.native_b)):
            if enc is enc_a and built_a is not None:
                groups, goff, total = built_a
            else:
                ridx = (enc.reads.indices
                        if isinstance(enc.reads, RawBatch)
                        else np.array([r.index for r in enc.reads],
                                      dtype=np.uint32))
                groups, goff, total = nat.build_groups(enc, ridx)
            built.append((enc, nat, groups, goff))
            total_all += int(total)

        self.stage["cand_enum"] += total_all
        if total_all and host_eval_policy(self.device, total_all):
            self.stage["batches_lazy"] += 1
            waves = self._pe_lazy(built)
        else:
            self.stage["batches_bulk"] += 1
            cand, handles = [], []
            for enc, nat, groups, goff in built:
                ng = groups.shape[0]
                off = np.empty(ng, np.int64)
                loc, plane, row = nat.fill_groups(enc, groups,
                                                  np.arange(ng), off)
                cand.append((loc, None, None, groups, goff))
                if loc.size and host_eval_policy(self.device, loc.size):
                    self.stage["cand_host"] += loc.size
                    if p.gap > 0:
                        c, p0, p1 = host_eval_candidates_gap(
                            p, self.ref, enc, loc, plane, row,
                            n_threads=self.nt_hint)
                        handles.append(
                            ("host", c.astype(np.int32), p0, p1))
                    else:
                        c = host_eval_candidates(
                            p, self.ref, enc, loc, plane, row,
                            n_threads=self.nt_hint)
                        handles.append(
                            ("host", c.astype(np.int32), None, None))
                else:
                    self.stage["cand_device"] += loc.size
                    handles.append(self.dev.extend_async(
                        enc, loc, plane.astype(np.int32), row)
                        if loc.size else None)
            fetched = [h[1:] if isinstance(h, tuple) and h[0] == "host"
                       else (self.dev.fetch(h) if h is not None
                             else (np.zeros(0, np.int32), None, None))
                       for h in handles]
            out1 = replay_pe(p, self.ref, enc_a, cand[0], fetched[0],
                             enc_b, cand[1], fetched[1],
                             n_threads=self.nt_hint)
            waves = [(np.ones(B, bool), out1)]
        return self._emit_pe_waves(enc_a, enc_b, waves)


class TorchPairThreadedRunner(PairThreadedRunner):
    """-p worker pool of port PE aligners (see
    ``pairs.aligner.PairThreadedRunner``): one aligner per worker, output in
    batch order."""

    def __init__(self, params, ref, index, n_workers: int, device):
        from concurrent.futures import ThreadPoolExecutor
        self.aligners = [TorchPairEndAligner(params, ref, index,
                                             device=device)
                         for _ in range(n_workers)]
        nt = max(1, len(os.sched_getaffinity(0)) // n_workers)
        for a in self.aligners:
            a.nt_hint = nt
        self.pools = [ThreadPoolExecutor(1) for _ in range(n_workers)]
        self.n = n_workers
        self.i = 0


def run_pair_end(params: AlignParams, ref_path: str, reads_a_path: str,
                 reads_b_path: str, out_fh=None,
                 command_line: str = "basal_tpu_torch",
                 log=lambda *a: None, timings: Optional[dict] = None,
                 device=None, index_factory=None):
    """Align the mate files against ``ref_path`` and write SAM bytes to
    ``out_fh``.  Returns the (first) aligner, whose ``stage`` counts where
    candidates were evaluated.  ``index_factory(ref, params)`` replaces the
    dense seed index (see ``align.pipeline.run_single_end``)."""
    device = resolve_device(device)
    with malloc_window():
        return _run_pair_end(params, ref_path, reads_a_path, reads_b_path,
                             out_fh, command_line, log, timings, device,
                             index_factory)


def _pair_summary(log, rd_a, params, t0, counters, aligners):
    n_al, n_un, n_mu = counters
    n = max(rd_a.index - params.read_start + 1, 1)
    log(f"total read pairs: {n} \ttotal time: {time.time()-t0:.0f} secs")
    log(f"aligned pairs: {n_al} ({100.0*n_al/n:.1f}%), "
        f"unique pairs: {n_un} ({100.0*n_un/n:.1f}%), "
        f"non-unique pairs: {n_mu} ({100.0*n_mu/n:.1f}%)")
    log(_pe_stage_report(aligners), 2)


def _run_pair_end(params, ref_path, reads_a_path, reads_b_path, out_fh,
                  command_line, log, timings, device, index_factory=None):
    t0 = time.time()
    ref = load_reference(ref_path, params)
    log(f"{ref.total_num} reference seqs loaded, total size {ref.sum_length} bp.")
    if timings is not None:
        timings["t_ref"] = time.time() - t0
    built = ""
    if index_factory is not None:
        index = index_factory(ref, params)
    elif params.rrbs_flag:
        from ..index.rrbs import build_rrbs_index
        index = build_rrbs_index(ref_path, ref, params)
    else:
        index, place = build_index_on(ref, params, device)
        built = f" on {place}"
    log(f"create seed table{built}. {time.time()-t0:.0f} secs passed")
    if timings is not None:
        timings["t_index"] = time.time() - t0 - timings["t_ref"]
        timings["t_align_start"] = time.time()
    out_fh = out_fh or sys.stdout
    if params.sam_header:
        out_fh.write(sam_header(ref, params, command_line).encode("latin1"))
    rd_a = open_reads(reads_a_path, params, readset=1)
    rd_b = open_reads(reads_b_path, params, readset=2)
    if params.num_threads > 1 and params.randseed != 0 \
            and not params.rrbs_flag:
        from collections import deque
        runner = TorchPairThreadedRunner(params, ref, index,
                                         params.num_threads, device)
        futures = deque()
        while True:
            a = rd_a.next_batch()
            b = rd_b.next_batch()
            ok = a and len(a) == len(b)
            if ok:
                futures.append(runner.submit(a, b))
            while futures and (not ok or len(futures) > runner.n):
                out_fh.write(futures.popleft().result())
                log(f"{rd_a.index - params.read_start + 1} read pairs "
                    f"finished.")
            if not ok:
                break
        runner.shutdown()
        _pair_summary(log, rd_a, params, t0, runner.counters(),
                      runner.aligners)
        return runner.aligners[0]
    aligner = TorchPairEndAligner(params, ref, index, device=device)
    while True:
        a = rd_a.next_batch()
        b = rd_b.next_batch()
        if not a or len(a) != len(b):
            break
        out_fh.write(aligner.align_batch(a, b))
        log(f"{rd_a.index - params.read_start + 1} read pairs finished.")
    _pair_summary(log, rd_a, params, t0, aligner.pair_stats(), [aligner])
    return aligner
