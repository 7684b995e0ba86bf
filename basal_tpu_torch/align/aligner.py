"""Single-end alignment pipeline, host half: the aligner that orchestrates
host IO/encode, the device extension kernel, the exact scan replay, and SAM
emission.  ``align.pipeline`` subclasses it with the port's device.

Equivalent of the reference's batch loop (t_SingleAlign/Do_Batch,
main.cpp:60-92, align.cpp:565-580), restructured for a TPU:

  host:   batch read -> filter/trim -> encode planes -> seed schedule ->
          candidate table                      (numpy, overlappable)
  device: extend_kernel over all candidates    (jit / Pallas)
  host:   scan replay -> SAM text

Copied from ``basal_tpu/align/pipeline.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: imports; removed the JAX members
(``_cpu_backend``, ``host_eval_policy``, ``DeviceContext``, and
``SingleEndAligner.dev`` / ``_fused_host`` / ``_host_eval_policy``, which
``TorchSingleEndAligner`` defines) and ``run_single_end`` /
``_run_single_end``, which ``align.pipeline`` defines.  The port's spans
(``basal_tpu_torch.trace``) and the counters ``emit_native_reads`` and
``emit_python_reads`` (printed by ``stage_report``) changed these members:
``_maybe_start_thp``, ``SingleEndAligner.__init__``, ``submit_batch``
(through the new ``_submit_batch``), ``_dispatch_unique``,
``finish_batch``, ``_finish_with``, ``_emit_native``,
``ThreadedRunner.submit`` (through the new ``ThreadedRunner._align``) and
``stage_report``.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from .. import trace
from ..config import AlignParams
from ..index.reference import PackedReference
from ..reads.encode import encode_batch
from .candidates import SeedScheduler, build_candidates
from .replay import Replayer
from .rng import MyRand
from .sam import SamEmitter


#: Above this many candidates the upload exceeds what a remote-TPU link
#: absorbs faster than the host's SIMD evaluator chews the same work
#: (~2 ns/candidate-word); locally attached chips should set
#: BASAL_TPU_HOST_EVAL=0 (always device) or raise the threshold.
HOST_EVAL_MIN = 2_000_000

# Once a run has processed this many reads, MADV_COLLAPSE the seed-index
# tables into 2 MiB pages on a background thread (native.madvise_collapse:
# the random gathers in seed scheduling are TLB-bound on 4 KiB pages, ~40%
# of bt_build_groups_mt; collapse costs ~5 s/172 MB table on this host, so
# only long runs amortize it).  BASAL_TPU_THP=0 disables, =1 forces at
# aligner construction.
THP_AFTER_READS = 150_000


def _maybe_start_thp(aligner) -> None:
    if aligner._thp_started or aligner.total_reads < THP_AFTER_READS:
        return
    aligner._thp_started = True
    if os.environ.get("BASAL_TPU_THP", "auto") == "0":
        return
    import threading

    from ..native import collapse_index_tables

    def collapse():
        with trace.span("index.thp_collapse"):
            collapse_index_tables(aligner.index, aligner.ref)
    threading.Thread(target=collapse, daemon=True).start()


def _inline_tail_enabled() -> bool:
    """Whether the scan may evaluate unmaterialized candidates on the host
    at visit time (BASAL_TPU_HOST_EVAL=0 forces all evaluation onto the
    device, reverting to ladder waves)."""
    import os
    return os.environ.get("BASAL_TPU_HOST_EVAL", "auto") != "0"


def _mode_name(params: AlignParams) -> str:
    if params.nt3:
        return "nt3"
    return "oneway" if params.rule.one_way else "multiway"


class SingleEndAligner:
    def __init__(self, params: AlignParams, ref: PackedReference,
                 index, use_native: Optional[bool] = None):
        self.p = params
        self.ref = ref
        self.index = index
        self.rng = MyRand(params.randseed)
        self.sched = SeedScheduler(params, index, self.rng)
        self._dev = None  # lazy: host-only runs must never claim a device
        self._host_t = 0.0  # measured host-evaluator wall (s) / candidates
        self._host_n = 0
        # per-call C++ thread width; ThreadedRunner divides the cores among
        # its workers so -p N does not oversubscribe N x 8 threads
        self.nt_hint = 0  # 0 = auto (all cores)
        self.replayer = Replayer(params, ref, self.rng)
        rrbs_fn = None
        if params.rrbs_flag:
            from ..index.rrbs import ccgg_seglen
            rrbs_fn = (lambda c, l, L: ccgg_seglen(index, c, l, L))
        self.emitter = SamEmitter(params, ref, self.rng, rrbs_seglen=rrbs_fn)
        self.total_reads = 0
        self.total_candidates = 0
        self._thp_started = False
        if os.environ.get("BASAL_TPU_THP") == "1":
            from ..native import collapse_index_tables
            collapse_index_tables(index, ref)  # forced: collapse at startup
            self._thp_started = True
        # per-stage cost anatomy, printed at -V 2 (the reference keeps the
        # analogous total_candidates/total_seeds counters, align.h:98)
        self.stage = {
            "cand_device": 0,    # evaluated through the accelerator kernel
            "cand_host": 0,      # evaluated by the host SIMD evaluator
            "cand_visit": 0,     # left to visit-time eval inside the scan
            "dedup_saved": 0,    # duplicate (row,loc,plane) uploads avoided
            "waves_device": 0, "waves_host": 0, "waves_visit": 0,
            "eager_batches": 0, "ladder_batches": 0, "ladder_waves": 0,
            "fused_batches": 0,  # single-pass build+eval+scan (C++)
            # reads formatted by the native formatter / the Python emitter
            "emit_native_reads": 0, "emit_python_reads": 0,
        }
        from ..native import NativeBatch, native_available
        if use_native is None:
            use_native = (native_available() and params.randseed != 0
                          and not params.rrbs_flag)
        self.native = (NativeBatch(params, index, ref)
                       if use_native else None)
        # RRBS fast path: C++ candidate build (bt_build_candidates_rrbs) +
        # host evaluation + C++ replay with per-candidate plane/skip; SAM
        # emission stays on the Python emitter (ZP/ZL fragment lookups).
        # BASAL_TPU_NO_NATIVE / randseed 0 keep the pure-Python twins.
        self.native_rrbs = None
        self.formatter = None
        if self.native is not None and not params.rrbs_flag:
            from ..native import NativeFormatter
            self.formatter = NativeFormatter(params, ref)
        elif (params.rrbs_flag and params.randseed != 0 and native_available()
                and os.environ.get("BASAL_TPU_NO_NATIVE") is None):
            self.native_rrbs = NativeBatch(params, index, ref)
            from ..native import NativeFormatter
            self.formatter = NativeFormatter(params, ref, rrbs_index=index)

    # -- two-phase API for the overlapped pipeline -----------------------
    def stats(self):
        """(aligned, unique, multiple) merged across the Python emitter and
        the native formatter."""
        e = self.emitter
        a, u, m = e.n_aligned, e.n_unique, e.n_multiple
        if self.formatter is not None:
            c = self.formatter.counters
            a += int(c[0])
            u += int(c[1])
            m += int(c[2])
        return a, u, m

    # Wave policy: evaluate every stratum's candidates in one device call
    # while the total volume is small.  On candidate-heavy inputs (repetitive
    # genomes: 10^4-10^5 candidates/read) climb the strata ladder instead —
    # wave k evaluates only stratum-k candidates of still-unresolved reads,
    # which reproduces the cost profile of the reference's pigeonhole early
    # stop (align.cpp:459-463) while staying batched.
    EAGER_MAX_CANDS = 2_000_000

    def encode_post(self, reads):
        """Encode a batch and POST its routing query without waiting
        (shard-resident index).  The reply lands on the service thread
        while the caller finishes the previous batch; submit_batch(reads,
        enc=...) then waits (usually a no-op) before any index read."""
        enc = encode_batch(self.p, reads)
        ens = getattr(self.index, "ensure_batch", None)
        if ens is not None:
            ens(enc, wait=False, extra=self._stale_seeds())
        return enc

    def _stale_seeds(self):
        """Current stale seed-buffer values (may be probed by this batch's
        (L-I+1)%s==0 reads but absent from its own seedval)."""
        nb = self.native
        st = nb.seed_state if nb is not None else self.sched.seed_state
        return st.reshape(-1)

    def submit_batch(self, reads, enc=None, routed_ready=False):
        """Host encode + lazy candidate build + async dispatch of wave 1.

        ``routed_ready=True`` asserts this batch's routing reply has
        already landed (the caller posted a LATER batch's query, and the
        single-slot post blocks until the prior reply is in), so the wait
        is skipped — see the read-ahead loop in _run_single_end."""
        with trace.span("aligner.submit", of=reads):
            return self._submit_batch(reads, enc, routed_ready)

    def _submit_batch(self, reads, enc, routed_ready):
        if enc is None:
            from ..reads.io import RawBatch as _RB
            chk = self._fused_chunk()
            if (chk > 0 and self.native is not None
                    and isinstance(reads, _RB)
                    and getattr(self.index, "ensure_batch", None) is None
                    and len(reads) >= 2 * chk
                    and self._fused_host()):
                return self._submit_fused_chunked(reads)
            with trace.span("aligner.encode"):
                enc = encode_batch(self.p, reads)
            ens = getattr(self.index, "ensure_batch", None)
            if ens is not None:  # shard-resident index: one routed round
                ens(enc, extra=self._stale_seeds())
        elif not routed_ready:
            wb = getattr(self.index, "wait_batch", None)
            if wb is not None:
                wb()
        self.total_reads += len(reads)
        _maybe_start_thp(self)
        if self.native is None:
            return ("py", enc)
        from ..reads.io import RawBatch
        ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                else np.array([r.index for r in enc.reads], dtype=np.uint32))
        if self._fused_host():
            # single-pass C++ schedule + group build + visit-time scan:
            # no candidate buffers, and modes past each read's resolution
            # stratum are never evaluated (see bt_align_se_host)
            res, n_enum, n_eval = self.native.align_se_host(
                enc, ridx, self.ref, n_threads=self.nt_hint)
            self.total_candidates += n_enum
            self.stage["cand_visit"] += n_eval
            self.stage["waves_visit"] += 1
            self.stage["fused_batches"] += 1
            return ("fused", enc, res)
        with trace.span("aligner.groups"):  # and wave 1's groups
            groups, goff, total = self.native.build_groups(enc, ridx)
            ng = groups.shape[0]
            off = np.full(ng, -1, dtype=np.int64)
            if ng == 0:
                return ("native", enc, groups, goff, off, None, None, None,
                        99)
            eff = 99 if total <= self.EAGER_MAX_CANDS else 1
            sel = (np.arange(ng) if eff >= 99
                   else np.flatnonzero(groups[:, 2] < eff))
            n1c = int(groups[sel, 6].sum())
        if total and self.p.gap > 0 and _inline_tail_enabled():
            # gapped: no bulk wave at all — one replay evaluates every
            # candidate at visit time (gap_align_ev's lazy
            # MismatchPattern0/1 under the scan's snp_thres aborts, like
            # the reference's per-candidate GapAlign, align.cpp:348-410).
            # This is the default for ANY volume in auto mode: the gapped
            # device wave downloads K_POS i16 position lists per candidate
            # per shifted alignment and expands them to i32 on the host —
            # measured 3x slower than the oracle on the random profile,
            # while visit-time eval is 2.4x ahead on the repeat profile
            # (tools/configbench.py / tools/gapbench.py).  BASAL_TPU_
            # HOST_EVAL=0 still forces the device ladder (XLA or pallas-gap
            # kernel).
            self.total_candidates += int(total)
            self.stage["cand_visit"] += int(total)
            self.stage["waves_visit"] += 1
            return ("native", enc, groups, goff, off, None,
                    ("inline", int(total)), None, 99)
        if n1c and self.p.gap == 0 and self._host_eval_policy(n1c):
            # fused wave-1 materialize + host evaluation (no fill/copy pass)
            loc = np.empty(n1c, np.int32)
            cnt = np.empty(n1c, np.int32)
            t0 = time.time()
            self.native.fill_eval_groups(enc, self.ref, groups, sel, off, 0,
                                         loc, cnt,
                                         n_threads=self.nt_hint)
            if n1c >= 16384:
                self._host_t += time.time() - t0
                self._host_n += n1c
            self.total_candidates += n1c
            self.stage["cand_host"] += n1c
            self.stage["waves_host"] += 1
            return ("native", enc, groups, goff, off, (loc, None, None),
                    ("host", cnt, None, None), None, eff)
        with trace.span("aligner.fill"):
            loc, plane, row = self.native.fill_groups(enc, groups, sel, off)
        self.total_candidates += loc.size
        handle, uinv = self._dispatch_unique(enc, loc, plane, row)
        return ("native", enc, groups, goff, off, (loc, plane, row),
                handle, uinv, eff)

    def _fused_chunk(self) -> int:
        """Chunk size for the cache-blocked fused host path (0 disables).
        Encode writes ~850 B/read of seed arrays that the fused align
        immediately re-reads; at 50k-read batches that is a 42 MB DRAM
        round trip per batch.  Encoding + aligning in chunks keeps the
        chunk's seed arrays LLC-resident between the two passes.
        Chunking is bit-exact by construction: it is identical to running
        smaller batches, and all cross-read state (sticky start offsets,
        stale seed buffers, myrand read indices) already carries serially
        across batch boundaries (tests/test_fused_chunked.py pins chunked
        == unchunked byte-for-byte).

        DEFAULT OFF (negative A/B, round 5): on this VM chunk=4096
        measured 670-710k reads/s vs 841-846k unchunked, 8192 slightly
        behind, 16384 a wash — per-chunk std::thread spawn/join in the C
        entries eats the locality win, and the shared-LLC slice here is
        too small for the 7-14 MB working sets to stick.  Kept behind the
        knob for hosts with large private LLCs."""
        v = os.environ.get("BASAL_TPU_FUSED_CHUNK", "0")
        try:
            return max(0, int(v))
        except ValueError:
            return 0

    def _submit_fused_chunked(self, reads):
        from ..reads.io import RawBatch
        chk = self._fused_chunk()
        self.total_reads += len(reads)
        _maybe_start_thp(self)
        out = []
        for s in range(0, len(reads), chk):
            e = min(s + chk, len(reads))
            sub = RawBatch(reads.buf, reads.name_off[s:e],
                           reads.name_len[s:e], reads.seq_off[s:e],
                           reads.seq_len[s:e], reads.qual_off[s:e],
                           reads.qual_len[s:e], reads.index0 + s,
                           reads.readset)
            enc = encode_batch(self.p, sub)
            res, n_enum, n_eval = self.native.align_se_host(
                enc, enc.reads.indices, self.ref, n_threads=self.nt_hint)
            self.total_candidates += n_enum
            self.stage["cand_visit"] += n_eval
            self.stage["waves_visit"] += 1
            out.append((enc, res))
        self.stage["fused_batches"] += 1
        return ("fused_chunks", out)

    # host wins a wave when its measured cost/candidate is below this
    # fraction of the device's (hysteresis against routing flapping)
    HOST_DEV_MARGIN = 0.7

    def collapse_now(self) -> int:
        """Synchronously collapse the index tables into hugepages (see
        THP_AFTER_READS).  For callers with an explicit untimed setup
        window (bench.py warmup); returns arrays collapsed."""
        self._thp_started = True
        from ..native import collapse_index_tables
        return collapse_index_tables(self.index, self.ref)

    def measured_placement(self):
        """'host' | 'device' once BOTH paths have real measurements, else
        None.  Public: bench.py keys its batch-size choice on this instead
        of reaching into _host_t/_host_n/_dev."""
        if (self._dev is not None and self._dev.cost_per_cand is not None
                and self._host_n):
            host_cost = self._host_t / self._host_n
            return ("host" if host_cost
                    < self.HOST_DEV_MARGIN * self._dev.cost_per_cand
                    else "device")
        return None

    def _host_eval_timed(self, enc, loc, plane, row):
        """Returns (counts, pos0, pos1); the position lists are None for
        gap == 0 and the gapped replay inputs otherwise."""
        from ..native import host_eval_candidates, host_eval_candidates_gap
        t0 = time.time()
        if self.p.gap > 0:
            counts, pos0, pos1 = host_eval_candidates_gap(
                self.p, self.ref, enc, loc, plane, row,
                n_threads=self.nt_hint)
        else:
            counts = host_eval_candidates(self.p, self.ref, enc, loc, plane,
                                          row, n_threads=self.nt_hint)
            pos0 = pos1 = None
        if loc.size >= 16384:
            self._host_t += time.time() - t0
            self._host_n += loc.size
        return counts, pos0, pos1

    def _dispatch_unique(self, enc, loc, plane, row):
        """Dedup identical (row, loc, plane) candidates before evaluation
        (interval probes regenerate the same alignment start up to
        seedsegs x I times on repeat-heavy genomes).  Skipped on light
        batches where the sort costs more than the duplicate eval."""

        # host evaluation has no upload to save: duplicates are cheaper to
        # re-evaluate (~2 ns) than to dedup (sort-based np.unique), so the
        # dedup step only runs for device dispatch
        if self._host_eval_policy(loc.size):
            self.stage["cand_host"] += loc.size
            self.stage["waves_host"] += 1
            return ("host",) + self._host_eval_timed(enc, loc, plane,
                                                     row), None

        self.stage["waves_device"] += 1

        def dispatch(l, p_, r):
            self.stage["cand_device"] += l.size
            return self.dev.extend_async(enc, l, p_.astype(np.int32), r)

        if loc.size < 4 * len(enc.reads):
            return dispatch(loc, plane, row), None
        with trace.span("aligner.dedup"):
            key = ((row.astype(np.int64) << 33)
                   | (loc.astype(np.int64) << 1) | plane.astype(np.int64))
            uniq, inv = np.unique(key, return_inverse=True)
            dedup = len(uniq) < 0.75 * len(key)
            if dedup:
                order = np.argsort(inv, kind="stable")
                starts = np.searchsorted(inv[order], np.arange(len(uniq)))
                first = order[starts]
                loc, plane, row = loc[first], plane[first], row[first]
        if dedup:
            self.stage["dedup_saved"] += len(key) - len(uniq)
            return dispatch(loc, plane, row), inv
        return dispatch(loc, plane, row), None

    def _fetch_expand(self, handle, uinv):
        if isinstance(handle, tuple) and handle[0] == "host":
            counts = np.asarray(handle[1], dtype=np.int32)  # no-op if i32
            pos0, pos1 = handle[2], handle[3]
        else:
            counts, pos0, pos1 = self.dev.fetch(handle)
        if uinv is not None:
            counts = counts[uinv]
            if pos0 is not None:
                pos0 = pos0[uinv]
                pos1 = pos1[uinv]
        return counts, pos0, pos1

    def prefetch_state(self, state):
        """Block on the wave-1 device results for a submitted state (device
        usage stays serialized with the caller); the remaining pure-host work
        can then run in a side thread via finish_batch_prefetched."""
        if state[0] in ("py", "fused", "fused_chunks") or state[6] is None:
            return None
        if isinstance(state[6], tuple) and state[6][0] == "inline":
            return None  # no wave-1 results: all-visit-time replay
        return self._fetch_expand(state[6], state[7])

    def finish_batch_prefetched(self, state, fetched) -> bytes:
        """finish_batch with the wave-1 fetch already done.  NOTE: ladder
        wave-2+ still issues device calls; callers that need strict device
        serialization should only use this on eager (single-wave) batches —
        wave 2 triggers for <5% of reads on non-repetitive references."""
        if fetched is None:
            return self.finish_batch(state)
        return self._finish_with(state, fetched)

    def finish_batch(self, state) -> bytes:
        with trace.span("aligner.finish", of=state[1]):
            if state[0] == "py":
                return self._align_batch_python(state[1])
            if state[0] == "fused":
                return self._emit_native(state[1], [(None, state[2])])
            if state[0] == "fused_chunks":
                return b"".join(self._emit_native(e, [(None, r)])
                                for e, r in state[1])
            return self._finish_with(state, self.prefetch_state(state))

    def _finish_with(self, state, fetched) -> str:
        (_, enc, groups, goff, off, arrs, handle, uinv, eff) = state
        p = self.p
        if handle is None or (isinstance(handle, tuple)
                              and handle[0] == "inline"):
            z = np.zeros(0, np.int32)
            t0 = time.time()
            with trace.span("aligner.replay"):
                res = self.native.replay_se(enc, groups, goff, z, None, z,
                                            None, None, counts_off=off,
                                            inline_eval=handle is not None,
                                            n_threads=self.nt_hint)
            if handle is not None and handle[1] >= 16384:
                # conservative host-cost sample (includes the scan itself)
                self._host_t += time.time() - t0
                self._host_n += handle[1]
            return self._emit_native(enc, [(None, res)])
        loc, plane, row = arrs
        counts, pos0, pos1 = (fetched if fetched is not None
                              else self._fetch_expand(handle, uinv))
        if eff >= 99:
            self.stage["eager_batches"] += 1
            with trace.span("aligner.replay"):
                res = self.native.replay_se(enc, groups, goff, loc, plane,
                                            counts, pos0, pos1,
                                            counts_off=off,
                                            n_threads=self.nt_hint)
            return self._emit_native(enc, [(None, res)])

        # strata ladder.  Candidate/count arrays grow each wave; appending
        # via np.concatenate re-copies the whole prefix every wave (O(waves
        # x C) memcpy — it dominated the repetitive profile), so the waves
        # append into amortized-doubling buffers instead.  The C++ replay
        # only dereferences offsets < cur, so passing the full-capacity
        # buffers is safe, and int32 buffers make replay_se's
        # ascontiguousarray a no-op.
        with trace.span("aligner.ladder"):
            read_of_group = groups[:, 0]
            self.stage["ladder_batches"] += 1
            waves = []
            done = np.zeros(len(enc.reads), dtype=bool)
            lim = eff
            cur = loc.size
            cap = max(2 * cur, cur + (1 << 20))
            loc_buf = np.empty(cap, np.int32)
            loc_buf[:cur] = loc
            cnt_buf = np.empty(cap, np.int32)
            cnt_buf[:cur] = counts
            pos0_buf = pos1_buf = None
            if pos0 is not None:
                pos0_buf = np.empty((cap,) + pos0.shape[1:], np.int32)
                pos0_buf[:cur] = pos0
                pos1_buf = np.empty((cap,) + pos1.shape[1:], np.int32)
                pos1_buf[:cur] = pos1

            def _grow(need):
                nonlocal cap, loc_buf, cnt_buf, pos0_buf, pos1_buf
                if need <= cap:
                    return
                cap = max(need, 2 * cap)

                def g(buf):
                    nb = np.empty((cap,) + buf.shape[1:], buf.dtype)
                    nb[:cur] = buf[:cur]
                    return nb
                loc_buf, cnt_buf = g(loc_buf), g(cnt_buf)
                if pos0_buf is not None:
                    pos0_buf, pos1_buf = g(pos0_buf), g(pos1_buf)

            while True:
                self.stage["ladder_waves"] += 1
                filt = np.ascontiguousarray(enc.filtered | done, np.uint8)
                with trace.span("aligner.replay"):
                    res = self.native.replay_se(enc, groups, goff, loc_buf,
                                                plane, cnt_buf, pos0_buf,
                                                pos1_buf, mode_limit=lim,
                                                filtered_override=filt,
                                                counts_off=off,
                                                n_threads=self.nt_hint)
                incomplete = res[0] == -2
                newly = (~incomplete) & (~done)
                waves.append((newly, res))
                done |= newly
                if not incomplete.any():
                    break
                sel = np.flatnonzero((groups[:, 2] == lim)
                                     & incomplete[read_of_group])
                n2 = int(groups[sel, 6].sum())  # column 6 = group size
                n_inc = int(incomplete.sum())
                if (_inline_tail_enabled()
                        and (n2 < 1_000_000 or n2 > 2_000 * n_inc)):
                    # tail wave is either tiny (not worth a bulk round trip) or
                    # mega-groups serving few reads (bulk evaluation would be
                    # mostly wasted past the scan's abort points): finish with
                    # ONE replay that evaluates the remaining candidates at
                    # visit time inside the scan
                    self.stage["cand_visit"] += n2
                    self.stage["waves_visit"] += 1
                    filt = np.ascontiguousarray(enc.filtered | done, np.uint8)
                    with trace.span("aligner.replay"):
                        res = self.native.replay_se(
                            enc, groups, goff, loc_buf, plane, cnt_buf,
                            pos0_buf, pos1_buf, mode_limit=99,
                            filtered_override=filt, counts_off=off,
                            inline_eval=True)
                    waves.append((~done, res))
                    break
                self.total_candidates += n2
                _grow(cur + n2)
                if n2 and self.p.gap == 0 and self._host_eval_policy(n2):
                    # fused C++ materialize + evaluate straight into the tail
                    self.stage["cand_host"] += n2
                    self.stage["waves_host"] += 1
                    t0 = time.time()
                    self.native.fill_eval_groups(
                        enc, self.ref, groups, sel, off, cur,
                        loc_buf[cur:cur + n2], cnt_buf[cur:cur + n2],
                        n_threads=self.nt_hint)
                    if n2 >= 16384:
                        self._host_t += time.time() - t0
                        self._host_n += n2
                    cur += n2
                elif n2:
                    with trace.span("aligner.fill"):
                        loc2, plane2, row2 = self.native.fill_groups(
                            enc, groups, sel, off, base=cur)
                    h2, uinv2 = self._dispatch_unique(enc, loc2, plane2, row2)
                    c2, p02, p12 = self._fetch_expand(h2, uinv2)
                    loc_buf[cur:cur + n2] = loc2
                    cnt_buf[cur:cur + n2] = c2
                    if pos0_buf is not None and p02 is not None:
                        pos0_buf[cur:cur + n2] = p02
                        pos1_buf[cur:cur + n2] = p12
                    cur += n2
                lim += 1
        return self._emit_native(enc, waves)

    def align_batch(self, reads) -> bytes:
        return self.finish_batch(self.submit_batch(reads))

    def _align_batch_rrbs_native(self, enc) -> bytes:
        """RRBS batch through the native engine: C++ candidate build +
        host-SIMD evaluation + C++ replay (per-candidate plane/skip) + the
        threaded C++ formatter (ZP/ZL via the CCGG_seglen twin).
        Byte-identical to the pure-Python path (test_differential_rrbs.py
        + fuzz); BASAL_TPU_NO_NATIVE=1 reverts."""
        from ..reads.io import RawBatch
        from ..native import host_eval_candidates, host_eval_candidates_gap
        nb = self.native_rrbs
        ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                else np.array([r.index for r in enc.reads], dtype=np.uint32))
        groups, goff, loc, plane, skip, row, total = \
            nb.build_candidates_rrbs(enc, ridx, self.index)
        self.total_candidates += total
        self.stage["cand_host"] += total
        self.stage["waves_host"] += 1
        pos0 = pos1 = None
        if total and self.p.gap > 0:
            counts, pos0, pos1 = host_eval_candidates_gap(
                self.p, self.ref, enc, loc, plane, row,
                n_threads=self.nt_hint)
        elif total:
            counts = host_eval_candidates(self.p, self.ref, enc, loc, plane,
                                          row, n_threads=self.nt_hint)
        else:
            counts = np.zeros(0, dtype=np.int32)
        res = nb.replay_se(enc, groups, goff, loc, None, counts, pos0, pos1,
                           n_threads=self.nt_hint,
                           rr_plane=plane, rr_skip=skip)
        return self._emit_native(enc, [(None, res)])

    def _align_batch_python(self, enc) -> bytes:
        if self.p.rrbs_flag:
            if self.native_rrbs is not None:
                return self._align_batch_rrbs_native(enc)
            from .candidates import build_candidates_rrbs
            table = build_candidates_rrbs(self.p, self.index, self.ref, enc,
                                          self.sched)
        else:
            table = build_candidates(self.p, self.index, enc, self.sched)
        self.total_candidates += table.loc.size
        if table.loc.size:
            counts, pos0, pos1 = self.dev.extend(
                enc, table.loc, table.plane, table.row)
        else:
            counts = np.zeros(0, dtype=np.int32)
            pos0 = pos1 = None
        results = self.replayer.replay_batch(enc, table, counts, pos0, pos1)
        out: List[str] = []
        for read, res, L in zip(enc.reads, results, enc.map_len):
            self.emitter.emit_read(read, res, int(L), out)
        return "".join(out).encode("latin1")

    def _emit_native(self, enc, waves) -> bytes:
        from .replay import ReadResult

        def read_result(res, i):
            (stratum, n0, n1, hchr, hloc, hgsz, hgpos, hchain, hoff) = res
            if stratum[i] < 0:
                return ReadResult(filtered=True)
            a, b = int(hoff[i]), int(hoff[i + 1])
            hits = [(int(hchr[j]), int(hloc[j]), int(hgsz[j]),
                     int(hgpos[j])) for j in range(a, b)]
            k0 = int(n0[i])
            return ReadResult(filtered=False, stratum=int(stratum[i]),
                              nhits=b - a, hits0=hits[:k0], hits1=hits[k0:])

        if self.formatter is not None and len(waves) == 1:
            # counters accumulate inside the native formatter; stats() merges
            self.stage["emit_native_reads"] += len(enc.reads)
            with trace.span("sam.native"):
                return self.formatter.format(enc, waves[0][1],
                                             n_threads=self.nt_hint)
        self.stage["emit_python_reads"] += len(enc.reads)
        with trace.span("sam.python"):
            out: List[str] = []
            for i, read in enumerate(enc.reads):
                res = None
                for mask, wres in waves:
                    if mask is None or mask[i]:
                        res = read_result(wres, i)
                        break
                if res is None:  # only possible if every wave skipped it
                    res = read_result(waves[-1][1], i)
                self.emitter.emit_read(read, res, int(enc.map_len[i]), out)
            return "".join(out).encode("latin1")

class ThreadedRunner:
    """-p worker pool: the TPU-native replacement for the reference's pthread
    fan-out (t_SingleAlign, main.cpp:60-92).  Each worker owns a full aligner
    (private scheduler state, like each pthread's SingleAlign instance); the
    C++ engine and numpy release the GIL, so host phases of consecutive
    batches overlap.  Output is written in batch order (deterministic, a
    valid interleaving of the reference's mutex-ordered appends)."""

    def __init__(self, params, ref, index, n_workers: int):
        from concurrent.futures import ThreadPoolExecutor
        import os
        self.aligners = [SingleEndAligner(params, ref, index)
                         for _ in range(n_workers)]
        nt = max(1, len(os.sched_getaffinity(0)) // n_workers)
        for a in self.aligners:
            a.nt_hint = nt  # divide cores among workers
        # One single-thread executor per aligner: batches that round-robin
        # onto the same (stateful) aligner are serialized by its own queue,
        # so correctness never depends on the caller's drain window.
        self.pools = [ThreadPoolExecutor(1) for _ in range(n_workers)]
        self.n = n_workers
        self.i = 0

    def submit(self, reads):
        slot = self.i % self.n
        self.i += 1
        return self.pools[slot].submit(self._align, self.aligners[slot],
                                       reads, trace.now())

    @staticmethod
    def _align(aligner, reads, t_submit) -> bytes:
        """align_batch on the slot's thread; the time the batch waited
        there since ``submit`` is its ``runner.queue`` span."""
        if t_submit is not None:
            trace.record("runner.queue", t_submit, time.perf_counter(),
                         of=reads)
        return aligner.align_batch(reads)

    def counters(self):
        totals = [a.stats() for a in self.aligners]
        return tuple(sum(t[i] for t in totals) for i in range(3))

    def shutdown(self):
        for p in self.pools:
            p.shutdown()


def stage_report(aligners) -> str:
    """One-line cost anatomy merged over worker aligners: where candidates
    were evaluated (device kernel / host SIMD / visit-time in the scan),
    wave and placement decision counts, dedup savings.  Printed at -V 2;
    the reference's analogue is its total_candidates/total_seeds counters
    (align.h:98)."""
    keys = aligners[0].stage.keys()
    s = {k: sum(a.stage[k] for a in aligners) for k in keys}
    n_cand = sum(a.total_candidates for a in aligners) or 1
    n_reads = sum(a.total_reads for a in aligners) or 1
    return (f"cost anatomy: {n_cand} candidates ({n_cand/n_reads:.1f}/read) "
            f"| eval: device {s['cand_device']} host {s['cand_host']} "
            f"visit-time {s['cand_visit']} dedup-saved {s['dedup_saved']} "
            f"| waves: device {s['waves_device']} host {s['waves_host']} "
            f"visit {s['waves_visit']} "
            f"| batches: eager {s['eager_batches']} "
            f"ladder {s['ladder_batches']} "
            f"(ladder waves {s['ladder_waves']}) "
            f"fused {s['fused_batches']} "
            f"| SAM reads: native {s['emit_native_reads']} "
            f"python {s['emit_python_reads']}")
