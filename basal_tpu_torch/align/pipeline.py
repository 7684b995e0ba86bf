"""Single-end alignment pipeline on a PyTorch device.

PyTorch counterpart of ``basal_tpu.align.pipeline``.  The host layers (C++
engine: encode, seed schedule, candidate groups, replay, SAM formatter) are
the port's copies of basal_tpu's (``align.aligner``, ``native``); this
module owns what touches the device:

  host:   batch read -> encode -> seed schedule -> candidate groups
  device: one int32 blob per wave -> CUDA count kernel, or with -g the
          CUDA gap kernel (ops.extend_cuda)
  host:   scan replay -> SAM bytes

The device is resolved once per aligner from ``BASAL_TPU_TORCH_DEVICE``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).  ``cuda``
without a card raises: nothing falls back to the CPU on its own.  With
several visible cards the waves run on a dp x rs mesh of them
(``parallel.mesh``); a multi-process run passes its routed seed index in
through ``index_factory`` (``parallel.multihost``).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import malloc_window, trace
from ..config import AlignParams
from ..index.reference import PackedReference, load_reference
from ..index.device_build import build_index_on
from ..ops.extend import K_POS
from ..ops.extend_cuda import extend_counts_blob, extend_gap_blob
from ..reads.encode import EncodedBatch
from ..reads.io import open_reads
from .aligner import (HOST_EVAL_MIN, SingleEndAligner, ThreadedRunner,
                      _inline_tail_enabled, _mode_name, stage_report)
from .sam import sam_header

#: rowmeta's exception-row field is 12 bits (index + 1): a wave with more
#: N-containing rows is split at row boundaries (split_waves)
MAX_EXC_ROWS = 4094


def resolve_device(name=None) -> torch.device:
    """The port's device: ``name`` (a str or torch.device), else
    ``BASAL_TPU_TORCH_DEVICE``, else ``cuda``.  Raises when CUDA is asked
    for and torch finds no card."""
    if name is None:
        name = os.environ.get("BASAL_TPU_TORCH_DEVICE", "cuda")
    dev = torch.device(name)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"BASAL_TPU_TORCH_DEVICE={name}: want cpu or cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"BASAL_TPU_TORCH_DEVICE={name} but torch finds no CUDA device; "
            "set BASAL_TPU_TORCH_DEVICE=cpu to run on the CPU")
    return dev


def reference_to_device(ref: PackedReference, device) -> torch.Tensor:
    """``ref.ref32`` (fwd plane then RC plane) as one int32 tensor."""
    words = np.ascontiguousarray(ref.ref32).reshape(-1).view(np.int32)
    return torch.from_numpy(words).to(device)


def blob_to_device(blob: np.ndarray, device):
    """Start the upload of one wave blob.  Returns (device tensor, host
    staging tensor or None).  On CUDA the blob goes through a pinned buffer
    with a non_blocking copy on the current stream; the caller keeps the
    staging tensor referenced until the wave has been fetched."""
    device = torch.device(device)
    host = torch.from_numpy(blob)
    if device.type == "cpu":
        return host, None
    with trace.span("devctx.pinned"):
        staging = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staging.copy_(host)
        return staging.to(device, non_blocking=True), staging


def _hasn(enc: EncodedBatch) -> np.ndarray:
    """Rows whose validity plane is not the pure length mask (reads with
    Ns); cached on the batch as basal_tpu's blob builder does."""
    hasn = getattr(enc, "_hasn_cache", None)
    if hasn is None:
        hasn = (enc.valid != enc.lenmask).any(axis=1)
        enc._hasn_cache = hasn
    return hasn


def build_blob(enc: EncodedBatch, mode: str, loc, plane, used, roff,
               pad: int = 0, upad: int = 0, epad: Optional[int] = None):
    """Assemble the int32 wave blob (layout: ops.extend.carve_blob).

    ``used`` are the active rows, ``roff`` their candidate offsets (U+1+upad
    entries).  ``pad``/``upad`` pad candidates (loc 12800) and rows with
    zeros, and ``epad`` sets the exception rows shipped (default: E, at
    least 1), so that a test can build basal_tpu's padded blob.  Returns
    (blob, E_padded); the caller keeps E <= MAX_EXC_ROWS."""
    excm = _hasn(enc)[used]
    E = int(excm.sum())
    if E > MAX_EXC_ROWS:
        raise ValueError(f"{E} exception rows exceed the rowmeta field "
                         f"({MAX_EXC_ROWS}); split the wave first")
    epad = max(E, 1) if epad is None else epad
    U = len(used)
    locp = (loc.astype(np.uint32)
            | (plane.astype(np.uint32) << np.uint32(31))).view(np.int32)
    exc = np.zeros(U, np.uint32)
    exc[excm] = 1 + np.arange(E, dtype=np.uint32)
    rl = np.repeat(enc.map_len, 2)[used].astype(np.uint32)
    nc = np.repeat(enc.n_count, 2)[used].astype(np.uint32)
    rowmeta = ((exc << np.uint32(20)) | (nc << np.uint32(10))
               | rl).view(np.int32)
    parts = [np.pad(locp, (0, pad), constant_values=12800),
             np.asarray(roff, np.int32), np.pad(rowmeta, (0, upad))]

    def flat(a):
        a = a[used]
        if upad:
            a = np.pad(a, ((0, upad), (0, 0)))
        return a.reshape(-1).view(np.int32)

    parts.append(flat(enc.base))
    if mode == "multiway":
        parts.append(flat(enc.mread))
    ev = enc.valid[used][excm]
    if E < epad:
        ev = np.pad(ev, ((0, epad - E), (0, 0)))
    parts.append(ev.reshape(-1).view(np.int32))
    return np.concatenate(parts), epad


def split_waves(enc: EncodedBatch, row: np.ndarray):
    """Candidate ranges [a, b) that cover ``row`` (non-decreasing) at row
    boundaries, each holding at most MAX_EXC_ROWS N-containing rows.  Exact:
    every candidate is evaluated against its own row alone."""
    if row.size == 0:
        return []
    used, first = np.unique(row, return_index=True)
    cum = np.cumsum(_hasn(enc)[used])
    if cum[-1] <= MAX_EXC_ROWS:
        return [(0, row.size)]
    cuts = [0]
    done = 0
    while cuts[-1] < len(used):
        e = int(np.searchsorted(cum, done + MAX_EXC_ROWS, side="right"))
        cuts.append(e)
        done = int(cum[e - 1])
    starts = list(first[cuts[:-1]]) + [row.size]
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


class _Wave(NamedTuple):
    C: int                     # candidates
    U: int                     # rows (reads x strands) in the blob
    E: int                     # exception rows shipped
    out: tuple                 # counts u8 [C] (gapped: + pos0, pos1 i16);
                               # pinned host copies on CUDA
    event: Optional[object]    # torch.cuda.Event behind the copies
    t0: float
    keep: tuple                # buffers referenced until the fetch


def download(C: int, U: int, E: int, out: tuple, t0: float,
             keep: tuple) -> _Wave:
    """A wave of C candidates over U rows and E exception rows whose
    results ``out`` are on a device: on
    CUDA, pinned host copies started on the current stream behind an event
    (``keep`` and ``out`` stay referenced until the fetch); on the CPU, the
    results as they are."""
    dev = out[0].device
    if dev.type == "cpu":
        return _Wave(C, U, E, out, None, t0, ())
    with torch.cuda.device(dev), trace.span("devctx.pinned"):
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return _Wave(C, U, E, host, event, t0, keep + (out,))


class TorchDeviceContext:
    """Holds the packed reference on the device and runs the count kernel,
    or with ``params.gap > 0`` the gap kernel.

    The same surface as basal_tpu's DeviceContext that the SE and PE
    aligners use: extend_async / fetch / extend, cost_per_cand, stalls,
    up_bytes / up_waves, CHUNK; ``up_cand_max`` is the largest wave's
    candidate count and ``down_bytes`` counts the result bytes
    copied back.

    ``fetch`` keeps basal_tpu's stall watchdog (knobs, timeout and
    exemption) but not its answer to a stall.  basal_tpu evaluates a
    stalled wave on the host and carries on, which suits a remote chip
    behind a tunnel.  On a local card a wave far past its expected time
    means the card is hung or contended, and carrying on would hide that:
    here the stall is counted in ``stalls`` and raised.

    A gapped wave of CHUNK candidates holds (1 + 28 + 56*gap) bytes per
    candidate of pinned host memory until it is fetched: 826 MB at gap 3."""

    CHUNK = 4 << 20

    def __init__(self, ref: PackedReference, params: AlignParams, device):
        self.params = params
        self.device = resolve_device(device)
        self.nw = ref.ref32.shape[1]
        self.mode = _mode_name(params)
        self.ref32 = reference_to_device(ref, self.device)
        self._init_counters()

    def _init_counters(self):
        self.stalls = 0
        # measured dispatch->fetch wall per candidate (adaptive placement);
        # the first fetch is skipped: it folds in the kernel build and load
        self.meas_t = 0.0
        self.meas_n = 0
        self._meas_skip = 1
        self.up_bytes = 0
        self.up_waves = 0
        self.up_cand_max = 0   # the most candidates of one wave
        self.down_bytes = 0

    @property
    def cost_per_cand(self):
        """Measured seconds per candidate, or None until a wave of at least
        16k candidates has been fetched."""
        return self.meas_t / self.meas_n if self.meas_n else None

    def wave_blobs(self, enc: EncodedBatch, loc, plane, row):
        """(blob, C, U, E) of each wave the candidates make: CHUNK-sized,
        then split at row boundaries by split_waves.  The host work is in
        ``devctx.blob`` spans, closed before each yield."""
        for i in range(0, loc.shape[0], self.CHUNK):
            with trace.span("devctx.blob"):
                l_, p_, r_ = (a[i:i + self.CHUNK] for a in (loc, plane, row))
                if r_.size > 1 and (np.diff(r_) < 0).any():
                    raise ValueError("candidate rows must be non-decreasing")
                ranges = split_waves(enc, r_)
            for a, b in ranges:
                with trace.span("devctx.blob"):
                    used, first = np.unique(r_[a:b], return_index=True)
                    roff = np.append(first, b - a).astype(np.int32)
                    blob, E = build_blob(enc, self.mode, l_[a:b], p_[a:b],
                                         used, roff)
                yield blob, b - a, len(used), E

    def extend_async(self, enc: EncodedBatch, loc, plane, row) -> List[_Wave]:
        """Upload and launch every wave without waiting for the device."""
        t0 = time.time()
        cuda = self.device.type == "cuda"
        gap = self.params.gap
        waves = []
        for blob, C, U, E in self.wave_blobs(enc, loc, plane, row):
            self.up_bytes += blob.nbytes
            self.up_waves += 1
            self.up_cand_max = max(self.up_cand_max, C)
            shape = dict(mode=self.mode, W=enc.W, nw=self.nw, C=C, U=U, E=E)
            with torch.cuda.device(self.device) if cuda else nullcontext():
                dblob, staging = blob_to_device(blob, self.device)
                with trace.span("devctx.launch"):
                    if gap:
                        out = extend_gap_blob(self.ref32, dblob, gap=gap,
                                              **shape)
                    else:
                        out = (extend_counts_blob(self.ref32, dblob,
                                                  **shape),)
            self.down_bytes += sum(t.numel() * t.element_size() for t in out)
            waves.append(download(C, U, E, out, t0, (staging, dblob)))
        return waves

    # watchdog: a wave not done this multiple of its expected wall (the
    # measured cost_per_cand x C, floored by BASAL_TPU_WATCHDOG_MIN seconds,
    # default 3) after its wait began is declared stalled.  Armed once the
    # cost is measured and the first fetch (kernel build and load) is past;
    # BASAL_TPU_WATCHDOG=0 disables it.
    WATCHDOG_FACTOR = 8.0

    def watchdog_timeout(self, C: int) -> Optional[float]:
        """Seconds a wave of C candidates may take once its wait has begun,
        or None while the watchdog is unarmed or disabled."""
        cpc = self.cost_per_cand
        if (self._meas_skip or cpc is None
                or os.environ.get("BASAL_TPU_WATCHDOG", "1") in ("", "0")):
            return None
        return max(float(os.environ.get("BASAL_TPU_WATCHDOG_MIN") or 3),
                   self.WATCHDOG_FACTOR * cpc * max(C, 1))

    def _wait(self, w: _Wave):
        """Block until the wave's copies are done.  One ``query()`` when
        they already are; else poll (back-off up to 1 ms) until the
        watchdog's deadline, past which the stall is counted and raised.
        Unarmed, ``synchronize()``.  A CPU wave has no event."""
        if w.event is None or w.event.query():
            return
        timeout = self.watchdog_timeout(w.C)
        if timeout is None:
            w.event.synchronize()
            return
        deadline = time.monotonic() + timeout
        delay = 1e-5
        while not w.event.query():
            left = deadline - time.monotonic()
            if left <= 0:
                self.stalls += 1
                raise RuntimeError(
                    f"device wave stalled: C={w.C} U={w.U} E={w.E} "
                    f"gap={self.params.gap} not done after {timeout:.6g} s "
                    f"(watchdog {self.WATCHDOG_FACTOR:g} x cost_per_cand "
                    f"{self.cost_per_cand:.6g} s x C, floor "
                    f"BASAL_TPU_WATCHDOG_MIN); stall #{self.stalls}")
            time.sleep(min(delay, left))
            delay = min(2 * delay, 1e-3)

    def fetch(self, waves: List[_Wave]):
        """Wait for the waves; (counts, pos0, pos1) as int32 arrays over all
        of them, the position lists None when ungapped (the contract of
        basal_tpu's DeviceContext.fetch).  A wave that outlasts the watchdog
        raises RuntimeError; unlike basal_tpu's fetch, it is never evaluated
        on the host instead (see the class docstring)."""
        outs = []
        for w in waves:
            with trace.span("devctx.wait"):
                self._wait(w)
            outs.append([t.numpy().astype(np.int32) for t in w.out])
            if w.C >= 16384:
                if self._meas_skip:
                    self._meas_skip -= 1
                else:
                    self.meas_t += time.time() - w.t0
                    self.meas_n += w.C
        gap = self.params.gap
        if not outs:
            tails = [()] + ([(K_POS,), (2 * gap, K_POS)] if gap else [])
            outs = [[np.zeros((0,) + t, np.int32) for t in tails]]
        res = [np.concatenate(parts) for parts in zip(*outs)]
        return tuple(res) if gap else (res[0], None, None)

    def extend(self, enc: EncodedBatch, loc, plane, row):
        return self.fetch(self.extend_async(enc, loc, plane, row))


def device_context(ref: PackedReference, params: AlignParams,
                   device: torch.device) -> TorchDeviceContext:
    """The aligners' device context: a ShardedTorchDeviceContext over
    ``parallel.mesh.mesh_devices(device)`` when that lists more than one
    device and ``make_sharded_context`` takes them, else a
    TorchDeviceContext on ``device``."""
    from ..parallel.mesh import make_sharded_context, mesh_devices
    devices = mesh_devices(device)
    ctx = make_sharded_context(ref, params, devices) \
        if len(devices) > 1 else None
    return ctx if ctx is not None else TorchDeviceContext(ref, params,
                                                          device)


def host_eval_policy(device: torch.device, n_cands: int) -> bool:
    """True when a wave should run on the host evaluator: forced by
    BASAL_TPU_HOST_EVAL=0/1; in auto mode always on a CPU device (no
    accelerator to win), else above HOST_EVAL_MIN candidates."""
    mode = os.environ.get("BASAL_TPU_HOST_EVAL", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    if device.type == "cpu":
        return True
    return n_cands > HOST_EVAL_MIN


class TorchSingleEndAligner(SingleEndAligner):
    """SingleEndAligner whose device is a torch device: ``dev``,
    ``_fused_host`` and ``_host_eval_policy``, which ``align.aligner``
    leaves out, key on ``self.device``."""

    def __init__(self, params: AlignParams, ref: PackedReference, index,
                 use_native: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        super().__init__(params, ref, index, use_native)

    @property
    def dev(self) -> TorchDeviceContext:
        """Device context, created on first device dispatch: the sharded
        context when the aligner's device is CUDA and several cards are
        visible (``parallel.mesh``), else the single context.  Its creation,
        the reference's upload included, is a ``devctx.init`` span."""
        if self._dev is None:
            with trace.span("devctx.init"):
                self._dev = device_context(self.ref, self.p, self.device)
        return self._dev

    def _fused_host(self) -> bool:
        if os.environ.get("BASAL_TPU_FUSED", "1") in ("", "0"):
            return False
        mode = os.environ.get("BASAL_TPU_HOST_EVAL", "auto")
        if mode == "0":
            return False
        if self.p.gap > 0:
            return _inline_tail_enabled()
        if mode == "1" or self.device.type == "cpu":
            return True
        return self.measured_placement() == "host"

    def _host_eval_policy(self, n_cands: int) -> bool:
        if (os.environ.get("BASAL_TPU_HOST_EVAL", "auto") == "auto"
                and n_cands <= HOST_EVAL_MIN
                and self._dev is not None
                and self._dev.cost_per_cand is not None):
            placement = self.measured_placement()
            if placement is None:
                return n_cands >= 16384  # one measured host probe
            return placement == "host"
        return host_eval_policy(self.device, n_cands)


class TorchThreadedRunner(ThreadedRunner):
    """-p worker pool of port aligners (see
    ``align.aligner.ThreadedRunner``)."""

    def __init__(self, params, ref, index, n_workers: int, device):
        from concurrent.futures import ThreadPoolExecutor
        self.aligners = [TorchSingleEndAligner(params, ref, index,
                                               device=device)
                         for _ in range(n_workers)]
        nt = max(1, len(os.sched_getaffinity(0)) // n_workers)
        for a in self.aligners:
            a.nt_hint = nt
        self.pools = [ThreadPoolExecutor(1) for _ in range(n_workers)]
        self.n = n_workers
        self.i = 0


def run_single_end(params: AlignParams, ref_path: str, reads_path: str,
                   out_fh=None, command_line: str = "basal_tpu_torch",
                   log=lambda *a: None, timings: Optional[dict] = None,
                   device=None, index_factory=None):
    """Align ``reads_path`` against ``ref_path`` and write SAM bytes to
    ``out_fh``.  Returns the (first) aligner, whose ``stage`` counts where
    candidates were evaluated; with -p N its ``peers`` lists all N.

    ``index_factory(ref, params)`` replaces the dense seed index, as a
    multi-process run does with ``parallel.multihost.TorchRoutedSeedIndex``.
    ``BASAL_TPU_PROFILE=<dir>`` records the run under torch.profiler (the
    card's kernels and copies too on CUDA) with the port's own spans
    (``basal_tpu_torch.trace``) on the same timeline, and writes a Chrome
    trace, ``<dir>/basal_tpu_torch_<pid>.json``."""
    device = resolve_device(device)
    prof_dir = os.environ.get("BASAL_TPU_PROFILE")
    with profile_run(prof_dir, device), malloc_window():
        return _run_single_end(params, ref_path, reads_path, out_fh,
                               command_line, log, timings, device,
                               index_factory)


@contextmanager
def profile_run(prof_dir: Optional[str], device: torch.device):
    """torch.profiler and the span recorder around the block when
    ``prof_dir`` is set; the Chrome trace, the spans moved onto the
    profiler's clock through one ``trace.MARK`` event, is written when the
    block ends, also on an error.  A recorder already on (a caller's) is
    left on and keeps its records."""
    if not prof_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(prof_dir, exist_ok=True)
    own = not trace.enabled()
    if own:
        trace.enable()
    prof = profile(activities=acts)
    prof.start()
    with record_function(trace.MARK):
        t_mark = time.perf_counter()
    ok = False
    try:
        yield
        ok = True
    finally:
        prof.stop()
        spans = trace.snapshot()
        if own:
            trace.disable()
        path = os.path.join(prof_dir, f"basal_tpu_torch_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        try:
            trace.add_to_chrome_trace(path, spans, t_mark)
        except Exception as e:
            if ok:
                raise
            # the block's own error is the one to see
            print(f"basal_tpu_torch: the program's spans were not added to "
                  f"{path}: {e!r}", file=sys.stderr)


def _summary(log, reader, params, t0, counters, aligners):
    n_al, n_un, n_mu = counters
    n_reads = reader.index - params.read_start + 1
    n_total = max(n_reads, 1)
    log(f"total reads: {n_reads} \ttotal time: {time.time()-t0:.0f} secs")
    log(f"aligned reads: {n_al} ({100.0*n_al/n_total:.1f}%), "
        f"unique reads: {n_un} ({100.0*n_un/n_total:.1f}%), "
        f"non-unique reads: {n_mu} ({100.0*n_mu/n_total:.1f}%)")
    log(stage_report(aligners), 2)


def _run_single_end(params, ref_path, reads_path, out_fh, command_line, log,
                    timings, device, index_factory=None):
    t0 = time.time()
    with trace.span("index.reference_load"):
        ref = load_reference(ref_path, params)
    log(f"{ref.total_num} reference seqs loaded, total size {ref.sum_length} bp. "
        f"{time.time()-t0:.0f} secs passed")
    if timings is not None:
        timings["t_ref"] = time.time() - t0
    built = ""
    with trace.span("index.build"):
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
    reader = open_reads(reads_path, params, readset=0)

    def progress():
        log(f"{reader.index - params.read_start + 1} reads finished. "
            f"{time.time()-t0:.0f} secs passed")

    if params.num_threads > 1 and params.randseed != 0 and not params.rrbs_flag:
        from collections import deque
        runner = TorchThreadedRunner(params, ref, index, params.num_threads,
                                     device)
        futures = deque()
        while True:
            reads = reader.next_batch()
            if reads:
                futures.append(runner.submit(reads))
            while futures and (not reads or len(futures) > runner.n):
                out_fh.write(futures.popleft().result())
                progress()
            if not reads:
                break
        runner.shutdown()
        reader.close()
        _summary(log, reader, params, t0, runner.counters(), runner.aligners)
        runner.aligners[0].peers = runner.aligners
        return runner.aligners[0]

    aligner = TorchSingleEndAligner(params, ref, index, device=device)
    # two-deep pipeline: host encode/dispatch of batch k+1 overlaps batch
    # k's device work; the replay only blocks when it fetches.  With a
    # routed index, batch k+1's routing query is posted before batch k's
    # align (read-ahead, as basal_tpu's _run_single_end: the shard cache is
    # cumulative and the single-slot post blocks until batch k's own reply
    # is in, which makes routed_ready=True sound)
    pending = None
    if hasattr(index, "wait_batch"):
        reads_cur = reader.next_batch()
        enc_cur = aligner.encode_post(reads_cur) if reads_cur else None
        while reads_cur:
            reads_next = reader.next_batch()
            enc_next = (aligner.encode_post(reads_next)
                        if reads_next else None)
            if pending is not None:
                out_fh.write(aligner.finish_batch(pending))
                progress()
            pending = aligner.submit_batch(
                reads_cur, enc=enc_cur, routed_ready=enc_next is not None)
            reads_cur, enc_cur = reads_next, enc_next
        if pending is not None:
            out_fh.write(aligner.finish_batch(pending))
            progress()
    else:
        while True:
            reads = reader.next_batch()
            state = aligner.submit_batch(reads) if reads else None
            if pending is not None:
                out_fh.write(aligner.finish_batch(pending))
                progress()
            pending = state
            if state is None:
                break
    reader.close()
    _summary(log, reader, params, t0, aligner.stats(), [aligner])
    return aligner
