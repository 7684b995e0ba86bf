"""basal_tpu_torch — the base-conversion aligner on PyTorch and CUDA.

A port of ``basal_tpu`` to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper.  It imports nothing of ``basal_tpu`` and never imports jax:
it keeps its own copies of the framework-free host layers (config, index,
reads, candidates, replay, SAM, the C++ engine in ``native``, the BAM
writer in ``toolkit.bamio``), each module's docstring naming its original,
and owns what touches the device (``ops``, ``align.pipeline``,
``pairs.pipeline``, ``parallel``, ``cli``).

Importing the package pins glibc's malloc thresholds and turns numpy's
hugepage madvise off, as importing ``basal_tpu`` does: ``_tune_malloc``,
``_tune_numpy_thp`` and ``malloc_window`` are copied from
``basal_tpu/__init__.py`` at cb4d597, unchanged.
"""
__version__ = "0.1.0"


def _tune_malloc():
    """Keep large per-batch numpy buffers on the heap instead of fresh mmaps.

    The pipeline allocates multi-MB arrays (group tables, candidate/count
    buffers, encoder planes) per 25k-read batch.  glibc serves >128 KB
    allocations with mmap and munmaps them on free, so every batch re-pays
    page faults + kernel zeroing for hundreds of MB; glibc's *dynamic*
    threshold adapts only slowly (measured on the bench host: passes warm
    34k -> 82k -> 156k reads/s as the threshold creeps up).  Pinning
    M_MMAP_THRESHOLD/M_TRIM_THRESHOLD at 32 MB — glibc's own
    DEFAULT_MMAP_THRESHOLD_MAX, i.e. the dynamic steady state, reached
    instantly instead of over ~600k reads — makes the first pass run at
    steady-state speed.  Buffers >= 32 MB (group tables, repeat-profile
    candidate tails) still mmap and return to the OS each batch.  A 256 MB
    pin was tried first and measured FASTER on single-config runs (265k
    vs 224k warm) but fragments the main arena in long mixed-workload
    processes — tools/configbench.py degraded 4x by its fifth config —
    so the conservative pin stands.  BASAL_TPU_NO_MALLOC_TUNE=1 disables;
    explicit MALLOC_*_THRESHOLD_ env vars take precedence (glibc reads
    them first and mallopt here would override, so we skip if either is
    set)."""
    import ctypes
    import os
    if os.environ.get("BASAL_TPU_NO_MALLOC_TUNE") == "1":
        return
    if ("MALLOC_MMAP_THRESHOLD_" in os.environ
            or "MALLOC_TRIM_THRESHOLD_" in os.environ):
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        thr = 32 << 20
        libc.mallopt(ctypes.c_int(M_MMAP_THRESHOLD), ctypes.c_int(thr))
        libc.mallopt(ctypes.c_int(M_TRIM_THRESHOLD), ctypes.c_int(thr))
    except Exception:
        pass  # non-glibc platforms: the tune is an optimization only


_tune_malloc()


def _tune_numpy_thp():
    """Stop numpy from MADV_HUGEPAGE-ing every >= 4 MB buffer.

    On this virtualized host the FIRST touch of a newly host-backed 2 MiB
    extent costs ~44 ms (hypervisor-side backing/zeroing; measured 0.05
    GB/s vs 0.7-2 GB/s for 4 KiB first-touch — a 20-40x per-byte gap).
    numpy madvises THP on all large allocations by default, so every
    growth of the process footprint (the three 43M-slot seed-index tables
    above all: cold 2 Mbp index build measured 8.2 s wall / 29 s system
    time, 0.38 s with this tune), and every fresh worker process, paid it.
    The gather-TLB benefit THP provides is preserved where it matters: the
    pipeline MADV_COLLAPSEs the gather-hot index tables AFTER the fill
    (pipeline.THP_AFTER_READS / bench collapse_now), which never takes the
    slow first-touch path.  Also exports NUMPY_MADVISE_HUGEPAGE=0 so
    spawned workers (multihost, ThreadedRunner subprocesses, oracle-paired
    benches) inherit the tune even though their numpy imports fresh.
    BASAL_TPU_NO_THP_TUNE=1 disables both; an explicit
    NUMPY_MADVISE_HUGEPAGE in the environment takes precedence."""
    import os
    if os.environ.get("BASAL_TPU_NO_THP_TUNE") == "1":
        return
    if "NUMPY_MADVISE_HUGEPAGE" in os.environ:
        return  # user decided; numpy already honored it at import
    os.environ["NUMPY_MADVISE_HUGEPAGE"] = "0"  # for child processes
    try:
        try:
            from numpy._core import _multiarray_umath as _mu  # numpy >= 2
        except ImportError:  # pragma: no cover - numpy 1.x fallback
            from numpy.core import _multiarray_umath as _mu
        _mu._set_madvise_hugepage(False)
    except Exception:
        pass  # private API moved: the env var still covers children


_tune_numpy_thp()


class malloc_window:
    """Raise the malloc mmap/trim thresholds to 256 MB for the duration of
    ONE aligner run, then trim the arena and restore the conservative
    32 MB pin.  Within a single run the allocation sizes are repetitive
    (one config), so the big per-batch buffers (group tables,
    repeat-profile candidate ladders — up to hundreds of MB) recycle in
    the heap without the cross-config fragmentation that made a permanent
    256 MB pin degrade mixed-workload processes (see _tune_malloc);
    malloc_trim at exit returns the arena to the OS between runs.
    No-op when the tune is disabled."""

    def __enter__(self):
        import ctypes
        import os
        self._on = (os.environ.get("BASAL_TPU_NO_MALLOC_TUNE") != "1"
                    and "MALLOC_MMAP_THRESHOLD_" not in os.environ
                    and "MALLOC_TRIM_THRESHOLD_" not in os.environ)
        if not self._on:
            return self
        try:
            self._libc = ctypes.CDLL(None)
            for opt in (-1, -3):  # M_TRIM_THRESHOLD, M_MMAP_THRESHOLD
                self._libc.mallopt(ctypes.c_int(opt),
                                   ctypes.c_int(256 << 20))
        except Exception:
            self._on = False
        return self

    def __exit__(self, *a):
        if not self._on:
            return
        try:
            for opt in (-1, -3):
                self._libc.mallopt(ctypes.c_int(opt),
                                   ctypes.c_int(32 << 20))
            self._libc.malloc_trim(0)
        except Exception:
            pass
