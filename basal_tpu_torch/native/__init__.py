"""ctypes loader for the native host engine (engine.cpp).

Compiles lazily with g++ into
``build/basal_tpu_torch/host/<hash of source and flags>/libbasal_engine.so``
at the root of the checkout, never into the package; falls back to the
pure-Python twins (align.candidates / align.replay) when no compiler is
available.  ``BASAL_TPU_NO_NATIVE=1`` forces the Python path (used by the
equivalence tests).

Copied from ``basal_tpu/native/__init__.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: the build location (``library_path``) and a
build under a lock into a pid-tagged temporary file that ``os.replace``
moves into place, so that concurrent processes may build at once.
``engine.cpp`` is a byte-identical copy of ``basal_tpu/native/engine.cpp``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "engine.cpp"
BUILD_ROOT = _DIR.parents[1] / "build" / "basal_tpu_torch" / "host"
_FLAGS = (("-O2", "-march=native"), ("-O2",))
_build_lock = threading.Lock()


def library_path() -> Path:
    """Where the engine is built: keyed by the source and the g++ flags."""
    h = hashlib.sha256(repr(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbasal_engine.so"


def _ncpu() -> int:
    """Usable core count — affinity-aware, so taskset/cgroup-restricted
    workers (multi-host processes pinned to disjoint core sets) size their
    thread pools to what they actually own."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1

_lib = None


def _build(so: Path) -> bool:
    err = None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    for flags in _FLAGS:
        try:
            subprocess.run(
                ["g++", *flags, "-shared", "-fPIC", "-std=c++17", str(_SRC),
                 "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
            return True
        except OSError as e:
            err = str(e)
        except subprocess.CalledProcessError as e:
            err = e.stderr.decode()[:2000]
        finally:
            tmp.unlink(missing_ok=True)
    # loud fallback: a silent engine-build failure would quietly route every
    # caller through the pure-Python twins (correct but ~100x slower)
    import sys
    print(f"[basal_tpu_torch.native] engine build FAILED, falling back to "
          f"Python twins:\n{err}", file=sys.stderr)
    return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("BASAL_TPU_NO_NATIVE"):
        return None
    with _build_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        return _load(so)


def _load(so: Path):
    global _lib
    lib = ctypes.CDLL(str(so))
    lib.bt_build_candidates.restype = ctypes.c_int64
    lib.bt_fill_groups.restype = ctypes.c_int64
    lib.bt_replay_se.restype = ctypes.c_int64
    lib.bt_replay_pe.restype = ctypes.c_int64
    lib.bt_encode_batch.restype = ctypes.c_int64
    lib.bt_format_se.restype = ctypes.c_int64
    lib.bt_format_pe.restype = ctypes.c_int64
    lib.bt_top_counts.restype = ctypes.c_int64
    lib.bt_unmask_blocks.restype = ctypes.c_int64
    lib.bt_build_candidates_rrbs.restype = ctypes.c_int64
    lib.bt_eval_candidates.restype = ctypes.c_int64
    lib.bt_eval_candidates_gap.restype = ctypes.c_int64
    lib.bt_fill_eval_groups.restype = ctypes.c_int64
    lib.bt_pack_ref.restype = ctypes.c_int64
    lib.bt_build_seed_index.restype = ctypes.c_int64
    lib.bt_build_groups_mt.restype = ctypes.c_int64
    lib.bt_align_se_host.restype = ctypes.c_int64
    lib.bt_scan_fastq.restype = ctypes.c_int64
    lib.bt_sam_to_bam.restype = ctypes.c_int64
    lib.bt_bam_to_sam.restype = ctypes.c_int64
    lib.bt_bam_reads.restype = ctypes.c_int64
    lib.bt_memset_mt.restype = None
    _lib = lib
    return lib


def bam_batch_reads(data: bytes, want: int, maxlen: int):
    """Bulk-decode up to ``want`` BAM read records into RawBatch-layout
    buffers via the C decoder.  Returns (nrec, consumed, buf, arrays) or
    None (native unavailable / 0xFF qual punt -> Python loop)."""
    lib = get_lib()
    if lib is None or not data:
        return None if lib is None else (0, 0, None, None)
    import numpy as np
    db = np.frombuffer(data, np.uint8)
    out = np.empty(3 * len(data) + 4096, np.uint8)
    noff = np.empty(want, np.int64)
    nlen = np.empty(want, np.int32)
    soff = np.empty(want, np.int64)
    slen = np.empty(want, np.int32)
    qoff = np.empty(want, np.int64)
    qlen = np.empty(want, np.int32)
    consumed = ctypes.c_int64(0)
    r = lib.bt_bam_reads(
        _p(db, ctypes.c_uint8), ctypes.c_int64(db.size),
        ctypes.c_int64(want), ctypes.c_int32(maxlen),
        _p(out, ctypes.c_uint8), ctypes.c_int64(out.size),
        _p(noff, ctypes.c_int64), _p(nlen, ctypes.c_int32),
        _p(soff, ctypes.c_int64), _p(slen, ctypes.c_int32),
        _p(qoff, ctypes.c_int64), _p(qlen, ctypes.c_int32),
        ctypes.byref(consumed))
    r = int(r)
    if r < 0:
        return None
    return (r, int(consumed.value), out,
            (noff[:r], nlen[:r], soff[:r], slen[:r], qoff[:r], qlen[:r]))


def bam_records_to_sam(data: bytes, ref_names):
    """Decode a raw BAM record stream (after the header/ref blocks) to SAM
    text bytes via the C decoder (engine.cpp:bt_bam_to_sam).  Returns None
    when the native engine is unavailable or the stream contains a float
    aux tag (Python repr formatting) — caller falls back to the Python
    decoder."""
    lib = get_lib()
    if lib is None:
        return None
    if not len(data):
        return b""
    import numpy as np
    try:
        names = b"".join(n.encode("latin1") for n in ref_names)
    except UnicodeEncodeError:
        return None  # exotic ref names: Python decoder handles them
    off = np.zeros(len(ref_names) + 1, np.int64)
    np.cumsum([len(n.encode("latin1")) for n in ref_names], out=off[1:])
    db = np.frombuffer(data, np.uint8)
    nb = (np.frombuffer(names, np.uint8) if names
          else np.zeros(1, np.uint8))
    cap = 4 * len(data) + 4096
    while True:
        out = np.empty(cap, np.uint8)
        w = lib.bt_bam_to_sam(
            _p(db, ctypes.c_uint8), ctypes.c_int64(db.size),
            _p(nb, ctypes.c_uint8), _p(off, ctypes.c_int64),
            ctypes.c_int32(len(ref_names)),
            _p(out, ctypes.c_uint8), ctypes.c_int64(out.size))
        if w == -1:
            cap *= 2
            continue
        if w < 0:
            return None
        return out[:int(w)].tobytes()


def sam_records_to_bam(text: bytes, ref_names):
    """Encode '\\n'-separated SAM record lines (no header) into BAM record
    bytes via the C encoder (engine.cpp:bt_sam_to_bam).  Returns None when
    the native engine is unavailable or the chunk contains something the C
    encoder punts on (float aux, >64 cigar ops) — caller falls back to the
    Python encoder."""
    lib = get_lib()
    if lib is None or not text:
        return None if lib is None else b""
    import numpy as np
    names = b"".join(n.encode("latin1") for n in ref_names)
    off = np.zeros(len(ref_names) + 1, np.int64)
    np.cumsum([len(n.encode("latin1")) for n in ref_names], out=off[1:])
    tb = np.frombuffer(text, np.uint8)
    nb = (np.frombuffer(names, np.uint8) if names
          else np.zeros(1, np.uint8))
    out = np.empty(2 * len(text) + 4096, np.uint8)
    w = lib.bt_sam_to_bam(
        _p(tb, ctypes.c_uint8), ctypes.c_int64(tb.size),
        _p(nb, ctypes.c_uint8), _p(off, ctypes.c_int64),
        ctypes.c_int32(len(ref_names)),
        _p(out, ctypes.c_uint8), ctypes.c_int64(out.size))
    if w < 0:
        return None
    return out[:int(w)].tobytes()


def native_encode(params, chars, map_len, W, n_threads=0, seq_off=None,
                  lmax=None, want_ncnt=False):
    """C++ twin of the plane-packing + seed-array half of encode_batch.
    ``chars`` is either a dense [B, lmax] matrix (seq_off None) or the raw
    chunk buffer with per-read byte offsets ``seq_off`` (zero-string path).
    Returns (base, valid, mread, lenmask [2B, W] u32, seedval, has_n
    [B, 2, S][, ncnt i32[B] when want_ncnt])."""
    lib = get_lib()
    if lib is None:
        return None
    if seq_off is None:
        B, lmax = chars.shape
    else:
        B = len(seq_off)
        assert lmax is not None
    S = lmax - params.seed_size + 1
    if S <= 0:
        return None
    rule = params.rule
    base = np.empty((2 * B, W), np.uint32)
    valid = np.empty((2 * B, W), np.uint32)
    mread = np.empty((2 * B, W), np.uint32)
    lenmask = np.empty((2 * B, W), np.uint32)
    seedval = np.empty((B, 2, S), np.uint32)
    has_n = np.empty((B, 2, S), np.uint8)
    ncnt = np.empty(B, np.int32) if want_ncnt else None
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    from ..config import REG_ALPHABET
    soff = (np.ascontiguousarray(seq_off, np.int64)
            if seq_off is not None else None)
    lib.bt_encode_batch(
        ctypes.c_int32(B), ctypes.c_int32(lmax), ctypes.c_int32(W),
        ctypes.c_int32(params.seed_size),
        ctypes.c_int32(1 if params.nt3 else 0),
        _p(np.ascontiguousarray(chars), ctypes.c_uint8),
        _p(soff, ctypes.c_int64),
        _p(np.ascontiguousarray(map_len, ), ctypes.c_int32),
        _p(rule.alphabet, ctypes.c_uint8), _p(rule.rev_alphabet, ctypes.c_uint8),
        _p(rule.alphabet_mread, ctypes.c_uint8),
        _p(rule.rev_alphabet_mread, ctypes.c_uint8),
        _p(REG_ALPHABET, ctypes.c_uint8),
        _p(base, ctypes.c_uint32), _p(valid, ctypes.c_uint32),
        _p(mread, ctypes.c_uint32), _p(lenmask, ctypes.c_uint32),
        _p(seedval, ctypes.c_uint32), _p(has_n, ctypes.c_uint8),
        _p(ncnt, ctypes.c_int32),
        ctypes.c_int32(n_threads))
    out = (base, valid, mread, lenmask, seedval, has_n)
    return out + (ncnt,) if want_ncnt else out


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t)) if a is not None else None


def madvise_hugepage(arr: np.ndarray) -> None:
    """MADV_HUGEPAGE the array's pages (best-effort).  The seed-index
    tables (3^16 slots, ~170-340 MB each) are gathered at random per seed
    probe; with 4 KiB pages nearly every gather is also a TLB miss, which
    measured as the dominant cost of seed scheduling.  2 MiB pages drop
    the whole table to <200 TLB entries.

    DEFAULT OFF (opt in with ``BASAL_TPU_HUGEPAGE=1``): on this build's
    virtualized host, first-touch faults of madvised extents run ~6x
    slower end-to-end (84 s vs 14 s whole PE run, same contention window;
    ``compact_stall`` stayed 0, so the cost is hypervisor-side, not kernel
    compaction) and the post-AVX-512 align phase no longer shows a
    measurable TLB win.  On bare metal with cheap THP faults the advice
    is a real win for the gather-heavy scan — hence the env gate rather
    than removal."""
    if os.environ.get("BASAL_TPU_HUGEPAGE", "0") != "1":
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        page = 4096
        addr = arr.ctypes.data
        end = addr + arr.nbytes
        start = (addr + page - 1) & ~(page - 1)
        if end - start >= (2 << 20):
            libc.madvise(ctypes.c_void_p(start),
                         ctypes.c_size_t(end - start),
                         ctypes.c_int(14))  # MADV_HUGEPAGE
    except Exception:  # noqa: BLE001 - purely advisory
        pass


def madvise_collapse(arr: np.ndarray) -> bool:
    """Synchronously collapse an ALREADY-POPULATED array's pages into
    transparent hugepages (MADV_COLLAPSE, Linux >= 6.1).  Unlike
    MADV_HUGEPAGE (which only affects future faults — and on this
    virtualized host made first-touch ~6x slower, see madvise_hugepage),
    collapse happens after the fill, so the build path never pays slow THP
    faults.  Still expensive (~30 ms/2 MiB page hypervisor-side here, ~5 s
    per 172 MB table), so callers run it on a background thread once a run
    has proven long enough to amortize it (pipeline THP_AFTER_READS).

    Why: the seed-index tables (3^16 slots, 170-340 MB each) are gathered
    at random per seed probe; with 4 KiB pages nearly every gather is also
    a TLB miss — measured ~40% of bt_build_groups_mt wall on the random
    bench profile.  2 MiB pages drop a table to <200 TLB entries.
    """
    if arr.nbytes < (32 << 20):
        return False  # small tables fit the TLB already
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        page = 4096
        addr = arr.ctypes.data
        end = (addr + arr.nbytes) & ~(page - 1)
        start = (addr + page - 1) & ~(page - 1)
        if end - start < (2 << 20):
            return False
        return libc.madvise(ctypes.c_void_p(start),
                            ctypes.c_size_t(end - start),
                            ctypes.c_int(25)) == 0  # MADV_COLLAPSE
    except Exception:  # noqa: BLE001 - purely advisory
        return False


def collapse_index_tables(index, ref=None) -> int:
    """MADV_COLLAPSE the gather-hot tables of a seed index (+ reference
    planes).  Returns the number of arrays collapsed.  Safe concurrently
    with readers (the kernel remaps atomically; gathers see brief stalls).
    Order = measured gather volume: counts (~80/read in seed scheduling)
    before starts/n1/locs (~8-9/read in fill_eval)."""
    done = 0
    for name in ("counts", "starts", "n1", "locs"):
        a = getattr(index, name, None)
        if isinstance(a, np.ndarray):
            done += bool(madvise_collapse(a))
    if ref is not None:
        a = getattr(ref, "ref32", None)
        if isinstance(a, np.ndarray):
            done += bool(madvise_collapse(a))
    return done


def native_available() -> bool:
    return get_lib() is not None


class NativeBatch:
    """Native twin of build_candidates + Replayer.replay_batch for SE."""

    def __init__(self, params, index, ref):
        self.p = params
        self.index = index
        self.ref = ref
        self.profile = params.profile().astype(np.int64)
        self.state = np.zeros(2, dtype=np.int32)  # xseed_start_offset
        # persistent stale seed buffers (reference xseed_array /
        # xseedreg_array twins, align.h:90 — see STALE_N in engine.cpp):
        # entry k = seed/has-N of the last unfiltered chain-enabled read
        # with L - s >= k; zeros before first touch (the oracle's heap
        # pages arrive zeroed)
        self.seed_state = np.zeros((2, 480), dtype=np.uint32)
        self.reg_state = np.zeros((2, 480), dtype=np.uint8)
        self.anchors = ref.ref_anchor[:ref.total_num].astype(np.int64)
        self.rc_off = np.array([t.rc_offset for t in ref.titles], np.int64)
        self.sizes = np.array([t.size for t in ref.titles], np.int64)

    def _common_args(self, enc, read_indices):
        p = self.p
        B = len(enc.reads)
        S = enc.seedval.shape[-1] if enc.seedval.size else 1
        sv = getattr(enc, "_sv_cache", None)
        if sv is None:
            sv = np.ascontiguousarray(enc.seedval.reshape(B * 2, -1),
                                      np.uint32)
            enc._sv_cache = sv  # reused by fill_groups for THIS batch;
            # caching on enc (not self) keeps the overlapped pipeline safe:
            # batch k+1's build_groups must not clobber the seed values
            # batch k's ladder waves still materialize from
        hn = np.ascontiguousarray(enc.seed_has_n.reshape(B * 2, -1), np.uint8)
        xf = np.ascontiguousarray(enc.xflag_chain, np.uint8)
        flt = np.ascontiguousarray(enc.filtered, np.uint8)
        ridx = np.ascontiguousarray(read_indices, np.uint32)
        self._keep = (sv, hn, xf, flt, ridx)
        return [
            ctypes.c_int32(B), ctypes.c_int32(S if S else 1),
            _p(sv, ctypes.c_uint32), _p(hn, ctypes.c_uint8),
            _p(enc.n_offsets, ctypes.c_int32), _p(enc.map_len, ctypes.c_int32),
            _p(enc.seedseg_num, ctypes.c_int32), _p(xf, ctypes.c_uint8),
            _p(flt, ctypes.c_uint8), _p(ridx, ctypes.c_uint32),
            _p(self.index.starts, ctypes.c_int64),
            _p(self.index.counts, ctypes.c_int32),
            _p(self.index.n1, ctypes.c_int32),
            _p(self.index.locs, ctypes.c_uint32),
            ctypes.c_int32(p.index_interval), ctypes.c_int32(p.seed_size),
            ctypes.c_int64(self.index.max_kmer_num),
            ctypes.c_uint32(p.randseed),
            _p(self.profile, ctypes.c_int64),
            ctypes.c_int64(self.profile.shape[1]),
        ], sv

    def build_candidates(self, enc, read_indices):
        lib = get_lib()
        B = len(enc.reads)
        args_common, sv = self._common_args(enc, read_indices)
        ng = ctypes.c_int64(0)
        state0 = self.state.copy()
        sst0 = self.seed_state.copy()
        rst0 = self.reg_state.copy()
        need = lib.bt_build_candidates(
            *args_common, _p(self.state, ctypes.c_int32),
            _p(self.seed_state, ctypes.c_uint32),
            _p(self.reg_state, ctypes.c_uint8), ctypes.c_int32(0),
            None, None, None, None, None, ctypes.byref(ng))
        self.state[:] = state0  # pass 2 must see the same initial state
        self.seed_state[:] = sst0
        self.reg_state[:] = rst0
        C = int(need)
        NG = int(ng.value)
        cand_loc = np.empty(C, np.int32)
        cand_plane = np.empty(C, np.int8)
        cand_row = np.empty(C, np.int32)
        groups = np.empty((NG, 10), np.int64)
        goff = np.empty(B + 1, np.int64)
        lib.bt_build_candidates(
            *args_common, _p(self.state, ctypes.c_int32),
            _p(self.seed_state, ctypes.c_uint32),
            _p(self.reg_state, ctypes.c_uint8), ctypes.c_int32(1),
            _p(cand_loc, ctypes.c_int32), _p(cand_plane, ctypes.c_int8),
            _p(cand_row, ctypes.c_int32),
            _p(groups, ctypes.c_int64), _p(goff, ctypes.c_int64),
            ctypes.byref(ng))
        return cand_loc, cand_plane, cand_row, groups, goff

    def build_groups(self, enc, read_indices):
        """Lazy variant: group table + per-read offsets only, candidate
        arrays materialized later per wave via fill_groups.  Single pass —
        the group count is bounded by sum(seedseg) * 2 chains * I probes."""
        lib = get_lib()
        p = self.p
        B = len(enc.reads)
        args_common, sv = self._common_args(enc, read_indices)
        ng = ctypes.c_int64(0)
        ub = int(2 * p.index_interval * int(enc.seedseg_num.sum())) + 1
        groups = np.empty((ub, 10), np.int64)
        goff = np.empty(B + 1, np.int64)
        total = lib.bt_build_groups_mt(
            *args_common, _p(self.state, ctypes.c_int32),
            _p(self.seed_state, ctypes.c_uint32),
            _p(self.reg_state, ctypes.c_uint8),
            _p(groups, ctypes.c_int64), _p(goff, ctypes.c_int64),
            ctypes.byref(ng),
            ctypes.c_int32(min(_ncpu(), 8)))
        del sv  # fill_groups re-reads it from enc._sv_cache (per-batch)
        return groups[:int(ng.value)], goff, int(total)

    def align_se_host(self, enc, read_indices, ref, n_threads=0):
        """Fused single-pass SE host alignment (bt_align_se_host): seed
        scheduling + group build + full visit-time scan in one cache-hot
        C++ pass.  Returns (replay-result tuple, n_enumerated, n_evaluated).
        Exact semantics of build_groups + fill_eval_groups/inline replay;
        the split pipeline remains the golden twin (tests compare both)."""
        lib = get_lib()
        p = self.p
        B = len(enc.reads)
        if n_threads <= 0:
            n_threads = min(_ncpu(), 8)
        args_common, sv = self._common_args(enc, read_indices)
        ev = self._eval_args(enc, True)
        # drop the locs slot (the fused entry reuses the index locs arg)
        ev = ev[:8] + ev[9:]
        out_stratum = np.empty(B, np.int32)
        out_n0 = np.empty(B, np.int32)
        out_n1 = np.empty(B, np.int32)
        ncand = np.zeros(2, np.int64)
        hit_cap = max(B * 8, 4096)
        state0 = self.state.copy()
        sst0 = self.seed_state.copy()
        rst0 = self.reg_state.copy()
        while True:
            hit_chr = np.empty(hit_cap, np.int32)
            hit_loc = np.empty(hit_cap, np.int32)
            hit_gsz = np.empty(hit_cap, np.int32)
            hit_gpos = np.empty(hit_cap, np.int32)
            hit_chain = np.empty(hit_cap, np.uint8)
            hoff = np.empty(B + 1, np.int64)
            ncand[:] = 0
            rc = lib.bt_align_se_host(
                *args_common, _p(self.state, ctypes.c_int32),
                _p(self.seed_state, ctypes.c_uint32),
                _p(self.reg_state, ctypes.c_uint8),
                _p(self.anchors, ctypes.c_int64),
                ctypes.c_int32(len(self.anchors)),
                _p(self.rc_off, ctypes.c_int64),
                _p(self.sizes, ctypes.c_int64),
                _p(enc.read_max_snp, ctypes.c_int32),
                ctypes.c_int32(p.seed_size), ctypes.c_int32(p.gap),
                ctypes.c_int32(p.gap_edge), ctypes.c_int32(p.max_num_hits),
                ctypes.c_int32(1 if p.nt3 else 0),
                *ev,
                _p(out_stratum, ctypes.c_int32), _p(out_n0, ctypes.c_int32),
                _p(out_n1, ctypes.c_int32),
                ctypes.c_int64(hit_cap),
                _p(hit_chr, ctypes.c_int32), _p(hit_loc, ctypes.c_int32),
                _p(hit_gsz, ctypes.c_int32), _p(hit_gpos, ctypes.c_int32),
                _p(hit_chain, ctypes.c_uint8), _p(hoff, ctypes.c_int64),
                _p(ncand, ctypes.c_int64),
                ctypes.c_int32(n_threads))
            if rc == 0:
                break
            # retry with a larger hit buffer: the scheduler state was
            # mutated by the failed pass — restore the snapshot first
            self.state[:] = state0
            self.seed_state[:] = sst0
            self.reg_state[:] = rst0
            hit_cap *= 4
        res = (out_stratum, out_n0, out_n1,
               hit_chr, hit_loc, hit_gsz, hit_gpos, hit_chain, hoff)
        return res, int(ncand[0]), int(ncand[1])

    def fill_groups(self, enc, groups, sel, off, base=0):
        """Materialize candidate arrays for the selected group indices,
        writing compact offsets into ``off`` (int64 [ngroups]).  The seed is
        resolved at build time (groups[:, 9] = starts[seed]) so no seedval
        access happens here — stale-path groups stay exact."""
        lib = get_lib()
        sel = np.ascontiguousarray(sel, np.int64)
        total = lib.bt_fill_groups(
            _p(groups, ctypes.c_int64), _p(sel, ctypes.c_int64),
            ctypes.c_int64(len(sel)),
            _p(self.index.locs, ctypes.c_uint32),
            ctypes.c_int32(0), ctypes.c_int64(base),
            None, None, None, None)
        C = int(total)
        loc = np.empty(C, np.int32)
        plane = np.empty(C, np.int8)
        row = np.empty(C, np.int32)
        lib.bt_fill_groups(
            _p(groups, ctypes.c_int64), _p(sel, ctypes.c_int64),
            ctypes.c_int64(len(sel)),
            _p(self.index.locs, ctypes.c_uint32),
            ctypes.c_int32(1), ctypes.c_int64(base),
            _p(loc, ctypes.c_int32), _p(plane, ctypes.c_int8),
            _p(row, ctypes.c_int32), _p(off, ctypes.c_int64))
        return loc, plane, row

    def fill_eval_groups(self, enc, ref, groups, sel, off, base,
                         loc_out, cnt_out, n_threads=0):
        """Fused wave materialize + ungapped host evaluation: writes
        candidate locs into ``loc_out`` and clamped i32 counts into
        ``cnt_out`` (contiguous views sized by groups[sel, 6].sum()), and
        compact offsets into ``off``.  One pass per candidate instead of
        fill -> copy -> eval."""
        lib = get_lib()
        p = self.p
        sel = np.ascontiguousarray(sel, np.int64)
        mode = {"oneway": 0, "multiway": 1, "nt3": 2}[
            "nt3" if p.nt3 else
            ("oneway" if p.rule.one_way else "multiway")]
        if n_threads <= 0:
            n_threads = min(_ncpu(), 8)
        ncnt = getattr(enc, "_ncnt2_cache", None)
        if ncnt is None:
            ncnt = np.ascontiguousarray(np.repeat(enc.n_count, 2), np.int32)
            enc._ncnt2_cache = ncnt
        assert loc_out.flags.c_contiguous and cnt_out.flags.c_contiguous
        return lib.bt_fill_eval_groups(
            _p(groups, ctypes.c_int64), _p(sel, ctypes.c_int64),
            ctypes.c_int64(len(sel)),
            _p(self.index.locs, ctypes.c_uint32),
            ctypes.c_int64(base),
            ref.ref32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(ref.ref32.shape[1]),
            _p(enc.base, ctypes.c_uint32), _p(enc.valid, ctypes.c_uint32),
            _p(enc.mread, ctypes.c_uint32), _p(ncnt, ctypes.c_int32),
            ctypes.c_int32(enc.W), ctypes.c_int32(mode),
            _p(loc_out, ctypes.c_int32), _p(cnt_out, ctypes.c_int32),
            _p(off, ctypes.c_int64), ctypes.c_int32(n_threads))

    def _eval_args(self, enc, enable):
        """ctypes args for the scan's on-demand candidate evaluation (see
        EvalCtx in engine.cpp); all-null when disabled."""
        if not enable:
            return [None, ctypes.c_int64(0), None, None, None, None,
                    ctypes.c_int32(0), ctypes.c_int32(0), None, None, None]
        p = self.p
        B = len(enc.reads)
        mode = {"oneway": 0, "multiway": 1, "nt3": 2}[
            "nt3" if p.nt3 else
            ("oneway" if p.rule.one_way else "multiway")]
        ncnt = getattr(enc, "_ncnt2_cache", None)
        if ncnt is None:
            ncnt = np.ascontiguousarray(np.repeat(enc.n_count, 2), np.int32)
            enc._ncnt2_cache = ncnt
        ml2 = getattr(enc, "_ml2_cache", None)
        if ml2 is None:
            ml2 = np.ascontiguousarray(np.repeat(enc.map_len, 2), np.int32)
            enc._ml2_cache = ml2
        self._ev_keep = (ncnt, ml2)
        ref32 = self.ref.ref32
        return [
            ref32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(ref32.shape[1]),
            _p(enc.base, ctypes.c_uint32), _p(enc.valid, ctypes.c_uint32),
            _p(enc.mread, ctypes.c_uint32), _p(ncnt, ctypes.c_int32),
            ctypes.c_int32(enc.W), ctypes.c_int32(mode),
            _p(self.index.locs, ctypes.c_uint32),
            # gapped visit-time: lazy MismatchPattern0/1 inputs
            _p(enc.lenmask, ctypes.c_uint32), _p(ml2, ctypes.c_int32)]

    def build_candidates_rrbs(self, enc, read_indices, rindex):
        """RRBS candidate build (bt_build_candidates_rrbs): returns
        (groups, goff, loc, plane i8, skip u8, row, n_cands).  Two passes
        with the stale seed buffers snapshotted/restored between them (the
        build mutates them per read, exactly like bt_build_candidates)."""
        lib = get_lib()
        B = len(enc.reads)
        args_common, sv = self._common_args(enc, read_indices)
        chrmode = np.ascontiguousarray(rindex.chrmode, np.uint32)
        self._keep_rrbs = chrmode
        ng = ctypes.c_int64(0)
        sst0 = self.seed_state.copy()
        rst0 = self.reg_state.copy()
        cap = lib.bt_build_candidates_rrbs(
            *args_common,
            _p(self.state, ctypes.c_int32),
            _p(self.seed_state, ctypes.c_uint32),
            _p(self.reg_state, ctypes.c_uint8),
            _p(chrmode, ctypes.c_uint32), _p(self.anchors, ctypes.c_int64),
            ctypes.c_int32(0), None, None, None, None, None, None,
            ctypes.byref(ng))
        n_groups = int(ng.value)
        groups = np.empty((max(n_groups, 1), 10), np.int64)
        goff = np.empty(B + 1, np.int64)
        loc = np.empty(max(cap, 1), np.int32)
        plane = np.empty(max(cap, 1), np.int8)
        skip = np.empty(max(cap, 1), np.uint8)
        row = np.empty(max(cap, 1), np.int32)
        self.seed_state[:] = sst0
        self.reg_state[:] = rst0
        ng2 = ctypes.c_int64(0)
        lib.bt_build_candidates_rrbs(
            *args_common,
            _p(self.state, ctypes.c_int32),
            _p(self.seed_state, ctypes.c_uint32),
            _p(self.reg_state, ctypes.c_uint8),
            _p(chrmode, ctypes.c_uint32), _p(self.anchors, ctypes.c_int64),
            ctypes.c_int32(1),
            _p(loc, ctypes.c_int32), _p(plane, ctypes.c_int8),
            _p(skip, ctypes.c_uint8), _p(row, ctypes.c_int32),
            _p(groups, ctypes.c_int64), _p(goff, ctypes.c_int64),
            ctypes.byref(ng2))
        assert int(ng2.value) == n_groups
        return (groups[:n_groups], goff, loc[:cap], plane[:cap],
                skip[:cap], row[:cap], cap)

    def replay_se(self, enc, groups, goff, cand_loc, cand_plane,
                  counts_dev, pos0, pos1, mode_limit=99,
                  filtered_override=None, counts_off=None,
                  inline_eval=False, n_threads=0,
                  rr_plane=None, rr_skip=None):
        lib = get_lib()
        p = self.p
        B = len(enc.reads)
        if n_threads <= 0:
            n_threads = min(_ncpu(), 8)
        counts_dev = np.ascontiguousarray(counts_dev, np.int32)
        pos0c = np.ascontiguousarray(pos0, np.int32) if pos0 is not None else None
        pos1c = np.ascontiguousarray(pos1, np.int32) if pos1 is not None else None
        out_stratum = np.empty(B, np.int32)
        out_n0 = np.empty(B, np.int32)
        out_n1 = np.empty(B, np.int32)
        hit_cap = max(B * 8, 4096)
        while True:
            hit_chr = np.empty(hit_cap, np.int32)
            hit_loc = np.empty(hit_cap, np.int32)
            hit_gsz = np.empty(hit_cap, np.int32)
            hit_gpos = np.empty(hit_cap, np.int32)
            hit_chain = np.empty(hit_cap, np.uint8)
            hoff = np.empty(B + 1, np.int64)
            rc = lib.bt_replay_se(
                ctypes.c_int32(B),
                _p(groups, ctypes.c_int64), _p(goff, ctypes.c_int64),
                _p(counts_dev, ctypes.c_int32),
                _p(pos0c, ctypes.c_int32), _p(pos1c, ctypes.c_int32),
                _p(cand_loc, ctypes.c_int32), _p(cand_plane, ctypes.c_int8),
                _p(rr_plane, ctypes.c_int8), _p(rr_skip, ctypes.c_uint8),
                _p(self.anchors, ctypes.c_int64),
                ctypes.c_int32(len(self.anchors)),
                _p(self.rc_off, ctypes.c_int64), _p(self.sizes, ctypes.c_int64),
                _p(enc.map_len, ctypes.c_int32),
                _p(enc.read_max_snp, ctypes.c_int32),
                _p(enc.seedseg_num, ctypes.c_int32),
                _p(np.ascontiguousarray(
                    enc.filtered if filtered_override is None
                    else filtered_override, np.uint8), ctypes.c_uint8),
                ctypes.c_int32(p.seed_size), ctypes.c_int32(p.gap),
                ctypes.c_int32(p.gap_edge), ctypes.c_int32(p.max_num_hits),
                ctypes.c_int32(1 if p.nt3 else 0),
                ctypes.c_int32(mode_limit),
                _p(counts_off, ctypes.c_int64),
                *self._eval_args(enc, inline_eval),
                _p(out_stratum, ctypes.c_int32), _p(out_n0, ctypes.c_int32),
                _p(out_n1, ctypes.c_int32),
                ctypes.c_int64(hit_cap),
                _p(hit_chr, ctypes.c_int32), _p(hit_loc, ctypes.c_int32),
                _p(hit_gsz, ctypes.c_int32), _p(hit_gpos, ctypes.c_int32),
                _p(hit_chain, ctypes.c_uint8), _p(hoff, ctypes.c_int64),
                ctypes.c_int32(n_threads))
            if rc == 0:
                break
            hit_cap *= 4
        return (out_stratum, out_n0, out_n1,
                hit_chr, hit_loc, hit_gsz, hit_gpos, hit_chain, hoff)


def replay_pe(params, ref, enc_a, cand_a, res_a, enc_b, cand_b, res_b,
              mode_limit=99, counts_off_a=None, counts_off_b=None,
              filtered_a=None, filtered_b=None, index=None, n_threads=0,
              rr_a=None, rr_b=None):
    """C++ PE lockstep replay (bt_replay_pe).  Returns
    (paired, pair_cnt, pair_data, pair_offsets,
     (stat, n0, n1, hchr, hloc, hgsz, hgpos, hchain, hoff) x 2).
    With mode_limit, pairs that would scan modes >= limit report
    paired == -2 (ladder wave incomplete); counts_off_* map logical group
    offsets to compact per-wave buffers; filtered_* override the encoded
    filter flags (resolved reads are masked out on later waves)."""
    lib = get_lib()
    p = params
    B = len(enc_a.reads)
    anchors = ref.ref_anchor[:ref.total_num].astype(np.int64)
    rc_off = np.array([t.rc_offset for t in ref.titles], np.int64)
    sizes = np.array([t.size for t in ref.titles], np.int64)

    def prep(enc, cand, res, filt_ov):
        counts, pos0, pos1 = res
        return dict(
            groups=np.ascontiguousarray(cand[3], np.int64),
            goff=np.ascontiguousarray(cand[4], np.int64),
            counts=np.ascontiguousarray(counts, np.int32),
            pos0=(np.ascontiguousarray(pos0, np.int32)
                  if pos0 is not None else None),
            pos1=(np.ascontiguousarray(pos1, np.int32)
                  if pos1 is not None else None),
            loc=np.ascontiguousarray(cand[0], np.int32),
            map_len=enc.map_len, rms=enc.read_max_snp,
            seedseg=enc.seedseg_num,
            filt=np.ascontiguousarray(
                enc.filtered if filt_ov is None else filt_ov, np.uint8))

    A = prep(enc_a, cand_a, res_a, filtered_a)
    Bd = prep(enc_b, cand_b, res_b, filtered_b)
    coff_a = (np.ascontiguousarray(counts_off_a, np.int64)
              if counts_off_a is not None else None)
    coff_b = (np.ascontiguousarray(counts_off_b, np.int64)
              if counts_off_b is not None else None)

    # on-demand eval tables (groups left at counts_off -1 are evaluated at
    # visit time); enabled by passing the seed index
    ev_shared = [None, ctypes.c_int64(0), None, ctypes.c_int32(0)]
    ev_ends = {id(enc_a): [None] * 7, id(enc_b): [None] * 7}
    keep = []
    if index is not None:
        mode = {"oneway": 0, "multiway": 1, "nt3": 2}[
            "nt3" if p.nt3 else
            ("oneway" if p.rule.one_way else "multiway")]
        ev_shared = [
            ref.ref32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(ref.ref32.shape[1]),
            _p(index.locs, ctypes.c_uint32), ctypes.c_int32(mode)]
        for enc in (enc_a, enc_b):
            ncnt = getattr(enc, "_ncnt2_cache", None)
            if ncnt is None:
                ncnt = np.ascontiguousarray(np.repeat(enc.n_count, 2),
                                            np.int32)
                enc._ncnt2_cache = ncnt
            ml2 = getattr(enc, "_ml2_cache", None)
            if ml2 is None:
                ml2 = np.ascontiguousarray(np.repeat(enc.map_len, 2),
                                           np.int32)
                enc._ml2_cache = ml2
            keep.append((ncnt, ml2))
            ev_ends[id(enc)] = [
                _p(enc.base, ctypes.c_uint32),
                _p(enc.valid, ctypes.c_uint32),
                _p(enc.mread, ctypes.c_uint32), _p(ncnt, ctypes.c_int32),
                ctypes.c_int32(enc.W),
                _p(enc.lenmask, ctypes.c_uint32), _p(ml2, ctypes.c_int32)]
    else:
        z32 = ctypes.c_int32(0)
        for k in ev_ends:
            ev_ends[k] = [None, None, None, None, z32, None, None]

    pair_cap = max(B * 4, 4096)
    hit_cap = max(B * 8, 4096)
    while True:
        out_paired = np.empty(B, np.int32)
        out_pair_cnt = np.empty(B, np.int32)
        pair_data = np.empty((pair_cap, 12), np.int32)
        pair_offsets = np.empty(B + 1, np.int64)
        ends = []
        for _ in range(2):
            ends.append(dict(
                stat=np.empty(B, np.int32), n0=np.empty(B, np.int32),
                n1=np.empty(B, np.int32),
                hchr=np.empty(hit_cap, np.int32),
                hloc=np.empty(hit_cap, np.int32),
                hgsz=np.empty(hit_cap, np.int32),
                hgpos=np.empty(hit_cap, np.int32),
                hchain=np.empty(hit_cap, np.uint8),
                hoff=np.empty(B + 1, np.int64)))
        args = [ctypes.c_int32(B)]
        for D in (A, Bd):
            args += [_p(D["groups"], ctypes.c_int64),
                     _p(D["goff"], ctypes.c_int64),
                     _p(D["counts"], ctypes.c_int32),
                     _p(D["pos0"], ctypes.c_int32),
                     _p(D["pos1"], ctypes.c_int32),
                     _p(D["loc"], ctypes.c_int32),
                     _p(D["map_len"], ctypes.c_int32),
                     _p(D["rms"], ctypes.c_int32),
                     _p(D["seedseg"], ctypes.c_int32),
                     _p(D["filt"], ctypes.c_uint8)]
        args += [_p(anchors, ctypes.c_int64), ctypes.c_int32(len(anchors)),
                 _p(rc_off, ctypes.c_int64), _p(sizes, ctypes.c_int64),
                 ctypes.c_int32(p.seed_size), ctypes.c_int32(p.gap),
                 ctypes.c_int32(p.gap_edge), ctypes.c_int32(p.max_num_hits),
                 ctypes.c_int32(1 if p.nt3 else 0),
                 ctypes.c_int64(p.min_insert), ctypes.c_int64(p.max_insert),
                 ctypes.c_int32(mode_limit),
                 _p(coff_a, ctypes.c_int64), _p(coff_b, ctypes.c_int64),
                 *ev_shared, *ev_ends[id(enc_a)], *ev_ends[id(enc_b)],
                 _p(out_paired, ctypes.c_int32),
                 _p(out_pair_cnt, ctypes.c_int32),
                 ctypes.c_int64(pair_cap), _p(pair_data, ctypes.c_int32),
                 _p(pair_offsets, ctypes.c_int64)]
        for e in ends:
            args += [_p(e["stat"], ctypes.c_int32), _p(e["n0"], ctypes.c_int32),
                     _p(e["n1"], ctypes.c_int32)]
        args += [ctypes.c_int64(hit_cap)]
        for e in ends:
            args += [_p(e["hchr"], ctypes.c_int32), _p(e["hloc"], ctypes.c_int32),
                     _p(e["hgsz"], ctypes.c_int32), _p(e["hgpos"], ctypes.c_int32),
                     _p(e["hchain"], ctypes.c_uint8), _p(e["hoff"], ctypes.c_int64)]
        for rr in (rr_a, rr_b):  # RRBS per-candidate plane/skip
            if rr is None:
                args += [None, None]
            else:
                args += [_p(rr[0], ctypes.c_int8), _p(rr[1], ctypes.c_uint8)]
        args += [ctypes.c_int32(n_threads if n_threads > 0
                                else min(_ncpu(), 8))]
        rc = lib.bt_replay_pe(*args)
        if rc == 0:
            return out_paired, out_pair_cnt, pair_data, pair_offsets, ends
        pair_cap *= 4
        hit_cap *= 4


class NativeFormatter:
    """C++ SE SAM formatting (bt_format_se); format() returns the SAM
    body as BYTES (written verbatim to the binary output sink)."""

    def __init__(self, params, ref, rrbs_index=None):
        self.p = params
        self.ref = ref
        names = [t.name for t in ref.titles]
        self.title_buf = np.frombuffer("".join(names).encode("latin1"),
                                       np.uint8).copy()
        self.title_off = np.zeros(len(names) + 1, np.int64)
        np.cumsum([len(n) for n in names], out=self.title_off[1:])
        self.anchors = ref.ref_anchor.astype(np.int64)
        self.useful = np.frombuffer(
            params.rule.useful_nt.encode("latin1"), np.uint8).copy()
        from ..config import REV_CHAR
        self.rev_tab = REV_CHAR.copy()
        self.counters = np.zeros(3, np.int64)
        # RRBS: flattened per-chr-pair digestion-site CSR for the C++
        # CCGG_seglen twin (ZP/ZL tags)
        self.cc_pos = self.cc_rev = self.cc_off = None
        if rrbs_index is not None:
            off = [0]
            pos, rev = [], []
            for sites in rrbs_index.ccgg_sites:
                for s_, r_ in sites:
                    pos.append(s_)
                    rev.append(r_)
                off.append(len(pos))
            self.cc_pos = np.asarray(pos, np.int64)
            self.cc_rev = np.asarray(rev, np.int64)
            self.cc_off = np.asarray(off, np.int64)

    def format(self, enc, res, n_threads=0):
        lib = get_lib()
        p = self.p
        B = len(enc.reads)
        if n_threads <= 0:
            n_threads = min(_ncpu(), 8)
        (stratum, n0, n1, hchr, hloc, hgsz, hgpos, hchain, hoff) = res
        from ..reads.io import RawBatch
        if isinstance(enc.reads, RawBatch):
            rb = enc.reads
            nb = sb = qb = rb.buf
            name_off, name_len = rb.name_off, rb.name_len
            seq_off, seq_len = rb.seq_off, rb.seq_len
            qual_off, qual_len = rb.qual_off, rb.qual_len
            ridx = rb.indices
            rset = np.full(B, rb.readset, np.int32)
            total_seq = int(seq_len.sum())
        else:
            names = "".join(r.name for r in enc.reads)
            seqs = "".join(r.seq for r in enc.reads)
            quals = "".join(r.qual for r in enc.reads)
            name_len = np.array([len(r.name) for r in enc.reads], np.int32)
            seq_len = np.array([len(r.seq) for r in enc.reads], np.int32)
            qual_len = np.array([len(r.qual) for r in enc.reads], np.int32)
            name_off = np.zeros(B, np.int64)
            np.cumsum(name_len[:-1], out=name_off[1:])
            seq_off = np.zeros(B, np.int64)
            np.cumsum(seq_len[:-1], out=seq_off[1:])
            qual_off = np.zeros(B, np.int64)
            np.cumsum(qual_len[:-1], out=qual_off[1:])
            nb = np.frombuffer(names.encode("latin1"), np.uint8)
            sb = np.frombuffer(seqs.encode("latin1"), np.uint8)
            qb = np.frombuffer(quals.encode("latin1"), np.uint8)
            ridx = np.array([r.index for r in enc.reads], np.uint32)
            rset = np.array([r.readset for r in enc.reads], np.int32)
            total_seq = len(seqs)
        name_off = np.ascontiguousarray(name_off, np.int64)
        name_len = np.ascontiguousarray(name_len, np.int32)
        seq_off = np.ascontiguousarray(seq_off, np.int64)
        seq_len = np.ascontiguousarray(seq_len, np.int32)
        qual_off = np.ascontiguousarray(qual_off, np.int64)
        qual_len = np.ascontiguousarray(qual_len, np.int32)
        ridx = np.ascontiguousarray(ridx, np.uint32)
        cap = max(total_seq * 4 + B * 96, 1 << 20)
        while True:
            out = np.empty(cap, np.uint8)
            n = lib.bt_format_se(
                ctypes.c_int32(B),
                _p(nb, ctypes.c_uint8), _p(name_off, ctypes.c_int64),
                _p(name_len, ctypes.c_int32),
                _p(sb, ctypes.c_uint8), _p(seq_off, ctypes.c_int64),
                _p(seq_len, ctypes.c_int32),
                _p(qb, ctypes.c_uint8), _p(qual_off, ctypes.c_int64),
                _p(qual_len, ctypes.c_int32),
                _p(enc.map_len, ctypes.c_int32), _p(ridx, ctypes.c_uint32),
                _p(rset, ctypes.c_int32),
                _p(np.ascontiguousarray(stratum, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(n0, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(n1, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(hchr, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(hloc, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(hgsz, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(hgpos, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(hoff, np.int64), ctypes.c_int64),
                _p(self.title_buf, ctypes.c_uint8),
                _p(self.title_off, ctypes.c_int64),
                ctypes.c_int32(len(self.ref.titles)),
                self.ref.ref32[0].ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)),
                _p(self.anchors, ctypes.c_int64),
                _p(self.useful, ctypes.c_uint8),
                _p(self.rev_tab, ctypes.c_uint8),
                ctypes.c_uint32(p.randseed),
                ctypes.c_int32(p.report_repeat_hits),
                ctypes.c_int32(1 if p.out_unmap else 0),
                ctypes.c_int32(1 if p.out_ref else 0),
                _p(self.cc_pos, ctypes.c_int64),
                _p(self.cc_rev, ctypes.c_int64),
                _p(self.cc_off, ctypes.c_int64),
                _p(out, ctypes.c_uint8), ctypes.c_int64(cap),
                _p(self.counters, ctypes.c_int64),
                ctypes.c_int32(n_threads))
            if n >= 0:
                return out[:n].tobytes()
            cap = -n + 1024


def _read_slices(enc):
    """(name/seq/qual buffer + offsets/lengths, read indices, readsets,
    total_seq) for a batch — zero-copy for RawBatch, one join per plane
    for ReadRec lists (still ~100x cheaper than per-record Python
    formatting)."""
    from ..reads.io import RawBatch
    B = len(enc.reads)
    if isinstance(enc.reads, RawBatch):
        rb = enc.reads
        return (rb.buf, rb.name_off, rb.name_len,
                rb.buf, rb.seq_off, rb.seq_len,
                rb.buf, rb.qual_off, rb.qual_len,
                rb.indices, np.full(B, rb.readset, np.int32),
                int(rb.seq_len.sum()))
    names = "".join(r.name for r in enc.reads)
    seqs = "".join(r.seq for r in enc.reads)
    quals = "".join(r.qual for r in enc.reads)
    name_len = np.array([len(r.name) for r in enc.reads], np.int32)
    seq_len = np.array([len(r.seq) for r in enc.reads], np.int32)
    qual_len = np.array([len(r.qual) for r in enc.reads], np.int32)
    name_off = np.zeros(B, np.int64)
    np.cumsum(name_len[:-1], out=name_off[1:])
    seq_off = np.zeros(B, np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    qual_off = np.zeros(B, np.int64)
    np.cumsum(qual_len[:-1], out=qual_off[1:])
    nb = np.frombuffer(names.encode("latin1"), np.uint8)
    sb = np.frombuffer(seqs.encode("latin1"), np.uint8)
    qb = np.frombuffer(quals.encode("latin1"), np.uint8)
    ridx = np.array([r.index for r in enc.reads], np.uint32)
    rset = np.array([r.readset for r in enc.reads], np.int32)
    return (nb, name_off, name_len, sb, seq_off, seq_len,
            qb, qual_off, qual_len, ridx, rset, len(seqs))


class NativePairFormatter:
    """C++ PE SAM formatting (bt_format_pe) — the exact twin of
    PairEmitter (pairs/pipeline.py).  Returns None when the batch needs
    the Python path (FixPairReadName mismatch raises there with the exact
    reference message)."""

    def __init__(self, params, ref, rrbs_index=None):
        self.p = params
        self.ref = ref
        names = [t.name for t in ref.titles]
        self.title_buf = np.frombuffer("".join(names).encode("latin1"),
                                       np.uint8).copy()
        self.title_off = np.zeros(len(names) + 1, np.int64)
        np.cumsum([len(n) for n in names], out=self.title_off[1:])
        self.anchors = ref.ref_anchor.astype(np.int64)
        self.useful = np.frombuffer(
            params.rule.useful_nt.encode("latin1"), np.uint8).copy()
        from ..config import REV_CHAR
        self.rev_tab = REV_CHAR.copy()
        # [0..2] aligned/unique/multiple pairs; [3..8] per-end a/b
        self.counters = np.zeros(9, np.int64)
        # RRBS ZP/ZL fragment CSR (same layout as NativeFormatter)
        self.cc_pos = self.cc_rev = self.cc_off = None
        if rrbs_index is not None:
            off = [0]
            pos, rev = [], []
            for sites in rrbs_index.ccgg_sites:
                for s_, r_ in sites:
                    pos.append(s_)
                    rev.append(r_)
                off.append(len(pos))
            self.cc_pos = np.asarray(pos, np.int64)
            self.cc_rev = np.asarray(rev, np.int64)
            self.cc_off = np.asarray(off, np.int64)

    def format(self, enc_a, enc_b, paired, pdata, poff, ends, n_threads=0):
        lib = get_lib()
        p = self.p
        B = len(enc_a.reads)
        if n_threads <= 0:
            n_threads = min(_ncpu(), 8)
        args = [ctypes.c_int32(B)]
        total_seq = 0
        for enc, e in ((enc_a, ends[0]), (enc_b, ends[1])):
            (nb, noff, nlen, sb, soff, slen, qb, qoff, qlen,
             ridx, rset, tseq) = _read_slices(enc)
            total_seq += tseq
            args += [
                _p(nb, ctypes.c_uint8),
                _p(np.ascontiguousarray(noff, np.int64), ctypes.c_int64),
                _p(np.ascontiguousarray(nlen, np.int32), ctypes.c_int32),
                _p(sb, ctypes.c_uint8),
                _p(np.ascontiguousarray(soff, np.int64), ctypes.c_int64),
                _p(np.ascontiguousarray(slen, np.int32), ctypes.c_int32),
                _p(qb, ctypes.c_uint8),
                _p(np.ascontiguousarray(qoff, np.int64), ctypes.c_int64),
                _p(np.ascontiguousarray(qlen, np.int32), ctypes.c_int32),
                _p(enc.map_len, ctypes.c_int32),
                _p(np.ascontiguousarray(ridx, np.uint32), ctypes.c_uint32),
                _p(np.ascontiguousarray(rset, np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(enc.filtered, np.uint8),
                   ctypes.c_uint8),
                _p(np.ascontiguousarray(enc.read_max_snp, np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["stat"], np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["n0"], np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(e["n1"], np.int32), ctypes.c_int32),
                _p(np.ascontiguousarray(e["hchr"], np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["hloc"], np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["hgsz"], np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["hgpos"], np.int32),
                   ctypes.c_int32),
                _p(np.ascontiguousarray(e["hoff"], np.int64),
                   ctypes.c_int64),
            ]
        pdata = np.ascontiguousarray(pdata.reshape(-1), np.int32)
        args += [
            _p(np.ascontiguousarray(paired, np.int32), ctypes.c_int32),
            _p(pdata, ctypes.c_int32),
            _p(np.ascontiguousarray(poff, np.int64), ctypes.c_int64),
            _p(self.title_buf, ctypes.c_uint8),
            _p(self.title_off, ctypes.c_int64),
            ctypes.c_int32(len(self.ref.titles)),
            self.ref.ref32[0].ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32)),
            _p(self.anchors, ctypes.c_int64),
            _p(self.useful, ctypes.c_uint8),
            _p(self.rev_tab, ctypes.c_uint8),
            ctypes.c_uint32(p.randseed),
            ctypes.c_int32(p.report_repeat_hits),
            ctypes.c_int32(1 if p.out_unmap else 0),
            ctypes.c_int32(1 if p.out_ref else 0),
            _p(self.cc_pos, ctypes.c_int64),
            _p(self.cc_rev, ctypes.c_int64),
            _p(self.cc_off, ctypes.c_int64),
        ]
        cap = max(total_seq * 5 + B * 256, 1 << 20)
        while True:
            out = np.empty(cap, np.uint8)
            n = lib.bt_format_pe(*(args + [
                _p(out, ctypes.c_uint8), ctypes.c_int64(cap),
                _p(self.counters, ctypes.c_int64),
                ctypes.c_int32(n_threads)]))
            if n == -2:
                return None  # name mismatch: Python path raises exactly
            if n >= 0:
                return out[:n].tobytes()
            cap = -n + 1024


def native_top_counts(counts: np.ndarray, K: int) -> np.ndarray:
    """K largest values of the dense k-mer count table, descending (one
    C++ memory pass; the cutoff quantile lives ~21 slots from the top)."""
    lib = get_lib()
    out = np.empty(K, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    lib.bt_top_counts(_p(counts, ctypes.c_int32),
                      ctypes.c_int64(len(counts)), ctypes.c_int32(K),
                      _p(out, ctypes.c_int32))
    return out


def host_eval_candidates(params, ref, enc, loc, plane, row, n_threads=0):
    """C++ host evaluation of ungapped candidates (adaptive fallback when
    the device link can't absorb the candidate upload).  Returns u8 counts
    in candidate order."""
    lib = get_lib()
    mode = {"oneway": 0, "multiway": 1, "nt3": 2}[
        "nt3" if params.nt3 else
        ("oneway" if params.rule.one_way else "multiway")]
    C = loc.size
    out = np.empty(C, np.uint8)
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    nw = ref.ref32.shape[1]
    lib.bt_eval_candidates(
        ref.ref32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(nw),
        _p(np.ascontiguousarray(loc, np.int32), ctypes.c_int32),
        _p(np.ascontiguousarray(plane, np.int8), ctypes.c_int8),
        _p(np.ascontiguousarray(row, np.int32), ctypes.c_int32),
        ctypes.c_int64(C),
        _p(enc.base, ctypes.c_uint32), _p(enc.valid, ctypes.c_uint32),
        _p(enc.mread, ctypes.c_uint32),
        _p(np.ascontiguousarray(np.repeat(enc.n_count, 2), np.int32),
           ctypes.c_int32),
        ctypes.c_int32(enc.W), ctypes.c_int32(mode),
        _p(out, ctypes.c_uint8), ctypes.c_int32(n_threads))
    return out


def host_eval_candidates_gap(params, ref, enc, loc, plane, row, n_threads=0):
    """C++ host evaluation of GAPPED candidates: counts plus the mismatch
    position lists the gapped replay consumes (pos0 [C, KPOS] ascending
    read position; pos1 [C, 2*gap, KPOS] ascending distance-from-end per
    shifted window) — value-identical to the device kernel's gapped return
    (ops/extend.py).  KPOS = 14 = MAXSNPS - 1."""
    lib = get_lib()
    mode = {"oneway": 0, "multiway": 1, "nt3": 2}[
        "nt3" if params.nt3 else
        ("oneway" if params.rule.one_way else "multiway")]
    C = loc.size
    g2 = 2 * params.gap
    out = np.empty(C, np.uint8)
    pos0 = np.empty((C, 14), np.int32)
    pos1 = np.empty((C, g2, 14), np.int32)
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    nw = ref.ref32.shape[1]
    lib.bt_eval_candidates_gap(
        ref.ref32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(nw),
        _p(np.ascontiguousarray(loc, np.int32), ctypes.c_int32),
        _p(np.ascontiguousarray(plane, np.int8), ctypes.c_int8),
        _p(np.ascontiguousarray(row, np.int32), ctypes.c_int32),
        ctypes.c_int64(C),
        _p(enc.base, ctypes.c_uint32), _p(enc.valid, ctypes.c_uint32),
        _p(enc.mread, ctypes.c_uint32), _p(enc.lenmask, ctypes.c_uint32),
        _p(np.ascontiguousarray(np.repeat(enc.n_count, 2), np.int32),
           ctypes.c_int32),
        _p(np.ascontiguousarray(np.repeat(enc.map_len, 2), np.int32),
           ctypes.c_int32),
        ctypes.c_int32(enc.W), ctypes.c_int32(mode),
        ctypes.c_int32(params.gap),
        _p(out, ctypes.c_uint8), _p(pos0, ctypes.c_int32),
        _p(pos1, ctypes.c_int32), ctypes.c_int32(n_threads))
    return out, pos0, pos1


def native_pack_ref(chars, table, reverse=False, n_threads=0):
    """Fused alphabet-map + 2-bit pack of a reference plane (u8 chars ->
    u32 words, 16 bases/word, first base at bits 31:30).  ``reverse=True``
    packs the sequence back-to-front (RC plane).  len(chars) must be a
    multiple of 16."""
    lib = get_lib()
    chars = np.ascontiguousarray(chars, np.uint8)
    table = np.ascontiguousarray(table, np.uint8)
    out = np.empty(chars.size // 16, np.uint32)
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    lib.bt_pack_ref(
        _p(chars, ctypes.c_uint8), ctypes.c_int64(chars.size),
        _p(table, ctypes.c_uint8), ctypes.c_int32(1 if reverse else 0),
        _p(out, ctypes.c_uint32), ctypes.c_int32(n_threads))
    return out


def native_unmask_blocks(seq, useful_tab, nx_tab):
    """(begin[], end[]) of unmasked runs >= 16 bp — single C++ pass twin of
    index/reference.py::_unmask_region's transition scan (bt_unmask_blocks)."""
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, np.uint8)
    ut = np.ascontiguousarray(useful_tab, np.uint8)
    nt = np.ascontiguousarray(nx_tab, np.uint8)
    cap = 1 << 16
    while True:
        beg = np.empty(cap, np.int64)
        end = np.empty(cap, np.int64)
        m = lib.bt_unmask_blocks(
            _p(seq, ctypes.c_uint8), ctypes.c_int64(seq.size),
            _p(ut, ctypes.c_uint8), _p(nt, ctypes.c_uint8),
            _p(beg, ctypes.c_int64), _p(end, ctypes.c_int64),
            ctypes.c_int64(cap))
        if m >= 0:
            return beg[:m], end[:m]
        cap = -m + 16


def zeros_mt(n, dtype, n_threads=0):
    """np.zeros twin for large dense tables: np.empty + threaded sequential
    memset (bt_memset_mt).  np.zeros hands back lazily-faulted mmap zero
    pages, and a scatter fill then pays random-order first-touch faults
    (0.4-1.1s per 43M-slot table on this VM); pre-faulting sequentially is
    5-10x cheaper.  Falls back to a plain fill without the engine."""
    a = np.empty(n, dtype)
    lib = get_lib()
    if lib is None:
        a.fill(0)
        return a
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    lib.bt_memset_mt(ctypes.c_void_p(a.ctypes.data),
                     ctypes.c_int64(a.nbytes), ctypes.c_int32(n_threads))
    return a


def native_build_seed_index(ref32, pos0, pos1, seed_size, nk, n_threads=0):
    """C++ CSR seed-index fill (counting sort over the 3^s key space).
    Returns (starts i64[nk], counts i32[nk], n1 i32[nk], locs u32[n]) with
    the exact layout of the numpy build in index/seedindex.py."""
    lib = get_lib()
    if lib is None:
        return None
    pos0 = np.ascontiguousarray(pos0, np.int64)
    pos1 = np.ascontiguousarray(pos1, np.int64)
    # np.empty: bt_build_seed_index zeroes the tables itself with threaded
    # sequential memsets (random-order np.zeros faulting cost 0.4-1.1s)
    starts = np.empty(nk, np.int64)
    counts = np.empty(nk, np.int32)
    n1 = np.empty(nk, np.int32)
    locs = np.empty(pos0.size + pos1.size, np.uint32)
    for a in (starts, counts, n1, locs):
        madvise_hugepage(a)  # tables are gathered randomly per seed probe
    if n_threads <= 0:
        n_threads = min(_ncpu(), 8)
    lib.bt_build_seed_index(
        ref32[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ref32[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(ref32.shape[1]),
        _p(pos0, ctypes.c_int64), ctypes.c_int64(pos0.size),
        _p(pos1, ctypes.c_int64), ctypes.c_int64(pos1.size),
        ctypes.c_int32(seed_size), ctypes.c_int64(nk),
        _p(starts, ctypes.c_int64), _p(counts, ctypes.c_int32),
        _p(n1, ctypes.c_int32), _p(locs, ctypes.c_uint32),
        ctypes.c_int32(n_threads))
    return starts, counts, n1, locs
