"""Multi-process runs over torch.distributed: the routed seed index and the
process-spanning mesh.

PyTorch counterpart of ``basal_tpu.parallel.multihost`` (see its docstring
for the protocol).  Each process aligns its own contiguous read window
(``read_window``), holds only its k-mer range of the seed index, and fetches
the entries its batches probe from their owners in batched routing rounds
(``TorchRoutedSeedIndex``).  The concatenated per-process SAM bodies equal
the single-process run, as in basal_tpu.

What is re-hosted here is what reached jax there: process rank and count,
the cross-process all-gather, ``init_multihost``, ``make_multihost_mesh``
and ``read_window``.  The routing protocol itself (``_round_inner``,
``_fill``, ``_answer_one``, the service thread, ``ensure_batch``,
``wait_batch``, ``drain``) is inherited from ``parallel.routed``, the
port's copy of basal_tpu's ``RoutedSeedIndex``.

Routing payloads are host arrays, so the routing always runs on a process
group of its own with the gloo backend, whatever backend the default group
has.  Its own group also keeps the service thread's collectives apart from
a mesh merge that the main thread makes on the default group.  gloo has no
uint32: u32 payloads travel as int32 views and come back as uint32.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..align.pipeline import resolve_device
from ..config import AlignParams
from ..index.reference import PackedReference
from ..index.seedindex import _kmer_cutoff
from ..index.sharded import IndexShard, build_shard
from .mesh import TorchMesh
from .routed import RoutedSeedIndex

BACKENDS = ("gloo", "nccl")


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str) -> None:
    """Join a ``num_processes`` run as rank ``process_id``.  ``coordinator``
    is ``host:port`` (or a ``tcp://`` URL) of rank 0's rendezvous.  The
    backend is named, never picked: ``gloo`` (CPU tensors; the mesh merge
    copies to the host) or ``nccl`` (one card per rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _Collectives:
    """``process_allgather`` of jax's multihost_utils, the one collective
    RoutedSeedIndex's rounds call, on a torch process group."""

    def __init__(self, group, nproc: int):
        self.group = group
        self.nproc = nproc

    def process_allgather(self, x: np.ndarray) -> np.ndarray:
        """Every process's ``x`` (same shape and dtype everywhere), stacked
        [nproc, ...] in rank order."""
        x = np.ascontiguousarray(x)
        wire = x.view(np.int32) if x.dtype == np.uint32 else x
        t = torch.from_numpy(wire)
        parts = [torch.empty_like(t) for _ in range(self.nproc)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts).numpy().view(x.dtype)


def _allgather_ragged(x: np.ndarray, coll: _Collectives) -> List[np.ndarray]:
    """All-gather a variable-length 1-D array from every process: the
    sizes, then the payload padded to a power of two."""
    if coll.nproc == 1:
        return [np.asarray(x)]
    n = int(x.shape[0])
    sizes = coll.process_allgather(np.array([n], np.int64)).reshape(
        coll.nproc)
    m = 1 << (max(int(sizes.max()), 1) - 1).bit_length()
    pad = np.zeros(m, x.dtype)
    pad[:n] = x
    full = coll.process_allgather(pad).reshape(coll.nproc, m)
    return [full[p, :int(sizes[p])] for p in range(coll.nproc)]


class TorchRoutedSeedIndex(RoutedSeedIndex):
    """``parallel.routed.RoutedSeedIndex`` with its collectives on
    torch.distributed: rank and count from the default process group, the
    routing rounds on a new gloo group made here, so every process must
    construct its index at the same point of its run.  ``num_shards`` /
    ``shard_id`` override rank and count, as in basal_tpu (one shard needs
    no process group)."""

    def __init__(self, ref: PackedReference, params: AlignParams,
                 num_shards: Optional[int] = None,
                 shard_id: Optional[int] = None):
        self.params = params
        nproc = num_shards if num_shards is not None else process_count()
        pid = shard_id if shard_id is not None else process_index()
        self.nproc = nproc
        self.pid = pid
        group = dist.new_group(backend="gloo") if nproc > 1 else None
        self._coll = _Collectives(group, nproc)
        nk = params.total_kmers
        per = -(-nk // nproc)
        self.bounds = np.minimum(np.arange(nproc + 1, dtype=np.int64) * per,
                                 nk)
        self.shard: IndexShard = build_shard(
            ref, params, int(self.bounds[pid]), int(self.bounds[pid + 1]))
        # dense per-batch tables, filled for queried k-mers only, pages
        # touched here (see basal_tpu's RoutedSeedIndex.__init__)
        self.starts = np.empty(nk, dtype=np.int64)
        self.counts = np.zeros(nk, dtype=np.int32)
        self.n1 = np.zeros(nk, dtype=np.int32)
        self._have = np.zeros(nk, dtype=bool)
        try:
            from ..native import madvise_hugepage
            for a in (self.starts, self.counts, self.n1, self._have):
                madvise_hugepage(a)
        except Exception:  # noqa: BLE001 - advisory only
            pass
        for a in (self.starts, self.counts, self.n1, self._have):
            a.reshape(-1)[::512] = 0
        self._locs = np.zeros(1024, dtype=np.uint32)
        self._locs_n = 0
        self._fill_lock = threading.Lock()   # see parallel.routed
        self.exchanged_queries = 0
        self.exchanged_locs = 0
        self.rounds = 0
        self.t_exchange = 0.0
        self.t_wait = 0.0
        self.t_phase = {"status": 0.0, "qgather": 0.0, "answer": 0.0,
                        "rgather": 0.0, "parse": 0.0, "f_locs": 0.0,
                        "f_scatter": 0.0, "f_have": 0.0}
        # global over-representation cutoff from every shard's occurring
        # k-mer count multiset (refbase.cpp:362-363's quantile)
        nz = np.flatnonzero(self.shard.counts)
        uk = np.concatenate(_allgather_ragged(
            (nz + self.shard.kmer_lo).astype(np.int64), self._coll))
        uc = np.concatenate(_allgather_ragged(
            self.shard.counts[nz].astype(np.int64), self._coll))
        self.max_kmer_num = _kmer_cutoff(params, uk, uc)

    def _round(self, q: np.ndarray, done: bool):
        """One collective routing round (basal_tpu's ``_round_inner``) on
        the routing group."""
        t0 = time.time()
        try:
            return self._round_inner(q, done, self._coll)
        finally:
            self.t_exchange += time.time() - t0


def make_multihost_mesh(devices) -> TorchMesh:
    """A (dp, rs) mesh whose rs axis spans the processes: column p is
    process p's reference shard, and this process's ``devices`` are its dp
    rows (entries may repeat).  dp stays inside the process, so every
    process assembles its whole output after the ``all_reduce(MIN)`` over
    the default group.  Every process must give as many devices; it is
    checked."""
    devices = [resolve_device(d) for d in devices]
    n_dp = len(devices)
    if n_dp == 0:
        raise ValueError("no devices for the mesh")
    group = dist.group.WORLD
    on = devices[0] if dist.get_backend(group) == "nccl" else "cpu"
    chk = torch.tensor([n_dp, -n_dp], dtype=torch.int64, device=on)
    dist.all_reduce(chk, op=dist.ReduceOp.MIN, group=group)
    if int(chk[0]) != -int(chk[1]):
        raise ValueError(f"processes disagree on n_dp: {int(chk[0])} .. "
                         f"{-int(chk[1])}")
    nproc, pid = dist.get_world_size(group), dist.get_rank(group)
    grid = [[None] * nproc for _ in range(n_dp)]
    for i in range(n_dp):
        grid[i][pid] = devices[i]
    return TorchMesh(grid, group=group)


def read_window(params: AlignParams, total_reads: int) -> AlignParams:
    """This process's contiguous global-read-index window (the -B/-E split
    the reference's manual sharding would use), within any -B/-E given."""
    nproc, pid = process_count(), process_index()
    lo = params.read_start
    hi = min(params.read_end, lo + total_reads - 1) \
        if total_reads else params.read_end
    span = hi - lo + 1
    per = -(-span // nproc)
    b = lo + pid * per
    e = min(hi, b + per - 1)
    return dataclasses.replace(params, read_start=b, read_end=e)
