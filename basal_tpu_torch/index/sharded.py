"""K-mer-range sharded seed index (multi-host scale-out design, SURVEY §2.4).

For references whose seed tables exceed one host's RAM (whole-transcriptome
at -I 1), the 3^s key space is split into contiguous k-mer ranges, one shard
per host.  Each host builds only the positions whose *seed value* falls in
its range; a read's seed probes route to the owning shard (the k-mer range
is a static function of the seed value, so there is no broadcast).  Per-shard
candidate lists are disjoint and each k-mer lives in exactly one shard, so
the merged candidate table — and therefore the downstream scan replay — is
**bit-identical** to the single-host build (placement-invariant ordering).

In a real multi-host deployment the per-shard lookups are batched RPCs over
DCN while the extension runs on each host's chips; here the shards live
in-process, which exercises the exact same routing/merge logic.

Copied from ``basal_tpu/index/sharded.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..config import AlignParams
from .reference import PackedReference
from .seedindex import SeedIndex, _chain_positions, _kmer_cutoff
from ..bits import seeds_from_words


@dataclasses.dataclass
class IndexShard:
    kmer_lo: int
    kmer_hi: int
    starts: np.ndarray   # int64 [range] (local, offset by kmer_lo)
    counts: np.ndarray   # int32 [range]
    n1: np.ndarray       # int32 [range]
    locs: np.ndarray     # uint32


class ShardedSeedIndex:
    """Same lookup API as SeedIndex (starts/counts/n1/locs indexed by kmer)
    but backed by k-mer-range shards.  ``gather()`` materializes the dense
    arrays for the native engine on a single host; multi-host deployments
    route per-seed lookups instead."""

    def __init__(self, shards: List[IndexShard], total_kmers: int,
                 max_kmer_num: int):
        self.shards = shards
        self.total_kmers = total_kmers
        self.max_kmer_num = max_kmer_num
        bounds = [s.kmer_lo for s in shards] + [total_kmers]
        self.bounds = np.asarray(bounds, dtype=np.int64)

    def shard_of(self, kmer: int) -> int:
        return int(np.searchsorted(self.bounds, kmer, side="right")) - 1

    def lookup(self, kmer: int):
        """-> (locs slice, n1, total) for one k-mer (routes to one shard)."""
        sh = self.shards[self.shard_of(kmer)]
        k = kmer - sh.kmer_lo
        m = int(sh.counts[k])
        lo = int(sh.starts[k])
        return sh.locs[lo:lo + m], int(sh.n1[k]), m

    def gather(self) -> SeedIndex:
        """Concatenate shards into a dense single-host SeedIndex; k-mer
        ranges are contiguous so shard-local CSR order is preserved."""
        counts = np.concatenate([s.counts for s in self.shards])
        n1 = np.concatenate([s.n1 for s in self.shards])
        locs = np.concatenate([s.locs for s in self.shards])
        starts = np.zeros(self.total_kmers, dtype=np.int64)
        off = 0
        pos = 0
        for s in self.shards:
            starts[s.kmer_lo:s.kmer_hi] = s.starts + off
            off += len(s.locs)
        return SeedIndex(starts=starts, counts=counts, n1=n1, locs=locs,
                         max_kmer_num=self.max_kmer_num)


def build_shard(ref: PackedReference, params: AlignParams, kmer_lo: int,
                kmer_hi: int):
    """Build one k-mer-range shard (runs independently per host)."""
    s = params.seed_size
    pos0 = _chain_positions(ref, params, 0)
    pos1 = _chain_positions(ref, params, 1)
    seeds0 = seeds_from_words(ref.ref32[0], pos0, s)
    seeds1 = seeds_from_words(ref.ref32[1], pos1, s)
    m0 = (seeds0 >= kmer_lo) & (seeds0 < kmer_hi)
    m1 = (seeds1 >= kmer_lo) & (seeds1 < kmer_hi)
    seeds = np.concatenate([seeds0[m0], seeds1[m1]]).astype(np.int64) - kmer_lo
    pos = np.concatenate([pos0[m0], pos1[m1]])
    order = np.argsort(seeds, kind="stable")
    ss = seeds[order]
    locs = pos[order].astype(np.uint32)
    rng = kmer_hi - kmer_lo
    counts = np.bincount(ss, minlength=rng).astype(np.int32) if len(ss) \
        else np.zeros(rng, np.int32)
    starts = np.zeros(rng, dtype=np.int64)
    if rng > 1:
        starts[1:] = np.cumsum(counts[:-1], dtype=np.int64)
    is0 = (order < int(m0.sum())).astype(np.int32)
    n1 = np.zeros(rng, dtype=np.int32)
    if len(ss):
        uk, uk_start = np.unique(ss, return_index=True)
        n1[uk] = np.add.reduceat(is0, uk_start)
    return IndexShard(kmer_lo=kmer_lo, kmer_hi=kmer_hi, starts=starts,
                      counts=counts, n1=n1, locs=locs)


def build_sharded_index(ref: PackedReference, params: AlignParams,
                        n_shards: int) -> ShardedSeedIndex:
    nk = params.total_kmers
    per = -(-nk // n_shards)
    shards = []
    for i in range(n_shards):
        lo = i * per
        hi = min(nk, lo + per)
        if lo >= hi:
            break
        shards.append(build_shard(ref, params, lo, hi))
    # the over-representation cutoff is a global count quantile: shards
    # exchange their occurring-kmer count multisets (small) to compute it —
    # here directly from the concatenated counts
    uk_parts, uc_parts = [], []
    for s in shards:
        nz = np.flatnonzero(s.counts)
        uk_parts.append(nz + s.kmer_lo)
        uc_parts.append(s.counts[nz])
    uk = np.concatenate(uk_parts) if uk_parts else np.zeros(0, np.int64)
    uc = np.concatenate(uc_parts) if uc_parts else np.zeros(0, np.int64)
    mkn = _kmer_cutoff(params, uk, uc)
    return ShardedSeedIndex(shards, nk, mkn)
