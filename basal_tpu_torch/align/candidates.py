"""Seed scheduling + candidate-table construction (host side).

Reproduces the reference's frequency-aware seed placement exactly:
  ReorderSeed          (align.cpp:468-498)
  AdjustSeedStartArray (align.cpp:500-524)
  CountSeeds           (align.cpp:526-540)  — incl. the sticky <<12 N-weight
  GetTotalSeedLoc      (align.cpp:542-546)
then expands every (read, chain, segment, probe) seed into a flat candidate
table through the CSR index.  Candidate order inside a group is CSR order;
the random-start circular visit order (SnpAlign, align.cpp:290-294) is
applied later by the replay using ``jj0``.

All integer arithmetic replicates the reference's u32 wraparound: CountSeeds
accumulates into a bit32_t (align.cpp:527) but is *returned as int* and the
(count, segid) pairs are sorted with signed comparison (align.cpp:492-495),
while GetTotalSeedLoc/Adjust comparisons are unsigned.

Copied from ``basal_tpu/align/candidates.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import AlignParams, MAXSNPS
from ..index.seedindex import SeedIndex
from ..reads.encode import EncodedBatch
from .rng import MyRand


@dataclasses.dataclass
class CandGroup:
    """One (read, chain, mode-rank, probe) seed probe's candidate slice."""
    read: int
    chain: int
    mode: int        # stratum rank (sorted position)
    seg: int         # original segment id (xseedindex .second)
    h: int           # alignment-start offset: profile + seg_start - i
    start: int       # offset into the flat candidate arrays
    m: int           # number of candidates
    mc: int          # chain-0 count - 1 (plane boundary; align.cpp:286)
    jj0: int         # random scan start (align.cpp:290)


@dataclasses.dataclass
class CandidateTable:
    loc: np.ndarray          # int32 [C] concatenated alignment-start coords
    plane: np.ndarray        # int32 [C] ref strand plane
    row: np.ndarray          # int32 [C] read-plane row (2*read + chain)
    groups: List[List[CandGroup]]   # per read, in replay order
    # per-read scheduling results (needed by replay for h of gapped hits)
    n_groups: int
    skip: Optional[np.ndarray] = None  # bool [C] RRBS: entry mode/plane
                                       # mismatch or loc underflow


class SeedScheduler:
    """Per-aligner-instance stateful scheduler.

    ``xseed_start_offset`` persists across reads like the reference member
    (align.h:73) — it is only rewritten when (L-I+1)%s > 0, else the previous
    read's value leaks into AdjustSeedStartArray's search bounds.
    """

    #: reference xseed_array/xseedreg_array capacity (align.h:90:
    #: [2][FIXSIZE - SEGLEN] = [2][480])
    STALE_N = 480

    def __init__(self, params: AlignParams, index: SeedIndex, rng: MyRand):
        self.p = params
        self.index = index
        self.rng = rng
        self.profile = params.profile()        # [MAXSNPS+1, I]
        self.start_offset_state = [0, 0]       # per chain
        # persistent stale seed buffers: entry k = seed/has-N of the LAST
        # unfiltered chain-enabled read with L - s >= k (zeros before first
        # touch — the oracle's SingleAlign heap pages arrive zeroed).  Reads
        # with (L-I+1) % s == 0 skip the best-offset search, so a previous
        # read's start offset leaks into AdjustSeedStartArray and its probes
        # index the buffer beyond [0, L-s] — consuming these entries.
        self.seed_state = np.zeros((2, self.STALE_N), np.uint32)
        self.reg_state = np.zeros((2, self.STALE_N), bool)

    def refresh_state(self, enc: EncodedBatch, r: int) -> None:
        """ConvertBinarySeq effect (align.cpp:153-226): every unfiltered
        read overwrites the enabled chains' buffers at [0, L-s] — even reads
        with no seed segments (RunAlign converts before probing)."""
        n = min(int(enc.n_offsets[r]), self.STALE_N)
        if n <= 0:
            return
        for chain in range(2):
            if not enc.xflag_chain[r, chain]:
                continue
            self.seed_state[chain, :n] = enc.seedval[r, chain, :n]
            self.reg_state[chain, :n] = enc.seed_has_n[r, chain, :n]

    def probe_seed(self, enc: EncodedBatch, r: int, chain: int, off: int):
        """Seed value at offset ``off``: the read's own for in-range
        offsets, the stale buffer beyond (None past even the reference's
        480 entries)."""
        if off < int(enc.n_offsets[r]):
            return int(enc.seedval[r, chain, off])
        if off < self.STALE_N:
            return int(self.seed_state[chain, off])
        return None

    def count_seeds(self, chain: int, seedval: np.ndarray,
                    has_n: np.ndarray, n_off: int, seg: int,
                    start: int) -> int:
        """CountSeeds (align.cpp:526-540): u32-wrapping sum with sticky <<12
        N-weight.  Offsets beyond [0, L-s] read the stale buffers (the
        reference's fixed xseed_array; see __init__); offsets past even its
        480 entries count 0 (reference UB, unreachable for L <= 480)."""
        I = self.p.index_interval
        total = np.uint32(0)
        k = 0
        counts = self.index.counts
        with np.errstate(over="ignore"):
            for i in range(I):
                off = int(self.profile[seg][i]) + start - i
                if not (0 <= off < self.STALE_N):
                    continue
                if off < n_off:
                    hn = has_n[off]
                    sd = int(seedval[off])
                else:
                    hn = self.reg_state[chain, off]
                    sd = int(self.seed_state[chain, off])
                if hn:
                    k = 12
                c = np.uint32(counts[sd])
                total = np.uint32(total + np.uint32(c << np.uint32(k)))
        if total == 0:
            total = np.uint32(9999999)
        return int(total)

    def schedule_read(self, enc: EncodedBatch, r: int):
        """Returns per-chain (start_array[segnum], order[segnum]) or None for
        disabled chains."""
        p = self.p
        L = int(enc.map_len[r])
        segnum = int(enc.seedseg_num[r])
        I = p.index_interval
        s = p.seed_size
        out = []
        for chain in range(2):
            if not enc.xflag_chain[r, chain]:
                out.append(None)
                continue
            seedval = enc.seedval[r, chain]
            has_n = enc.seed_has_n[r, chain]
            n_off = int(enc.n_offsets[r])
            if p.rrbs_flag:
                # RRBS: start fixed at cseed_offset*chain, no Adjust pass
                # (ReorderSeed RRBS branch, align.cpp:473,486-487)
                cso = (L % s) * chain
                start_arr = [cso] * segnum
                keys = []
                for seg in range(segnum):
                    c = self.count_seeds(chain, seedval, has_n, n_off, seg, cso)
                    keys.append((int(np.int32(np.uint32(c))), seg))
                keys.sort()
                out.append((start_arr, [seg for _, seg in keys]))
                continue
            max_offset = (L - I + 1) % s

            # ReorderSeed: pick global start minimizing total (align.cpp:475-480)
            if max_offset > 0:
                best = 0xFFFFFFFF
                for i in range(max_offset):
                    tt = np.uint32(0)
                    with np.errstate(over="ignore"):
                        for seg in range(segnum):
                            tt = np.uint32(tt + np.uint32(
                                self.count_seeds(chain, seedval, has_n, n_off, seg, i)))
                    if int(tt) < best:
                        best = int(tt)
                        self.start_offset_state[chain] = i
            start_arr = [self.start_offset_state[chain]] * segnum

            # AdjustSeedStartArray (align.cpp:500-524): outside-in relaxation
            for i in range(segnum):
                ptr = i // 2 if i % 2 == 0 else segnum - 1 - i // 2
                lo = 0 if ptr == 0 else start_arr[ptr - 1]
                hi = max_offset if ptr == segnum - 1 else start_arr[ptr + 1]
                total = 0xFFFFFFFF
                start_arr[ptr] = lo
                for ii in range(lo, hi + 1):
                    tt = self.count_seeds(chain, seedval, has_n, n_off, ptr, ii)
                    if np.uint32(tt) < np.uint32(total):
                        total = tt
                        start_arr[ptr] = ii
            # segment order: sort (count-as-int, segid) pairs (align.cpp:492-495)
            keys = []
            for seg in range(segnum):
                c = self.count_seeds(chain, seedval, has_n, n_off, seg, start_arr[seg])
                keys.append((np.int32(np.uint32(c)), seg))
            keys.sort(key=lambda t: (int(t[0]), t[1]))
            order = [seg for _, seg in keys]
            out.append((start_arr, order))
        return out


def build_candidates(params: AlignParams, index: SeedIndex,
                     enc: EncodedBatch, sched: SeedScheduler,
                     schedules: Optional[list] = None) -> CandidateTable:
    """Expand all probes of all reads into one flat candidate table."""
    p = params
    I = p.index_interval
    starts = index.starts
    n1 = index.n1
    counts = index.counts
    mkn = index.max_kmer_num
    profile = sched.profile

    loc_parts: List[np.ndarray] = []
    groups: List[List[CandGroup]] = []
    flat = 0
    B = len(enc.reads)
    if schedules is None:
        schedules = [None] * B

    plane_parts: List[np.ndarray] = []
    row_parts: List[np.ndarray] = []
    for r in range(B):
        glist: List[CandGroup] = []
        groups.append(glist)
        if enc.filtered[r]:
            continue
        sched.refresh_state(enc, r)
        if enc.seedseg_num[r] <= 0:
            # ReorderSeed still runs with 0 segments: GetTotalSeedLoc
            # returns 0 for every probe start, so the best-offset search
            # (when max_offset > 0) resets the sticky start offset to 0
            # (align.cpp:475-480)
            if (int(enc.map_len[r]) - I + 1) % p.seed_size > 0:
                for chain in range(2):
                    if enc.xflag_chain[r, chain]:
                        sched.start_offset_state[chain] = 0
            continue
        if schedules[r] is None:
            schedules[r] = sched.schedule_read(enc, r)
        per_chain = schedules[r]
        rv = sched.rng(enc.reads[r].index)
        for chain in range(2):
            if per_chain[chain] is None:
                continue
            start_arr, order = per_chain[chain]
            for mode, seg in enumerate(order):
                for i in range(I):
                    off = int(profile[seg][i]) + start_arr[seg] - i
                    s = sched.probe_seed(enc, r, chain, off)
                    if s is None:
                        continue  # past even the reference's 480 entries
                    m = int(counts[s])
                    if m == 0 or m > mkn:
                        continue
                    h = off
                    lo = int(starts[s])
                    locs = index.locs[lo:lo + m].astype(np.int64)
                    cand_loc = (locs - h).astype(np.int32)
                    pl = (np.arange(m) >= n1[s]).astype(np.int32)
                    jj0 = (rv if p.randseed != 0
                           else sched.rng(enc.reads[r].index)) % m
                    glist.append(CandGroup(
                        read=r, chain=chain, mode=mode, seg=seg, h=h,
                        start=flat, m=m, mc=int(n1[s]) - 1, jj0=int(jj0)))
                    loc_parts.append(cand_loc)
                    plane_parts.append(pl)
                    row_parts.append(np.full(m, 2 * r + chain, dtype=np.int32))
                    flat += m
    if flat == 0:
        z = np.zeros(0, dtype=np.int32)
        return CandidateTable(loc=z, plane=z.copy(), row=z.copy(),
                              groups=groups, n_groups=0)
    return CandidateTable(
        loc=np.concatenate(loc_parts),
        plane=np.concatenate(plane_parts),
        row=np.concatenate(row_parts),
        groups=groups, n_groups=sum(len(g) for g in groups),
    )


def build_candidates_rrbs(params: AlignParams, rindex, ref,
                          enc: EncodedBatch, sched: SeedScheduler) -> CandidateTable:
    """RRBS candidate expansion (SnpAlign RRBS branch, align.cpp:233-273):
    one probe per segment; the per-seed entry list spans all fragment modes
    and both orientation flags — non-matching entries become skip-masked
    candidates so the random-start rotation indexes stay aligned."""
    p = params
    anchors = ref.ref_anchor
    loc_parts, plane_parts, row_parts, skip_parts = [], [], [], []
    groups: List[List[CandGroup]] = []
    flat = 0
    profile = sched.profile
    B = len(enc.reads)
    for r in range(B):
        glist: List[CandGroup] = []
        groups.append(glist)
        if enc.filtered[r]:
            continue
        sched.refresh_state(enc, r)
        if enc.seedseg_num[r] <= 0:
            continue  # RRBS start offset is fixed at 0 — no sticky state
        per_chain = sched.schedule_read(enc, r)
        rv = sched.rng(enc.reads[r].index)
        L = int(enc.map_len[r])
        cso = L % p.seed_size
        for chain in range(2):
            if per_chain[chain] is None:
                continue
            _, order = per_chain[chain]
            for mode, seg in enumerate(order):
                cmode = seg if chain == 0 else L // p.seed_size - 1 - seg
                off = int(profile[seg][0]) + cso * chain
                s = sched.probe_seed(enc, r, chain, off)
                if s is None:
                    continue  # past even the reference's 480 entries
                lo, m = int(rindex.starts[s]), int(rindex.n1[s])
                if m == 0:
                    continue
                cm = rindex.chrmode[lo:lo + m].astype(np.int64)
                locs = rindex.locs[lo:lo + m].astype(np.int64)
                h = off
                # entry matches when (chrmode ^ chain<<24) >> 16 == cmode
                # (align.cpp:248) and loc >= h (align.cpp:250)
                match = ((cm ^ (chain << 24)) >> 16) == cmode
                ok = match & (locs >= h)
                chrplane = (cm & 0xFFFF).astype(np.int64)
                pair = chrplane >> 1
                cand_loc = np.where(ok, anchors[pair] + locs - h,
                                    12800).astype(np.int32)
                jj0 = (rv if p.randseed != 0
                       else sched.rng(enc.reads[r].index)) % m
                glist.append(CandGroup(
                    read=r, chain=chain, mode=mode, seg=seg, h=h,
                    start=flat, m=m, mc=m, jj0=int(jj0)))
                loc_parts.append(cand_loc)
                plane_parts.append((chrplane & 1).astype(np.int32))
                row_parts.append(np.full(m, 2 * r + chain, dtype=np.int32))
                skip_parts.append(~ok)
                flat += m
    if flat == 0:
        z = np.zeros(0, dtype=np.int32)
        return CandidateTable(loc=z, plane=z.copy(), row=z.copy(),
                              groups=groups, n_groups=0,
                              skip=np.zeros(0, bool))
    return CandidateTable(
        loc=np.concatenate(loc_parts),
        plane=np.concatenate(plane_parts),
        row=np.concatenate(row_parts),
        groups=groups, n_groups=sum(len(g) for g in groups),
        skip=np.concatenate(skip_parts),
    )
