"""Sequential scan replay: reproduces the reference's per-read accept logic
exactly, consuming device-computed mismatch counts.

The expensive work (conversion-masked mismatch counting over every candidate)
runs batched on the TPU (basal_tpu.ops.extend); what remains is the
order-sensitive bookkeeping that defines BASAL's output bit-for-bit:

  random-start circular candidate visits   SnpAlign        align.cpp:290-313
  dedup via per-chr location sets          AddHit          align.cpp:329-347
  mismatch-stratum buckets + -w cap        AddHit          align.cpp:340-345
  gapped-extension combination             GapAlign        align.cpp:348-410
  pigeonhole early stop per stratum        RunAlign        align.cpp:459-463
  stratum pick & -r multi-hit policy       StringAlign     align.cpp:583-612

``ReadScan`` exposes the per-stratum stepping so the paired-end lockstep
search (PairAlign::RunAlign, pairs.cpp:132-177) can interleave two scans.

This pure-Python version is the semantic reference; a C++ twin (ctypes) is
used for throughput (basal_tpu.align.native).

Copied from ``basal_tpu/align/replay.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import AlignParams, MAXSNPS
from ..index.reference import PackedReference
from .candidates import CandidateTable
from ..reads.encode import EncodedBatch
from .rng import MyRand

# gHit replica (param.h:35-42)
Hit = Tuple[int, int, int, int]  # (chr, loc, gap_size, gap_pos)


@dataclasses.dataclass
class ReadResult:
    filtered: bool                 # QC fail -> flag 0x204
    stratum: int = 0               # mismatch count of reported stratum
    nhits: int = 0                 # total equal-best hits
    hits0: List[Hit] = None        # chain-0 bucket at best stratum
    hits1: List[Hit] = None


def precompute_chr(ref: PackedReference, loc: np.ndarray):
    """Vectorized int2hit chr resolution (align.cpp:319-334)."""
    n = ref.total_num
    anchors = ref.ref_anchor[:n]
    chrpair = np.clip(np.searchsorted(anchors, loc.astype(np.int64),
                                      side="right") - 1, 0, n - 1)
    local = loc.astype(np.int64) - anchors[chrpair]
    return chrpair.astype(np.int64), local


class ReadScan:
    """Per-read scan state: buckets, dedup sets, running snp_thres.

    Drives the candidate visits of one stratum at a time (``step_mode``),
    allowing both the SE driver (all modes + pigeonhole stop) and the PE
    lockstep driver to share the exact accept semantics.
    """

    def __init__(self, rp: "Replayer", enc: EncodedBatch, table: CandidateTable,
                 counts, pos0, pos1, chrpair, local, r: int):
        self.rp = rp
        self.p = rp.p
        self.enc = enc
        self.table = table
        self.counts = counts
        self.pos0 = pos0
        self.pos1 = pos1
        self.chrpair = chrpair
        self.local = local
        self.r = r
        self.L = int(enc.map_len[r])
        self.rms = int(enc.read_max_snp[r])
        self.snp_thres = self.rms
        self.segnum = int(enc.seedseg_num[r])
        self.hits = [[[] for _ in range(MAXSNPS + 1)] for _ in range(2)]
        self.seen = set()
        # Abort semantics: AddHit's return-1 (w==0 bucket full) aborts only
        # the *current* SnpAlign call; the SE driver then stops via its hit
        # check (align.cpp:459-464) while the PE lockstep loop keeps calling
        # later strata (pairs.cpp:164-174).
        self.last_abort = False
        self.groups = table.groups[r]

    # -- int2hit (align.cpp:319-346) ------------------------------------
    def _int2hit(self, cp: int, lo: int, plane: int, gap_size: int,
                 gap_pos: int) -> Hit:
        loc = lo
        if plane:
            loc = int(self.rp.rc_off[cp]) - self.L - loc
            gap_pos = self.L + (gap_size if gap_size < 0 else 0) - gap_pos
            loc -= gap_size
        return (2 * cp + plane, loc, gap_size, gap_pos)

    def _add_hit(self, chain: int, w: int, hit: Hit) -> int:
        """AddHit (align.cpp:329-347).  Returns 1 => abort scan."""
        chr_, loc, gsz, gpos = hit
        if loc < 0 or (loc & 0xFFFFFFFF) + self.L > self.rp.sizes[chr_ >> 1]:
            return 0
        key = (1 if gsz else 0, chr_ >> 1, loc)
        if key in self.seen:
            return 0
        self.seen.add(key)
        self.hits[chain][w].append(hit)
        if len(self.hits[0][w]) + len(self.hits[1][w]) >= self.p.max_num_hits:
            if w == 0:
                return 1
            self.snp_thres = w - 1
        return 0

    def _gap_align(self, ci: int, chain: int, plane: int, seed_pos: int) -> int:
        """GapAlign (align.cpp:348-410)."""
        p = self.p
        L = self.L
        if self.snp_thres < 2:
            return 0
        p0 = self.pos0[ci]
        ret0 = int(p0[self.snp_thres - 2])
        if ret0 < seed_pos + p.seed_size:
            return 0
        for tt in range(1, 2 * p.gap + 1):
            t = (tt + 1) // 2
            shift = (1 - (tt % 2) * 2) * t
            shift1 = shift if shift < 0 else 0
            if self.snp_thres < 1 + t:
                break
            rl = L - t - 1
            mmi2 = self.pos1[ci, tt - 1]
            for i in range(self.snp_thres - t):
                gpos = int(p0[i])
                if gpos < p.gap_edge or gpos >= rl:
                    continue
                for j in range(self.snp_thres - t - i):
                    m2 = int(mmi2[j])
                    if m2 < p.gap_edge or m2 >= rl:
                        continue
                    if gpos + m2 - shift1 < L:
                        continue
                    gap_snp = i + j + t
                    clip = gpos + p.gap_edge - L - shift1
                    if clip > 0:
                        gpos -= clip
                    hit = self._int2hit(int(self.chrpair[ci]),
                                        int(self.local[ci]), plane, shift, gpos)
                    return self._add_hit(chain, gap_snp, hit)
        return 0

    def step_mode(self, mode: int):
        """SnpAlign(mode): visit all candidates of this stratum's seed
        segments (both chains) in reference order."""
        self.last_abort = False
        if mode >= self.segnum:
            return
        gap = self.p.gap
        counts = self.counts
        skip = self.table.skip       # RRBS entry mask (align.cpp:248-250)
        planes = self.table.plane
        for g in self.groups:
            if g.mode != mode:
                continue
            m = g.m
            jj = g.jj0
            for _ in range(m):
                ci = g.start + jj
                if skip is not None:
                    if skip[ci]:
                        jj += 1
                        if jj >= m:
                            jj -= m
                        continue
                    plane = int(planes[ci])
                else:
                    plane = 1 if jj > g.mc else 0
                cnt = int(counts[ci])
                if cnt <= self.snp_thres:
                    hit = self._int2hit(int(self.chrpair[ci]),
                                        int(self.local[ci]), plane, 0, 0)
                    if self._add_hit(g.chain, cnt, hit):
                        self.last_abort = True
                        return
                if gap > 0:
                    if self._gap_align(ci, g.chain, plane, g.h):
                        self.last_abort = True
                        return
                jj += 1
                if jj >= m:
                    jj -= m

    def has_hits_le(self, mode: int) -> bool:
        return any(self.hits[0][ii] or self.hits[1][ii]
                   for ii in range(min(mode, self.rms) + 1))

    def sort_bucket(self, n: int):
        """SortHits4PE (align.cpp:412-416): sort stratum bucket by (chr, loc)."""
        if n <= self.rms:
            for c in range(2):
                self.hits[c][n].sort(key=lambda h: (h[0], h[1]))

    def run_all(self) -> ReadResult:
        """SingleAlign::RunAlign stratum loop (align.cpp:459-466)."""
        for mode in range(self.segnum):
            self.step_mode(mode)
            if self.last_abort:
                break
            if not self.p.nt3 and self.has_hits_le(mode):
                break
        return self.result()

    def result(self) -> ReadResult:
        for ii in range(self.rms + 1):
            s = len(self.hits[0][ii]) + len(self.hits[1][ii])
            if s > 0:
                return ReadResult(filtered=False, stratum=ii, nhits=s,
                                  hits0=self.hits[0][ii], hits1=self.hits[1][ii])
        return ReadResult(filtered=False, stratum=self.rms + 1, nhits=0,
                          hits0=[], hits1=[])


class Replayer:
    def __init__(self, params: AlignParams, ref: PackedReference, rng: MyRand):
        self.p = params
        self.ref = ref
        self.rng = rng
        self.sizes = np.array([t.size for t in ref.titles], dtype=np.int64)
        self.rc_off = np.array([t.rc_offset for t in ref.titles], dtype=np.int64)

    def scans(self, enc: EncodedBatch, table: CandidateTable, counts,
              pos0=None, pos1=None):
        chrpair, local = (precompute_chr(self.ref, table.loc)
                          if table.loc.size else (None, None))
        return [None if enc.filtered[r] else
                ReadScan(self, enc, table, counts, pos0, pos1, chrpair, local, r)
                for r in range(len(enc.reads))]

    def replay_batch(self, enc: EncodedBatch, table: CandidateTable,
                     counts: np.ndarray,
                     pos0: Optional[np.ndarray] = None,
                     pos1: Optional[np.ndarray] = None) -> List[ReadResult]:
        return [ReadResult(filtered=True) if s is None else s.run_all()
                for s in self.scans(enc, table, counts, pos0, pos1)]
