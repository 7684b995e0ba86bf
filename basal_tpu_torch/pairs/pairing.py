"""Paired-end pairing logic — exact replica of PairAlign (pairs.cpp).

``get_pairs`` mirrors PairAlign::GetPairs (pairs.cpp:29-130): merge the
chain-0 bucket of one end against the chain-1 bucket of the other per
chromosome (same chr value => same strand plane), accepting inserts within
[min_insert, max_insert] with the reference's u32 wraparound semantics.

``lockstep_align`` mirrors PairAlign::RunAlign (pairs.cpp:132-177): both
ends' stratum-i scans advance together; after each level every (i,j) stratum
combination summing to <= level is paired; first level with pairs wins.

Copied from ``basal_tpu/pairs/pairing.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

from typing import List, Tuple

from ..align.replay import Hit, ReadScan
from ..config import AlignParams, MAXSNPS

# PairHit replica (pairs.h:13-20): (chain, na, nb, insert, a_hit, b_hit)
PairHit = Tuple[int, int, int, int, Hit, Hit]


def get_pairs(p: AlignParams, sa: ReadScan, sb: ReadScan, na: int, nb: int,
              pairhits: List[List[PairHit]]) -> int:
    if na > sa.rms or nb > sb.rms:
        return 0
    la, lb = sa.L, sb.L
    npair = 0
    bucket = pairhits[na + nb]
    # chain 0: a-fwd x b-rev; chain 1: a-rev x b-fwd (pairs.cpp:55-109)
    for chain, alist, blist in ((0, sa.hits[0][na], sb.hits[1][nb]),
                                (1, sa.hits[1][na], sb.hits[0][nb])):
        chra = None
        bstart = bend = 0
        for ah in alist:
            if chra != ah[0]:
                chra = ah[0]
                bstart = bend
                while bstart < len(blist) and blist[bstart][0] < chra:
                    bstart += 1
                bend = bstart
                while bend < len(blist) and blist[bend][0] <= chra:
                    bend += 1
            for j in range(bstart, bend):
                bh = blist[j]
                # insert window (pairs.cpp:67-69, 95-97); plane parity decides
                # which end is leftmost
                if (chra & 1) == chain:
                    seg_start, seg_end = ah[1], bh[1] + lb
                else:
                    seg_start, seg_end = bh[1], ah[1] + la
                insert = (seg_end - seg_start) & 0xFFFFFFFF
                if p.min_insert <= insert <= p.max_insert:
                    bucket.append((chain, na, nb, insert, ah, bh))
                    npair += 1
                    if len(bucket) >= p.max_num_hits:
                        return npair
    return npair


def lockstep_align(p: AlignParams, sa: ReadScan, sb: ReadScan,
                   pairhits: List[List[PairHit]]) -> int:
    """PairAlign::RunAlign (pairs.cpp:132-177)."""
    n = 0
    maxi = max(sa.rms, sb.rms)
    for i in range(maxi + 1):
        sa.step_mode(i)
        sb.step_mode(i)
        sa.sort_bucket(i)
        sb.sort_bucket(i)
        n += get_pairs(p, sa, sb, i, i, pairhits)
        for j in range(i):
            n += get_pairs(p, sa, sb, i, j, pairhits)
            n += get_pairs(p, sa, sb, j, i, pairhits)
        if p.nt3:
            continue
        if n > 0:
            return 1
    return n


def fix_pair_read_name(name_a: str, name_b: str):
    """FixPairReadName (pairs.cpp:487-507)."""
    if name_a == name_b:
        return name_a, name_b
    d = -1
    i0 = min(len(name_a), len(name_b))
    i = 0
    while i < i0:
        if name_a[i] != name_b[i]:
            break
        if name_a[i].isdigit():
            d = i
        i += 1
    if i > 0:
        if d < 0:
            d = i - 1
        return name_a[:d + 1], name_b[:d + 1]
    raise ValueError(
        f"Paired reads name not match:\n{name_a}\n{name_b}")
