"""SAM record emission — byte-identical to the reference's s_OutHit
(align.cpp:614-669) and header emit (main.cpp:586-597).

Copied from ``basal_tpu/align/sam.py`` at cb4d597: the port imports nothing
of basal_tpu.  Changes: none.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import AlignParams, REV_CHAR, SEGLEN32
from ..index.reference import PackedReference
from ..reads.io import ReadRec
from .replay import Hit, ReadResult
from .rng import MyRand

CHAIN_FLAG = "+-"

_REV_TABLE = bytes(REV_CHAR.tolist())


def revcomp(seq: str) -> str:
    return seq.encode("latin1").translate(_REV_TABLE)[::-1].decode("latin1")


def sam_header(ref: PackedReference, params: AlignParams, command_line: str,
               version: str = "1.8.1") -> str:
    out = ["@HD\tVN:1.0"]
    for t in ref.titles:
        out.append(f"@SQ\tSN:{t.name}\tLN:{t.size}")
    out.append(f'@PG\tID:BASAL\tVN:{version}\tCL:"{command_line}"')
    return "\n".join(out) + "\n"


def _cigar(L: int, gap_size: int, gap_pos: int) -> str:
    if gap_size == 0:
        return f"{L}M"
    if gap_size > 0:
        return f"{gap_pos}M{gap_size}D{L - gap_pos}M"
    return f"{gap_pos}M{-gap_size}I{L - gap_pos + gap_size}M"


def _xr_context(ref: PackedReference, params: AlignParams, chr_: int, loc: int,
                L: int) -> str:
    """XR:Z: reference context, read span +-2bp with lowercase flanks
    (align.cpp:646-658).  Reads the *forward* plane of the hit's chr pair
    (``bfa[hit->chr & 0xfffe]``)."""
    pair = chr_ >> 1
    base = int(ref.ref_anchor[pair])
    useful = params.rule.useful_nt
    w = ref.ref32[0]
    out = []
    for ii in (2, 1):
        if loc < ii:
            continue
        p = base + loc - ii
        code = (int(w[p // SEGLEN32]) >> (30 - (p % SEGLEN32) * 2)) & 3
        out.append(useful[code + 4])
    for ii in range(L + 2):
        p = base + loc + ii
        code = (int(w[p // SEGLEN32]) >> (30 - (p % SEGLEN32) * 2)) & 3
        out.append(useful[code])
    out[-1] = out[-1].lower() if out[-1].isupper() else out[-1]
    out[-2] = out[-2].lower() if out[-2].isupper() else out[-2]
    return "".join(out)


class SamEmitter:
    """Single-end record formatting + run counters (n_aligned etc.)."""

    def __init__(self, params: AlignParams, ref: PackedReference, rng: MyRand,
                 rrbs_seglen=None):
        self.p = params
        self.ref = ref
        self.rng = rng
        self.rrbs_seglen = rrbs_seglen   # (chr, loc, readlen) -> (ZP, ZL)
        self.n_aligned = 0
        self.n_unique = 0
        self.n_multiple = 0

    def _out_hit(self, read: ReadRec, chain: int, n: int, nsnps: int,
                 hit: Optional[Hit], L: int, out: List[str]):
        """s_OutHit (align.cpp:616-669); n<0 QC, n==0 NM, else mapped."""
        p = self.p
        flag = 0x40 * read.readset
        if n < 0:
            if not p.out_unmap:
                return
            flag |= 0x204
            out.append(f"{read.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{read.seq}\t{read.qual}\n")
            return
        if n == 0:
            if not p.out_unmap:
                return
            flag |= 0x4
            out.append(f"{read.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{read.seq}\t{read.qual}\n")
            return
        chr_, loc, gsz, gpos = hit
        rev_seq = chain ^ (chr_ % 2)
        if n != 1:
            flag |= 0x100
        if rev_seq:
            flag |= 0x010
        seq = revcomp(read.seq) if rev_seq else read.seq
        qual = read.qual[::-1] if rev_seq else read.qual
        cig = _cigar(L, gsz, gpos)
        name = self.ref.titles[chr_ >> 1].name
        rec = (f"{read.name}\t{flag}\t{name}\t{loc + 1}\t255\t{cig}\t*\t0\t0\t"
               f"{seq}\t{qual}\tNM:i:{nsnps}")
        if p.out_ref:
            rec += f"\tXR:Z:{_xr_context(self.ref, p, chr_, loc, L)}"
        if self.rrbs_seglen is not None:
            zp, zl = self.rrbs_seglen(chr_, loc, L)
            rec += f"\tZP:i:{zp}\tZL:i:{zl}"
        rec += f"\tZS:Z:{CHAIN_FLAG[chr_ % 2]}{CHAIN_FLAG[chain]}\n"
        out.append(rec)

    def emit_read(self, read: ReadRec, res: ReadResult, L: int,
                  out: List[str]):
        """StringAlign dispatch (align.cpp:583-612)."""
        p = self.p
        if res.filtered:
            self._out_hit(read, 0, -1, 0, None, L, out)
            return
        total = res.nhits
        if total == 0:
            self._out_hit(read, 0, 0, res.stratum, None, L, out)
            return
        n0 = len(res.hits0)
        if total == 1:
            self.n_aligned += 1
            self.n_unique += 1
            if n0:
                self._out_hit(read, 0, 1, res.stratum, res.hits0[0], L, out)
            else:
                self._out_hit(read, 1, 1, res.stratum, res.hits1[0], L, out)
            return
        self.n_multiple += 1
        if p.report_repeat_hits == 1:
            self.n_aligned += 1
            j = self.rng(read.index) % total
            if j < n0:
                self._out_hit(read, 0, total, res.stratum, res.hits0[j], L, out)
            else:
                self._out_hit(read, 1, total, res.stratum, res.hits1[j - n0], L, out)
        elif p.report_repeat_hits == 2:
            self.n_aligned += 1
            for h in res.hits0:
                self._out_hit(read, 0, total, res.stratum, h, L, out)
            for h in res.hits1:
                self._out_hit(read, 1, total, res.stratum, h, L, out)
        else:
            self._out_hit(read, 0, 0, res.stratum, None, L, out)
