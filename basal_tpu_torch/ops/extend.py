"""Candidate extension: the plain PyTorch versions of the count and gap cores.

PyTorch counterpart of ``basal_tpu.ops.extend``.  Per candidate (ref plane
p, concatenated base loc, read-chain row r):

  1. gather the reference window words at ``p*nw + (loc >> 4)`` (W+1
     words; gapped: W+3 words from one word earlier),
  2. funnel-shift them onto the read word grid by ``2*(loc & 15)``,
  3. apply the conversion-mask algebra and count the 2-bit mismatch lanes,
  4. add the row's N-count and clamp to 255 (u8 result).

Gapped (``gap > 0``) it also returns the first K_POS mismatch positions of
the main alignment in ascending read order (``pos0``) and, for each of the
2*gap alignments shifted by -1, +1, -2, +2, ..., the first K_POS positions
as distance from the read end (``pos1``); both are masked by the length
mask and padded with the read length.

u32 words are int64 values in [0, 2**32) (see ``ops.bitops``).  These are
the CPU paths of ``ops.extend_cuda.extend_counts_blob`` and
``extend_gap_blob`` and the versions that the CUDA kernels are compared
with on the card.
"""

from __future__ import annotations

import torch

from .bitops import (M32, lane_flags, mismatch_words_multiway,
                     mismatch_words_nt3, mismatch_words_oneway, u32, xm32)

MODES = ("oneway", "multiway", "nt3")
K_POS = 14  # MAXSNPS - 1: the most mismatch positions a gapped scan reads


def _align_words(R: torch.Tensor, off: torch.Tensor, sh2: torch.Tensor,
                 W: int) -> torch.Tensor:
    """A[w] = (R[off+w] << sh2) | ((R[off+w+1] >> (31-sh2)) >> 1).

    R: [C, Wg] gathered words; off: [C] first-word offset into R;
    sh2: [C] bit shift (2 * base offset).  Returns [C, W]."""
    idx = off[:, None] + torch.arange(W + 1, device=R.device)[None, :]
    r = torch.gather(R, 1, idx)
    sh = sh2[:, None]
    return ((r[:, :W] << sh) & M32) | ((r[:, 1:] >> (31 - sh)) >> 1)


def _rule_flags(mode: str, base, refw, mread):
    if mode == "oneway":
        return mismatch_words_oneway(base, refw)
    if mode == "multiway":
        return mismatch_words_multiway(base, refw, mread)
    if mode == "nt3":
        return mismatch_words_nt3(base, refw)
    raise ValueError(mode)


def candidate_rows(row_off: torch.Tensor, C: int) -> torch.Tensor:
    """Row of each candidate: searchsorted(row_off, i, 'right') - 1, clamped
    to [0, U-1] so that padded tail candidates read an existing row."""
    i = torch.arange(C, dtype=row_off.dtype, device=row_off.device)
    row = torch.searchsorted(row_off, i, right=True) - 1
    return row.clamp(0, row_off.shape[0] - 2)


def _first_positions(flagw: torch.Tensor, fill: torch.Tensor, W: int,
                     reverse: bool) -> torch.Tensor:
    """First K_POS mismatch lane positions of [C, W] flag words: ascending
    read position, or (``reverse``) ascending distance from the read end,
    reported as fill-1-p.  ``fill`` [C] is the read length and pads short
    lists.  Positions are unique within a row and the pads equal, so the
    K smallest scores in order are ``sorted()[:K]``.  Returns int32."""
    bits = lane_flags(flagw)
    shifts = torch.arange(30, -2, -2, device=flagw.device)  # lane 0 first
    lane_bits = ((bits[:, :, None] >> shifts) & 1).reshape(-1, W * 16)
    lane_idx = torch.arange(W * 16, device=flagw.device)[None, :]
    pos = fill[:, None] - 1 - lane_idx if reverse else lane_idx
    score = torch.where(lane_bits != 0, pos, fill[:, None]).to(torch.int32)
    return torch.topk(score, K_POS, dim=1, largest=False, sorted=True).values


def _extend_core(ref32, loc, plane, row_off, base, valid, mread, ncnt, *,
                 mode: str, W: int, nw: int, gap: int = 0, lenmask=None,
                 readlen=None):
    """Mismatch counts of C candidates against the packed reference.

    ref32:   int32 [2*nw] (fwd plane then RC plane)
    loc:     int64 [C] concatenated base coords (alignment start)
    plane:   int64 [C] ref strand plane (0 fwd / 1 RC)
    row_off: int64 [U+1] candidate offsets of the active rows
    base/valid/mread: int64 [U, W] u32 read planes (mread multiway only)
    ncnt:    int64 [U] N-count additive term (-N)
    lenmask, readlen: int64 [U, W] / [U], gapped only

    Returns u8 [C], and with ``gap > 0`` also pos0 i16 [C, K_POS] and pos1
    i16 [C, 2*gap, K_POS].  Gather indices are clamped to the reference
    like the CUDA kernels'; the reference's margins keep real candidates
    inside."""
    C = loc.shape[0]
    row = candidate_rows(row_off, C)
    wg = W + 3 if gap else W + 1
    k0 = (loc >> 4) - (1 if gap else 0)
    idx = (plane * nw + k0)[:, None] + torch.arange(wg, device=loc.device)
    R = u32(ref32[idx.clamp(0, ref32.shape[0] - 1)])        # [C, wg]
    sh2 = (loc & 15) << 1
    A = _align_words(R, torch.full_like(loc, 1 if gap else 0), sh2, W)
    b = base[row]
    v = valid[row]
    mr = mread[row] if mode == "multiway" else None
    flags = _rule_flags(mode, b, A, mr)
    counts = ncnt[row] + xm32(flags & v).sum(dim=1)
    counts8 = counts.clamp(max=255).to(torch.uint8)
    if not gap:
        return counts8

    lm = lenmask[row]
    L = readlen[row]
    pos0 = _first_positions(flags & lm, L, W, reverse=False)
    pos1 = []
    for tt in range(1, 2 * gap + 1):
        t = (tt + 1) // 2
        loc_s = loc + (t if tt % 2 == 0 else -t)    # odd -> -t, even -> +t
        off_s = (loc_s >> 4) - k0                   # 0, 1 or 2
        A_s = _align_words(R, off_s, (loc_s & 15) << 1, W)
        flags_s = _rule_flags(mode, b, A_s, mr)
        pos1.append(_first_positions(flags_s & lm, L, W, reverse=True))
    return (counts8, pos0.to(torch.int16),
            torch.stack(pos1, dim=1).to(torch.int16))


def derive_lenmask(readlen: torch.Tensor, W: int) -> torch.Tensor:
    """[U, W] u32 length mask (0b11 per in-length base, first base at bits
    31:30) from per-row read lengths.  16 full lanes are special-cased:
    a shift by 32 is undefined in C and the kernel follows this."""
    w16 = 16 * torch.arange(W, dtype=readlen.dtype, device=readlen.device)
    lanes = (readlen[:, None] - w16[None, :]).clamp(0, 16)
    full = torch.full_like(lanes, M32)
    return torch.where(lanes >= 16, full,
                       full ^ (full >> (2 * lanes.clamp(max=15))))


def carve_blob(blob: torch.Tensor, *, mode: str, W: int, C: int, U: int,
               E: int):
    """Unpack the single-transfer wave blob (int32 [C + 2U+1 + planes]):

      loc_packed [C]    (strand plane << 31) | loc
      row_off    [U+1]
      rowmeta    [U]    (exc_idx+1 << 20) | (ncnt << 10) | readlen
      base       [U*W]  u32 bit patterns
      mread      [U*W]  (multiway only)
      exc_valid  [E*W]  validity rows of N-containing reads (E >= 1)

    Rows without Ns have valid == lenmask, so only exception rows ship a
    validity plane.  Returns (loc, plane, row_off, base, valid, mread,
    lenmask, ncnt, readlen) as int64 tensors."""
    b = blob.to(torch.int64)
    locp = b[:C] & M32
    plane = locp >> 31
    loc = locp & 0x7FFFFFFF
    row_off = b[C:C + U + 1]
    nl = b[C + U + 1:C + 2 * U + 1]
    readlen = nl & 1023
    ncnt = (nl >> 10) & 1023
    exc = (nl >> 20) & 0xFFF
    rest = b[C + 2 * U + 1:] & M32
    base = rest[:U * W].reshape(U, W)
    k = 1
    if mode == "multiway":
        mread = rest[U * W:2 * U * W].reshape(U, W)
        k = 2
    else:
        mread = torch.zeros((1, W), dtype=torch.int64, device=blob.device)
    excv = rest[k * U * W:k * U * W + E * W].reshape(E, W)
    lm = derive_lenmask(readlen, W)
    valid = torch.where((exc > 0)[:, None],
                        excv[(exc - 1).clamp(min=0)], lm)
    return loc, plane, row_off, base, valid, mread, lm, ncnt, readlen


def extend_kernel_blob(ref32: torch.Tensor, blob: torch.Tensor, *, mode: str,
                       W: int, nw: int, C: int, U: int, E: int, gap: int = 0):
    """One wave blob through the plain core: counts u8 [C], and with
    ``gap > 0`` the tuple (counts, pos0 i16 [C, K_POS], pos1 i16
    [C, 2*gap, K_POS])."""
    (loc, plane, row_off, base, valid, mread, lm, ncnt,
     rl) = carve_blob(blob, mode=mode, W=W, C=C, U=U, E=E)
    return _extend_core(ref32, loc, plane, row_off, base, valid, mread, ncnt,
                        mode=mode, W=W, nw=nw, gap=gap, lenmask=lm,
                        readlen=rl)
