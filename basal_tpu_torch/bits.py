"""Host-side (numpy) 2-bit word primitives.

These mirror the reference's bit-kernel instruction set (param.h:95-147) on
uint32/uint64 numpy arrays; the device-side JAX twins live in
``basal_tpu.ops.bitops``.  All operate on 2-bit lanes, first base in the most
significant lane.

Copied from ``basal_tpu/bits.py`` at cb4d597: the port imports nothing of
basal_tpu.  Changes: none.
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32
U64 = np.uint64

A32 = U32(0xAAAAAAAA)
F3_32 = U32(0x33333333)
F0F_32 = U32(0xF0F0F0F0)
FF00_32 = U32(0xFF00FF00)
OOFF_32 = U32(0x00FF00FF)
FIVES32 = U32(0x55555555)

POW3 = np.array([3 ** i for i in range(17)], dtype=np.int64)


def xt_collapse32(tt: np.ndarray) -> np.ndarray:
    """Collapse convert-to (11) lanes to convert-from (01): XT32 (param.h:105)."""
    tt = tt.astype(U32, copy=True)
    tt -= (tt << U32(1)) & tt & A32
    return tt


def xt16_base3(tt: np.ndarray) -> np.ndarray:
    """XT (param.h:107-116): collapse 16 2-bit lanes of a u32 and pack them as
    a base-3 integer, first lane most significant."""
    tt = tt.astype(U32, copy=True)
    tt -= (tt << U32(1)) & tt & A32
    tt -= (tt >> U32(2)) & F3_32
    ss = (tt & F0F_32) >> U32(1)
    tt -= ss - (ss >> U32(3))
    ss = (tt & FF00_32) >> U32(2)
    tt = (tt & OOFF_32) + ss + (ss >> U32(2)) + (ss >> U32(6))
    return (tt & U32(0xFFFF)) + (tt >> U32(16)) * U32(6561)


def xc32(tt: np.ndarray) -> np.ndarray:
    """Wildcard mask from ref words: lane 01 (convert-from) stays 01, all else
    11 (XC/XC64, param.h:118-119)."""
    tt = tt.astype(U32, copy=False)
    return ((~tt) << U32(1)) | tt | FIVES32


def m2_judge32(tt: np.ndarray) -> np.ndarray:
    """2-bit-lane saturate: 11 kept, 01/10 -> 00 (M2_judge, param.h:142)."""
    tt = tt.astype(U32, copy=False)
    return tt & (((tt & A32) >> U32(1)) | ((tt & FIVES32) << U32(1)))


def xm32(tt: np.ndarray) -> np.ndarray:
    """Count nonzero 2-bit lanes (XM, param.h:123-127) via popcount."""
    tt = tt.astype(U32, copy=False)
    t = (tt | (tt >> U32(1))) & FIVES32
    t = (t + (t >> U32(2))) & F3_32
    t = (t + (t >> U32(4))) & U32(0x0F0F0F0F)
    return ((t * U32(0x01010101)) >> U32(24)).astype(np.int32)


def seeds_from_words(ref32: np.ndarray, pos: np.ndarray, seed_size: int) -> np.ndarray:
    """Seed value (base-3 collapsed) for each base position ``pos`` of a packed
    u32 plane — the vectorized twin of s_MakeSeed_1 (refbase.cpp:254-259).

    Reads the 16-base window at ``pos`` (spans at most 2 u32 words), collapses
    and packs to base 3, then truncates to the first ``seed_size`` digits.
    """
    w = (pos // 16).astype(np.int64)
    sh = (pos % 16).astype(U64)
    d = (ref32[w].astype(U64) << U64(32)) | ref32[w + 1].astype(U64)
    win = ((d >> (U64(32) - U64(2) * sh)) & U64(0xFFFFFFFF)).astype(U32)
    v = xt16_base3(win)
    if seed_size < 16:
        v = v // U32(3 ** (16 - seed_size))
    return v


def seeds_from_codes(codes: np.ndarray, valid: np.ndarray, seed_size: int):
    """Per-offset seed values and N-contamination flags for read code arrays.

    ``codes``: [..., L] remapped 2-bit codes; ``valid``: [..., L] bool.
    Returns (seedval[..., L-s+1] uint32 base-3, has_n[..., L-s+1] bool) —
    the vectorized twin of the rolling xseed_array/xseedreg_array fill
    (align.cpp:162-175).
    """
    s = seed_size
    coll = np.where(codes == 3, 1, codes).astype(np.int32)
    n = codes.shape[-1] - s + 1
    if n <= 0:
        shape = codes.shape[:-1] + (0,)
        return np.zeros(shape, np.uint32), np.zeros(shape, bool)
    val = np.zeros(codes.shape[:-1] + (n,), dtype=np.int32)
    pw = POW3.astype(np.int32)
    for j in range(s):
        val += coll[..., j:j + n] * pw[s - 1 - j]
    # N flag per window via prefix sums of the invalid mask; fast path when
    # the batch has no invalid bases at all (the common case)
    inv = ~valid
    if not inv.any():
        return val.astype(np.uint32), np.zeros(val.shape, bool)
    csum = np.zeros(codes.shape[:-1] + (codes.shape[-1] + 1,), dtype=np.int32)
    np.cumsum(inv, axis=-1, out=csum[..., 1:])
    bad = (csum[..., s:] - csum[..., :n]) > 0
    return val.astype(np.uint32), bad


def pack_planes_u32(codes: np.ndarray, nwords: int) -> np.ndarray:
    """Pack [..., L] 2-bit codes into [..., nwords] u32 words (16 bases each,
    first base in bits 31:30); positions beyond L are zero."""
    L = codes.shape[-1]
    pad = nwords * 16 - L
    if pad:
        codes = np.concatenate(
            [codes, np.zeros(codes.shape[:-1] + (pad,), dtype=codes.dtype)], axis=-1)
    c = codes.reshape(codes.shape[:-1] + (nwords, 16)).astype(U32)
    shifts = np.arange(30, -2, -2, dtype=U32)
    return np.bitwise_or.reduce(c << shifts, axis=-1)
