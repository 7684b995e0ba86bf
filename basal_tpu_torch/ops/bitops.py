"""2-bit lane primitives on torch tensors.

PyTorch counterpart of ``basal_tpu.ops.bitops``.  A u32 lane word is held
in an int64 tensor with a value in [0, 2**32): PyTorch's uint32 lacks
``>>``, ``<<`` and ``~`` on the CPU, int32 ``>>`` is arithmetic, and there
is no popcount operator, so every function here keeps its result masked to
32 bits and counts bits with a SWAR popcount.  These are the plain versions
that the CUDA count kernel (``csrc/count_kernel.cu``) is held against.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
A32 = 0xAAAAAAAA
FIVES = 0x55555555


def u32(t: torch.Tensor) -> torch.Tensor:
    """Widen int32/uint32-bit-pattern words to int64 values in [0, 2**32)."""
    return t.to(torch.int64) & M32


def popcount32(t: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR; ``t`` int64 in [0, 2**32))."""
    t = t - ((t >> 1) & FIVES)
    t = (t & 0x33333333) + ((t >> 2) & 0x33333333)
    t = (t + (t >> 4)) & 0x0F0F0F0F
    return ((t * 0x01010101) >> 24) & 0xFF


def xt32(tt: torch.Tensor) -> torch.Tensor:
    """Collapse convert-to (11) lanes to convert-from (01)."""
    return (tt - ((tt << 1) & tt & A32)) & M32


def xt16_base3(tt: torch.Tensor) -> torch.Tensor:
    """Collapse the 16 lanes of a word and read them as a base-3 integer,
    first lane most significant (``bits.xt16_base3``; no step leaves
    [0, 2**32))."""
    tt = xt32(tt)
    tt = tt - ((tt >> 2) & 0x33333333)
    ss = (tt & 0xF0F0F0F0) >> 1
    tt = tt - (ss - (ss >> 3))
    ss = (tt & 0xFF00FF00) >> 2
    tt = (tt & 0x00FF00FF) + ss + (ss >> 2) + (ss >> 6)
    return (tt & 0xFFFF) + (tt >> 16) * 6561


def xc32(tt: torch.Tensor) -> torch.Tensor:
    """Per-lane wildcard mask: 01 where the ref lane is 01, else 11."""
    return (((~tt) << 1) | tt | FIVES) & M32


def m2_judge32(tt: torch.Tensor) -> torch.Tensor:
    """Saturate 2-bit lanes: 11 kept, 01/10 -> 00."""
    return tt & (((tt & A32) >> 1) | ((tt & FIVES) << 1))


def lane_flags(tt: torch.Tensor) -> torch.Tensor:
    """Reduce each 2-bit lane to one bit at the lane's low position."""
    return (tt | (tt >> 1)) & FIVES


def xm32(tt: torch.Tensor) -> torch.Tensor:
    """Count nonzero 2-bit lanes."""
    return popcount32(lane_flags(tt))


def mismatch_words_oneway(base: torch.Tensor, refw: torch.Tensor) -> torch.Tensor:
    """One-way conversion rule: read-11 vs ref-01 XORs to zero."""
    return (base & xc32(refw)) ^ refw


def mismatch_words_multiway(base: torch.Tensor, refw: torch.Tensor,
                            mread: torch.Tensor) -> torch.Tensor:
    """Multi-way rule: M2 = XC(ref) | Mread; M3 = judge(M2);
    M4 = ((~M3 & M2) | (M3 & read)) ^ ref."""
    m2 = xc32(refw) | mread
    m3 = m2_judge32(m2)
    return ((((~m3) & m2) | (m3 & base)) ^ refw) & M32


def mismatch_words_nt3(base_xt: torch.Tensor, refw: torch.Tensor) -> torch.Tensor:
    """Three-letter mode (-3): both sides XT-collapsed, plain XOR."""
    return base_xt ^ xt32(refw)
