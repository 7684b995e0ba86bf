"""Random-number parity with the reference (myrand, utilities.cpp:36-48).

With ``-S n`` (randseed != 0) the reference uses a stateless splittable hash
of (read_index, seed): every myrand call for the same read returns the same
value, making multi-hit selection and candidate-scan starts reproducible
regardless of thread schedule.  Replicated bit-for-bit here.

With ``-S 0`` the reference calls rand_r seeded from getpid()*time(NULL) —
irreproducible by design; we substitute numpy's PCG64 (outputs are valid
alignments but not byte-comparable, exactly like two reference runs differ).

Copied from ``basal_tpu/align/rng.py`` at cb4d597: the port imports nothing
of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
_M1 = U64(3935559000370003845)
_A1 = U64(2691343689449507681)
_M2 = U64(4768777513237032717)


def myrand_hash(read_index, randseed: int):
    """Vectorized splittable hash (utilities.cpp:41-46).  ``read_index`` may
    be a scalar or ndarray; returns uint32 value(s)."""
    with np.errstate(over="ignore"):
        base = U64(np.uint32(np.uint32(randseed) * np.uint32(1000000)))
        v = (np.asarray(read_index, dtype=U64) + base) * _M1 + _A1
        v ^= v >> U64(21)
        v ^= v << U64(37)
        v ^= v >> U64(4)
        v = v * _M2
        v ^= v << U64(20)
        v ^= v >> U64(41)
        v ^= v << U64(5)
    return (v & U64(0xFFFFFFFF)).astype(np.uint32)


_MASK64 = (1 << 64) - 1


def _myrand_scalar(read_index: int, randseed: int) -> int:
    """Pure-int twin of myrand_hash for single calls: the numpy scalar
    path (errstate + asarray per call) measured ~16 us/call and dominated
    PE unpaired-end emission; this is ~0.5 us with identical bits."""
    base = ((randseed & 0xFFFFFFFF) * 1000000) & 0xFFFFFFFF
    v = ((read_index + base) * 3935559000370003845
         + 2691343689449507681) & _MASK64
    v ^= v >> 21
    v = (v ^ (v << 37)) & _MASK64
    v ^= v >> 4
    v = (v * 4768777513237032717) & _MASK64
    v = (v ^ (v << 20)) & _MASK64
    v ^= v >> 41
    v = (v ^ (v << 5)) & _MASK64
    return v & 0xFFFFFFFF


class MyRand:
    """Per-aligner RNG façade mirroring myrand's two modes."""

    def __init__(self, randseed: int):
        self.randseed = randseed
        self._rng = np.random.Generator(np.random.PCG64())

    def __call__(self, read_index: int) -> int:
        if self.randseed == 0:
            return int(self._rng.integers(0, 1 << 31))
        return _myrand_scalar(int(read_index), self.randseed)
