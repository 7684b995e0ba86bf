"""basal_tpu_torch.ops.bitops == basal_tpu.ops.bitops on random u32 words.

The port holds u32 words as int64 values in [0, 2**32) with a SWAR
popcount; the JAX functions run on uint32.  Integer results: equality is
exact.  Words are drawn from numpy with a fixed seed and include every
word with bit 31 set, all-zero and all-one words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basal_tpu.ops import bitops as jb
from basal_tpu_torch.ops import bitops as tb

N = 4096


def _words(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    w[:64] |= np.uint32(1 << 31)                 # bit 31 set
    w[64:72] = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
                         0xAAAAAAAA, 0x55555555, 1, 0xC0000000], np.uint32)
    return w


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


UNARY = ["xt32", "xc32", "m2_judge32", "xm32", "lane_flags"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches_jax(name):
    w = _words(1)
    want = np.asarray(getattr(jb, name)(jnp.asarray(w))).astype(np.int64)
    got = getattr(tb, name)(_t(w)).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["oneway", "nt3"])
def test_two_plane_rules_match_jax(name):
    base, ref = _words(2), _words(3)
    fn_j = getattr(jb, f"mismatch_words_{name}")
    fn_t = getattr(tb, f"mismatch_words_{name}")
    want = np.asarray(fn_j(jnp.asarray(base), jnp.asarray(ref)))
    got = fn_t(_t(base), _t(ref)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_multiway_rule_matches_jax():
    base, ref, mread = _words(4), _words(5), _words(6)
    want = np.asarray(jb.mismatch_words_multiway(
        jnp.asarray(base), jnp.asarray(ref), jnp.asarray(mread)))
    got = tb.mismatch_words_multiway(_t(base), _t(ref), _t(mread)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_popcount32_matches_numpy():
    w = _words(7)
    want = np.array([bin(int(x)).count("1") for x in w], np.int64)
    assert np.array_equal(tb.popcount32(_t(w)).numpy(), want)


def test_u32_widens_int32_bit_patterns():
    w = _words(8)
    got = tb.u32(torch.from_numpy(w.view(np.int32))).numpy()
    assert np.array_equal(got, w.astype(np.int64))
