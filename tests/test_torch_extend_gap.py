"""The port's gapped core == basal_tpu's, on blobs of real gapped waves.

Waves come from a 9 kbp random genome and 80 reads of 64-150 bp with
planted deletions and insertions (test_differential_gap's generators), the
rule's conversions and Ns, so the blobs carry exception validity rows,
derived length masks and rows with more than K_POS = 14 mismatches.  The
port's plain version runs through the wrapper on CPU tensors and is
compared with basal_tpu's XLA blob entry and its Pallas gap entry in
interpret mode, on the same blob.  Counts and positions are integers:
equality is exact.
"""

import random

import numpy as np
import pytest
import torch

from conftest import make_ref, random_genome
from test_differential_gap import deletion_reads, insertion_reads

CASES = {
    "T:- g3": ("T:-", 3, False, False),
    "C:T g1": ("C:T", 1, False, False),
    "A:CGT g2": ("A:CGT", 2, False, False),
    "C:T -3 g2": ("C:T", 2, True, False),
    "C:T -N g1": ("C:T", 1, False, True),
}


def _gap_case(tmp_path, rule, gap, nt3=False, n_mis=False, n_reads=80,
              seed=2026):
    """Encoded reads with planted gaps and their candidates (native
    engine, rows non-decreasing)."""
    from basal_tpu.config import AlignParams
    from basal_tpu.index.reference import load_reference
    from basal_tpu.index.seedindex import build_index
    from basal_tpu.native import NativeBatch
    from basal_tpu.reads.encode import encode_batch
    from basal_tpu.reads.io import ReadRec

    rng = random.Random(seed)
    g = random_genome(rng, 9000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    p = AlignParams(conversion=rule, randseed=1, gap=gap, nt3=nt3,
                    n_mis=n_mis, chains=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    index = build_index(ref, p)
    frm, tos = rule.split(":")
    tos = tos.replace("-", "")
    raw = (deletion_reads(rng, g, n_reads // 2, 150, frm=frm, max_del=gap)
           + insertion_reads(rng, g, n_reads - n_reads // 2, 150,
                             max_ins=gap))
    reads = []
    for i, (name, s) in enumerate(raw):
        w = list(s[:rng.randrange(64, 151)])
        if tos:
            w = [rng.choice(tos) if c == frm and rng.random() < 0.4 else c
                 for c in w]
        if i % 4 == 0:  # Ns: exception validity rows in the blob
            for _ in range(rng.randrange(1, 3)):
                w[rng.randrange(len(w))] = "N"
        reads.append(ReadRec(i, 0, name, "".join(w), "I" * len(w)))
    enc = encode_batch(p, reads)
    nb = NativeBatch(p, index, ref)
    groups, _goff, _total = nb.build_groups(enc, np.arange(len(reads),
                                                          dtype=np.uint32))
    off = np.full(groups.shape[0], -1, dtype=np.int64)
    loc, plane, row = nb.fill_groups(enc, groups,
                                     np.arange(groups.shape[0]), off)
    assert loc.size > 200
    return p, ref, enc, loc, plane.astype(np.int32), row


def _padded_blob(enc, mode, loc, plane, row):
    """The port's build_blob with basal_tpu's padding of C, U and E."""
    from basal_tpu.ops.extend_pallas import TILE_C
    from basal_tpu_torch.align.pipeline import _hasn, build_blob
    C = loc.shape[0]
    cpad = max(TILE_C, 1 << (C - 1).bit_length())
    used, first = np.unique(row, return_index=True)
    U = len(used)
    upad = max(512, 1 << max(U - 1, 1).bit_length()) - U
    roff = np.full(U + 1 + upad, C, np.int32)
    roff[:U] = first
    E = int(_hasn(enc)[used].sum())
    epad = max(8, 1 << max(E - 1, 1).bit_length())
    blob, _ = build_blob(enc, mode, loc, plane, used, roff, pad=cpad - C,
                         upad=upad, epad=epad)
    return blob, dict(C=cpad, U=U + upad, E=epad)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_gap_matches_xla_and_pallas(tmp_path, case):
    import jax.numpy as jnp
    from basal_tpu.ops.extend import extend_kernel_blob
    from basal_tpu.ops.extend_pallas import extend_gap_pallas_blob
    from basal_tpu_torch.align.pipeline import _mode_name
    from basal_tpu_torch.ops.extend import K_POS
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob

    rule, gap, nt3, n_mis = CASES[case]
    p, ref, enc, loc, plane, row = _gap_case(tmp_path, rule, gap, nt3, n_mis)
    assert (enc.valid != enc.lenmask).any()  # exception rows present
    mode = _mode_name(p)
    blob, pads = _padded_blob(enc, mode, loc, plane, row)
    nw = ref.ref32.shape[1]
    shape = dict(mode=mode, gap=gap, W=enc.W, nw=nw, **pads)
    ref32_j = jnp.asarray(ref.ref32.reshape(-1))
    blob_j = jnp.asarray(blob)
    xla = [np.asarray(a) for a in extend_kernel_blob(ref32_j, blob_j,
                                                     **shape)]
    pallas = [np.asarray(a) for a in extend_gap_pallas_blob(
        ref32_j, blob_j, interpret=True, **shape)]
    ref32_t = torch.from_numpy(ref.ref32.reshape(-1).view(np.int32).copy())
    launches = extend_gap_blob.launches
    got = extend_gap_blob(ref32_t, torch.from_numpy(blob), **shape)
    assert extend_gap_blob.launches == launches  # CPU: no kernel launch
    cpad = pads["C"]
    assert [t.dtype for t in got] == [torch.uint8, torch.int16, torch.int16]
    assert [tuple(t.shape) for t in got] == [
        (cpad,), (cpad, K_POS), (cpad, 2 * gap, K_POS)]
    C = loc.shape[0]
    for name, a, x, pl in zip(("counts", "pos0", "pos1"), got, xla, pallas):
        assert np.array_equal(a.numpy()[:C], x[:C]), name
        assert np.array_equal(a.numpy()[:C], pl[:C]), name
    # not degenerate: full lists (>= 14 mismatches) in the main and the
    # shifted alignments, and exact hits
    counts, pos0, pos1 = (t.numpy()[:C].astype(np.int64) for t in got)
    rl = np.repeat(enc.map_len, 2)[row]
    assert (pos0[:, -1] < rl).any() and (pos1[:, :, -1] < rl[:, None]).any()
    assert (counts == 0).any()


def _random_flags(seed, C=400, W=9):
    """Flag words with rows of every density (none, a few, more than
    K_POS mismatches), read lengths 0..16*W and bits past the read end."""
    rng = np.random.default_rng(seed)
    dens = rng.choice([0.0, 0.02, 0.1, 0.5, 1.0], size=C)
    lanes = rng.random((C, W, 16)) < dens[:, None, None]
    pat = rng.integers(1, 4, size=(C, W, 16))  # nonzero 2-bit lanes
    sh = np.arange(30, -2, -2)
    words = (np.where(lanes, pat, 0) << sh).sum(axis=2).astype(np.uint32)
    readlen = rng.integers(0, 16 * W + 1, C).astype(np.int32)
    return words, readlen


@pytest.mark.parametrize("reverse", [False, True])
def test_first_positions_matches_jax(reverse):
    import jax.numpy as jnp
    from basal_tpu.ops.extend import _first_positions as jfp
    from basal_tpu.ops.extend import derive_lenmask as jlm
    from basal_tpu_torch.ops.extend import K_POS, _first_positions

    W = 9
    words, readlen = _random_flags(7 + reverse, W=W)
    lm = np.asarray(jlm(jnp.asarray(readlen), W))
    masked = words & lm                       # lanes past the end masked
    want = np.asarray(jfp(jnp.asarray(masked), jnp.asarray(readlen), W,
                          reverse))
    got = _first_positions(torch.from_numpy(masked.astype(np.int64)),
                           torch.from_numpy(readlen.astype(np.int64)), W,
                           reverse)
    assert got.dtype == torch.int32 and got.shape == (len(readlen), K_POS)
    assert np.array_equal(got.numpy(), want)
    full = (want[:, -1] < readlen).sum()
    empty = (want[:, 0] == readlen).sum()
    assert full > 20 and empty > 20            # long and empty lists
    assert (readlen < 16 * W).any() and (words != masked).any()


@pytest.mark.parametrize("gap", [1, 2, 3])
def test_shift_offsets_every_phase(gap):
    """loc & 15 at 0, 1, 14 and 15 with every shift: the shifted word
    offset and bit shift (sh2 + 2s from -6 to 36) against XLA."""
    import jax.numpy as jnp
    from basal_tpu.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob

    rng = np.random.default_rng(gap)
    W, nw, U = 7, 512, 16
    phase = np.array([0, 1, 14, 15])
    C = 4 * U * 4
    loc = (16 * rng.integers(8, nw - W - 8, C) + np.tile(phase, C // 4))
    plane = rng.integers(0, 2, C).astype(np.uint32)
    readlen = rng.integers(60, 16 * W + 1, U).astype(np.uint32)
    blob = np.concatenate([
        (loc.astype(np.uint32) | (plane << np.uint32(31))).view(np.int32),
        np.arange(0, C + 1, C // U, dtype=np.int32),
        readlen.view(np.int32),
        rng.integers(0, 1 << 32, U * W + W, dtype=np.uint32).view(np.int32)])
    ref32 = rng.integers(0, 1 << 32, 2 * nw, dtype=np.uint32)
    shape = dict(mode="oneway", gap=gap, W=W, nw=nw, C=C, U=U, E=1)
    want = extend_kernel_blob(jnp.asarray(ref32), jnp.asarray(blob), **shape)
    got = extend_gap_blob(torch.from_numpy(ref32.view(np.int32)),
                          torch.from_numpy(blob), **shape)
    for name, a, b in zip(("counts", "pos0", "pos1"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def test_gap_wave_split_at_lowered_cap(tmp_path, monkeypatch):
    """A gapped wave cut at row boundaries (MAX_EXC_ROWS lowered): counts,
    pos0 and pos1 equal the unsplit plain core and basal_tpu's XLA kernel
    on the whole wave."""
    import jax.numpy as jnp
    from basal_tpu.ops.extend import extend_kernel
    from basal_tpu_torch.align import pipeline as tp
    from basal_tpu_torch.ops.extend import _extend_core, derive_lenmask

    p, ref, enc, loc, plane, row = _gap_case(tmp_path, "T:-", 3)
    used, first = np.unique(row, return_index=True)
    n_exc = int(tp._hasn(enc)[used].sum())
    monkeypatch.setattr(tp, "MAX_EXC_ROWS", 3)
    ctx = tp.TorchDeviceContext(ref, p, "cpu")
    counts, pos0, pos1 = ctx.extend(enc, loc, plane, row)
    assert ctx.up_waves >= -(-n_exc // 3) >= 2
    assert [a.dtype for a in (counts, pos0, pos1)] == [np.int32] * 3

    roff = np.append(first, row.size)
    rl = np.repeat(enc.map_len, 2)[used].astype(np.int64)
    planes = [torch.from_numpy(a[used].astype(np.int64))
              for a in (enc.base, enc.valid, enc.mread)]
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    unsplit = _extend_core(
        ctx.ref32, t(loc), t(plane), t(roff), *planes,
        t(np.repeat(enc.n_count, 2)[used]), mode=ctx.mode, W=enc.W,
        nw=ctx.nw, gap=3, lenmask=derive_lenmask(t(rl), enc.W),
        readlen=t(rl))
    xla = extend_kernel(
        jnp.asarray(ref.ref32.reshape(-1)), jnp.asarray(loc),
        jnp.asarray(plane), jnp.asarray(roff.astype(np.int32)),
        jnp.asarray(enc.base[used]), jnp.asarray(enc.valid[used]),
        jnp.asarray(enc.mread[used]), jnp.asarray(enc.lenmask[used]),
        jnp.asarray(np.repeat(enc.n_count, 2)[used].astype(np.int32)),
        jnp.asarray(rl.astype(np.int32)), mode=ctx.mode, gap=3, W=enc.W,
        nw=ctx.nw)
    for name, a, u, x in zip(("counts", "pos0", "pos1"),
                             (counts, pos0, pos1), unsplit, xla):
        assert np.array_equal(a, u.numpy().astype(np.int32)), name
        assert np.array_equal(a, np.asarray(x).astype(np.int32)), name


@pytest.mark.parametrize("gap", [0, 2])
def test_fetch_of_no_waves_keeps_the_contract(tmp_path, gap):
    """Zero candidates: the fetch still returns basal_tpu's shapes, which
    the strata ladder sizes its buffers from."""
    from basal_tpu.config import AlignParams
    from basal_tpu.index.reference import load_reference
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.ops.extend import K_POS

    make_ref(tmp_path / "ref.fa", [("c1", random_genome(random.Random(1),
                                                        3000))])
    p = AlignParams(conversion="T:-", randseed=1, gap=gap)
    ctx = TorchDeviceContext(load_reference(str(tmp_path / "ref.fa"), p), p,
                             "cpu")
    z = np.zeros(0, np.int32)
    counts, pos0, pos1 = ctx.extend(None, z, z, z)
    assert counts.shape == (0,) and counts.dtype == np.int32
    if gap:
        assert pos0.shape == (0, K_POS) and pos1.shape == (0, 2 * gap, K_POS)
        assert pos0.dtype == pos1.dtype == np.int32
    else:
        assert pos0 is None and pos1 is None
    assert ctx.up_waves == 0
