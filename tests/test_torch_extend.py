"""The port's count core == basal_tpu's, on blobs of real encoded waves.

Waves come from a 9 kbp random genome and 96 reads of mixed lengths, every
third read with Ns (test_blob_kernel._make_case), so the blobs carry
exception validity rows and derived length masks.  The port's plain
version runs through the wrapper on CPU tensors and is compared with
basal_tpu's XLA blob entry and its Pallas entry in interpret mode.  Counts
are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from test_blob_kernel import _make_case

CASES = [
    ("C:T", False, False),
    ("C:T", False, True),     # -N: ncnt in rowmeta bits 10-19
    ("A:CGT", False, False),  # multiway: mread plane
    ("C:T", True, False),     # -3: nt3
    ("A:G", False, False),
]
IDS = ["C:T", "C:T-N", "A:CGT", "C:T-3", "A:G"]


def _jax_wave(p, ref, enc, table):
    """basal_tpu's padded blob of the whole candidate table."""
    from basal_tpu.align.pipeline import DeviceContext
    from basal_tpu.ops.extend_pallas import TILE_C
    dev = DeviceContext(ref, p)
    loc = table.loc.astype(np.int32)
    plane = table.plane.astype(np.int32)
    C = loc.shape[0]
    cpad = max(TILE_C, 1 << (C - 1).bit_length())
    used, first_idx = np.unique(table.row, return_index=True)
    U = len(used)
    upad = max(512, 1 << max(U - 1, 1).bit_length()) - U
    roff = np.full(U + 1 + upad, C, np.int32)
    roff[:U] = first_idx
    blob, epad = dev._build_blob(enc, loc, plane, used, roff, cpad - C, upad)
    return dict(dev=dev, loc=loc, plane=plane, used=used, roff=roff, C=C,
                cpad=cpad, upad=upad, Upad=U + upad, epad=epad,
                blob=np.asarray(blob))


@pytest.mark.parametrize("rule,nt3,n_mis", CASES, ids=IDS)
def test_plain_counts_match_xla_and_pallas(tmp_path, rng, rule, nt3, n_mis):
    import jax.numpy as jnp
    from basal_tpu.ops.extend import extend_kernel_blob
    from basal_tpu.ops.extend_pallas import extend_counts_pallas_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob

    p, ref, enc, table = _make_case(tmp_path, rng, rule, 0, nt3, n_mis)
    assert (enc.valid != enc.lenmask).any()  # exception rows present
    w = _jax_wave(p, ref, enc, table)
    nw = ref.ref32.shape[1]
    shape = dict(mode=w["dev"].mode, W=enc.W, nw=nw, C=w["cpad"],
                 U=w["Upad"], E=w["epad"])
    ref32_j = jnp.asarray(ref.ref32.reshape(-1))
    blob_j = jnp.asarray(w["blob"])
    xla = np.asarray(extend_kernel_blob(ref32_j, blob_j, gap=0, **shape))
    pallas = np.asarray(extend_counts_pallas_blob(ref32_j, blob_j,
                                                  interpret=True, **shape))
    ref32_t = torch.from_numpy(ref.ref32.reshape(-1).view(np.int32).copy())
    launches = extend_counts_blob.launches
    got = extend_counts_blob(ref32_t, torch.from_numpy(w["blob"].copy()),
                             **shape)
    assert extend_counts_blob.launches == launches  # CPU: no kernel launch
    assert got.dtype == torch.uint8 and got.shape == (w["cpad"],)
    C = w["C"]
    assert np.array_equal(got.numpy()[:C], xla[:C])
    assert np.array_equal(got.numpy()[:C], pallas[:C])


@pytest.mark.parametrize("rule,nt3,n_mis", CASES, ids=IDS)
def test_blob_builder_byte_equal(tmp_path, rng, rule, nt3, n_mis):
    from basal_tpu_torch.align.pipeline import build_blob

    p, ref, enc, table = _make_case(tmp_path, rng, rule, 0, nt3, n_mis)
    w = _jax_wave(p, ref, enc, table)
    enc._hasn_cache = None  # rebuild the N-row cache on the port's side
    blob, epad = build_blob(enc, w["dev"].mode, w["loc"], w["plane"],
                            w["used"], w["roff"], pad=w["cpad"] - w["C"],
                            upad=w["upad"], epad=w["epad"])
    assert epad == w["epad"]
    assert blob.dtype == np.int32
    assert blob.tobytes() == w["blob"].astype(np.int32).tobytes()


def _many_n_wave(tmp_path, n_reads):
    """A batch whose every read carries an N: more exception rows than the
    12-bit rowmeta field holds.  Candidates from the native engine."""
    import random
    from basal_tpu.config import AlignParams
    from basal_tpu.index.reference import load_reference
    from basal_tpu.index.seedindex import build_index
    from basal_tpu.native import NativeBatch
    from basal_tpu.reads.encode import encode_batch
    from basal_tpu.reads.io import ReadRec
    from conftest import make_ref, random_genome

    rng = random.Random(4094)
    g = random_genome(rng, 9000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    p = AlignParams(conversion="C:T", randseed=1, chains=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    idx = build_index(ref, p)
    reads = []
    for i in range(n_reads):
        ln = rng.choice([64, 80, 100])
        pos = rng.randrange(16, len(g) - ln - 10)
        w = ["T" if (c == "C" and rng.random() < 0.4) else c
             for c in g[pos:pos + ln]]
        w[rng.randrange(20, ln)] = "N"
        reads.append(ReadRec(i, 0, f"r{i}", "".join(w), "I" * ln))
    enc = encode_batch(p, reads)
    nb = NativeBatch(p, idx, ref)
    ridx = np.arange(n_reads, dtype=np.uint32)
    groups, _goff, _total = nb.build_groups(enc, ridx)
    off = np.full(groups.shape[0], -1, dtype=np.int64)
    loc, plane, row = nb.fill_groups(enc, groups,
                                     np.arange(groups.shape[0]), off)
    return p, ref, enc, loc, plane.astype(np.int32), row


@pytest.mark.parametrize("cap", [None, 300])
def test_many_n_rows_split_equals_unsplit(tmp_path, monkeypatch, cap):
    """> MAX_EXC_ROWS N-containing rows: the port splits the wave at row
    boundaries; the counts equal the unsplit plain result and basal_tpu's
    XLA kernel on the whole wave.  ``cap`` lowers the limit to force more
    than two sub-waves."""
    import jax.numpy as jnp
    from basal_tpu.ops.extend import extend_kernel
    from basal_tpu_torch.align import pipeline as tp
    from basal_tpu_torch.ops.extend import _extend_core

    p, ref, enc, loc, plane, row = _many_n_wave(tmp_path, 2600)
    used, first = np.unique(row, return_index=True)
    n_exc = int((enc.valid != enc.lenmask).any(axis=1)[used].sum())
    assert n_exc > tp.MAX_EXC_ROWS
    if cap is not None:
        monkeypatch.setattr(tp, "MAX_EXC_ROWS", cap)

    ctx = tp.TorchDeviceContext(ref, p, "cpu")
    counts, pos0, pos1 = ctx.extend(enc, loc, plane, row)
    assert pos0 is None and pos1 is None
    want_waves = -(-n_exc // tp.MAX_EXC_ROWS)
    assert ctx.up_waves >= max(2, want_waves)

    roff = np.append(first, row.size)
    planes = [torch.from_numpy(a[used].astype(np.int64))
              for a in (enc.base, enc.valid, enc.mread)]
    ncnt = torch.from_numpy(np.repeat(enc.n_count, 2)[used].astype(np.int64))
    unsplit = _extend_core(
        ctx.ref32, torch.from_numpy(loc.astype(np.int64)),
        torch.from_numpy(plane.astype(np.int64)),
        torch.from_numpy(roff.astype(np.int64)), *planes, ncnt,
        mode=ctx.mode, W=enc.W, nw=ctx.nw).numpy()
    assert np.array_equal(counts, unsplit.astype(np.int32))

    rl = np.repeat(enc.map_len, 2)[used].astype(np.int32)
    xla = extend_kernel(
        jnp.asarray(ref.ref32.reshape(-1)), jnp.asarray(loc),
        jnp.asarray(plane), jnp.asarray(roff.astype(np.int32)),
        jnp.asarray(enc.base[used]), jnp.asarray(enc.valid[used]),
        jnp.asarray(enc.mread[used]), jnp.asarray(enc.lenmask[used]),
        jnp.asarray(np.repeat(enc.n_count, 2)[used].astype(np.int32)),
        jnp.asarray(rl), mode=ctx.mode, gap=0, W=enc.W, nw=ctx.nw)
    assert np.array_equal(counts, np.asarray(xla).astype(np.int32))


def test_derive_lenmask_matches_jax():
    import jax.numpy as jnp
    from basal_tpu.ops.extend import derive_lenmask as jl
    from basal_tpu_torch.ops.extend import derive_lenmask as tl
    rl = np.arange(0, 481, dtype=np.int32)
    want = np.asarray(jl(jnp.asarray(rl), 30)).astype(np.int64)
    got = tl(torch.from_numpy(rl.astype(np.int64)), 30).numpy()
    assert np.array_equal(got, want)


def test_wrapper_rejects_bad_inputs():
    from basal_tpu_torch.ops.extend_cuda import blob_words, extend_counts_blob
    ref32 = torch.zeros(2 * 64, dtype=torch.int32)
    shape = dict(mode="oneway", W=7, nw=64, C=4, U=2, E=1)
    good = torch.zeros(blob_words(**{k: v for k, v in shape.items()
                                     if k != "nw"}), dtype=torch.int32)
    assert extend_counts_blob(ref32, good, **shape).shape == (4,)
    with pytest.raises(ValueError, match="holds"):
        extend_counts_blob(ref32, good[:-1].contiguous(), **shape)
    with pytest.raises(ValueError, match="int32"):
        extend_counts_blob(ref32, good.to(torch.int64), **shape)
    with pytest.raises(ValueError, match="mode"):
        extend_counts_blob(ref32, good, **{**shape, "mode": "twoway"})
    with pytest.raises(ValueError, match="2\\*nw"):
        extend_counts_blob(ref32, good, **{**shape, "nw": 65})


def test_wrapper_never_takes_plain_version_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version: on
    a device without a count kernel the wrapper raises."""
    from basal_tpu_torch.ops.extend_cuda import blob_words, extend_counts_blob
    shape = dict(mode="oneway", W=7, nw=64, C=4, U=2, E=1)
    ref32 = torch.zeros(128, dtype=torch.int32, device="meta")
    blob = torch.zeros(blob_words("oneway", 7, 4, 2, 1), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no count kernel"):
        extend_counts_blob(ref32, blob, **shape)


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """Where nvcc is missing the kernel build raises; nothing falls back."""
    from basal_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert not any((tmp_path / "build").rglob("*.so"))
