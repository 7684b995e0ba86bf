"""The CUDA count and gap kernels on the card == their plain PyTorch versions.

Marked ``cuda``: each test skips where torch finds no card.  This file
imports neither jax nor conftest, so that it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Counts and mismatch positions are integers: equality is exact.
"""

import io

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_blob(mode, C, U, W, E, nw, seed, readlen=None):
    """A wave blob with random rows: read lengths 0..16*W (every row
    ``readlen`` when given), N-counts, E exception rows, candidates spread
    over both planes and the whole reference (margins included)."""
    from basal_tpu_torch.ops.extend_cuda import blob_words
    rng = np.random.default_rng(seed)
    loc = rng.integers(0, 16 * (nw - W - 1), C).astype(np.uint32)
    plane = rng.integers(0, 2, C).astype(np.uint32)
    cuts = np.sort(rng.integers(1, C, U - 1)) if U > 1 else np.zeros(0, int)
    row_off = np.concatenate([[0], cuts, [C]]).astype(np.int32)
    readlen = (rng.integers(0, 16 * W + 1, U) if readlen is None
               else np.full(U, readlen)).astype(np.uint32)
    ncnt = rng.integers(0, 8, U).astype(np.uint32)
    exc = np.zeros(U, np.uint32)
    rows = rng.choice(U, size=min(E, U), replace=False)
    exc[rows] = 1 + np.arange(rows.size, dtype=np.uint32)
    rowmeta = (exc << 20) | (ncnt << 10) | readlen
    n_planes = 2 if mode == "multiway" else 1
    blob = np.concatenate([
        (loc | (plane << np.uint32(31))).view(np.int32), row_off,
        rowmeta.view(np.int32),
        rng.integers(0, 1 << 32, n_planes * U * W + E * W,
                     dtype=np.uint32).view(np.int32)])
    assert blob.size == blob_words(mode, W, C, U, E)
    ref32 = rng.integers(0, 1 << 32, 2 * nw, dtype=np.uint32).view(np.int32)
    return ref32, blob, dict(mode=mode, W=W, nw=nw, C=C, U=U, E=E)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("C,U,W,E", [(1, 1, 4, 1), (1000, 37, 7, 5),
                                     (65_537, 4000, 10, 4094),
                                     (200_003, 513, 30, 1)])
def test_kernel_equals_plain(cuda, mode, C, U, W, E):
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    ref32, blob, shape = _random_blob(mode, C, U, W, E, nw=1 << 16,
                                      seed=C + W)
    r, b = torch.from_numpy(ref32).to(cuda), torch.from_numpy(blob).to(cuda)
    before = extend_counts_blob.launches
    got = extend_counts_blob(r, b, **shape)
    torch.cuda.synchronize()
    assert extend_counts_blob.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    want_dev = extend_kernel_blob(r, b, **shape)
    want_cpu = extend_counts_blob(torch.from_numpy(ref32),
                                  torch.from_numpy(blob), **shape)
    assert extend_counts_blob.launches == before + 1  # CPU call: no launch
    assert torch.equal(got, want_dev)
    assert torch.equal(got.cpu(), want_cpu)


def _count_against_plain(cuda, ref32, blob, shape):
    """The count kernel's counts on the card, asserted equal to the plain
    version's on the same tensors; returned on the CPU."""
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    r, b = torch.from_numpy(ref32).to(cuda), torch.from_numpy(blob).to(cuda)
    before = extend_counts_blob.launches
    got = extend_counts_blob(r, b, **shape)
    torch.cuda.synchronize()
    assert extend_counts_blob.launches == before + 1
    assert torch.equal(got, extend_kernel_blob(r, b, **shape))
    return got.cpu()


def _with_row_off(blob, shape, row_off):
    """The blob with its row_off [U+1] replaced."""
    C, U = shape["C"], shape["U"]
    assert len(row_off) == U + 1 and (np.diff(row_off) >= 0).all()
    blob = blob.copy()
    blob[C:C + U + 1] = row_off
    return blob


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("C", [1, 31, 32, 33, 127, 128, 129, 255, 256, 257,
                               128 * 8000 + 1])
def test_count_kernel_tile_edges(cuda, mode, C):
    """Waves that end on either side of a warp tile (32) and a block (128
    candidates); 128 * 8000 + 1 is more tiles than the grid has warps, so
    each warp walks a run of several tiles through its 2-stage ring."""
    ref32, blob, shape = _random_blob(mode, C, max(1, C // 5), 7, 3,
                                      nw=1 << 16, seed=C + 1)
    _count_against_plain(cuda, ref32, blob, shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("layout", ["row_per_candidate", "one_row"])
def test_count_kernel_row_extremes(cuda, mode, layout):
    """One candidate per row (U = C: 32 row starts in every tile, the
    device-memory search) and one row for the whole wave (U = 1)."""
    C = 5000
    U = C if layout == "row_per_candidate" else 1
    ref32, blob, shape = _random_blob(mode, C, U, 7, 2, nw=1 << 14, seed=U)
    _count_against_plain(cuda, ref32,
                         _with_row_off(blob, shape, np.arange(U + 1) * C // U),
                         shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("run", [3, 31, 32, 33, 500])
def test_count_kernel_empty_rows(cuda, mode, run):
    """row_off with runs of repeats (empty rows): a run of ``run`` at the
    start (0), inside the wave and in the padded tail (C).  Runs of 32 and
    more exceed the shared row_off slice of a tile."""
    C, W = 4000, 7
    rng = np.random.default_rng(run)
    cuts = np.sort(np.concatenate([
        np.zeros(run, int), np.full(run, 1234), np.full(run, 2049),
        rng.integers(1, C, 150), np.full(run, C)]))
    U = cuts.size + 1
    ref32, blob, shape = _random_blob(mode, C, U, W, 4, nw=1 << 14,
                                      seed=run)
    row_off = np.concatenate([[0], cuts, [C]]).astype(np.int32)
    _count_against_plain(cuda, ref32, _with_row_off(blob, shape, row_off),
                         shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("W", [1, 2, 15, 30, 64])
def test_count_kernel_window_widths(cuda, mode, W):
    """The smallest and largest shared-memory strides S = (W+1) | 1: W 1
    (S 3, 16 windows per gather instruction), W 30 (S 31), and W 64, the
    most a 10-bit read length needs (S 65, over 48 KB of shared memory)."""
    ref32, blob, shape = _random_blob(mode, 3000, 97, W, 5, nw=1 << 14,
                                      seed=W)
    _count_against_plain(cuda, ref32, blob, shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
def test_count_kernel_4094_exception_rows(cuda, mode):
    ref32, blob, shape = _random_blob(mode, 20_000, 5000, 7, 4094,
                                      nw=1 << 16, seed=4094)
    _count_against_plain(cuda, ref32, blob, shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
def test_count_kernel_plane_ends(cuda, mode):
    """Windows that reach the last words of each plane: on the forward
    plane they run into the reverse plane, on the reverse plane past the
    reference, where the gather index is clamped."""
    C, W, nw = 3000, 7, 1 << 12
    ref32, blob, shape = _random_blob(mode, C, 60, W, 3, nw=nw, seed=11)
    rng = np.random.default_rng(12)
    loc = rng.integers(16 * (nw - W - 2), 16 * nw, C).astype(np.uint32)
    plane = (np.arange(C) % 2).astype(np.uint32)
    blob[:C] = (loc | (plane << np.uint32(31))).view(np.int32)
    _count_against_plain(cuda, ref32, blob, shape)


def test_empty_wave_does_not_launch(cuda):
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    ref32 = torch.zeros(512, dtype=torch.int32, device=cuda)
    # C = 0, U = 1: row_off [0, 0], rowmeta, base [W], exc_valid [W]
    blob = torch.tensor([0, 0, 100] + [0] * 14, dtype=torch.int32,
                        device=cuda)
    before = extend_counts_blob.launches
    out = extend_counts_blob(ref32, blob, mode="oneway", W=7, nw=256, C=0,
                             U=1, E=1)
    assert out.shape == (0,) and extend_counts_blob.launches == before


def test_mixed_devices_raise(cuda):
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    ref32, blob, shape = _random_blob("oneway", 64, 4, 7, 1, nw=256, seed=2)
    with pytest.raises(ValueError, match="ref32 on"):
        extend_counts_blob(torch.from_numpy(ref32),
                           torch.from_numpy(blob).to(cuda), **shape)


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("gap,C,U,W,E", [(1, 1, 1, 4, 1),
                                         (2, 1000, 37, 7, 5),
                                         (3, 65_537, 4000, 10, 4094),
                                         (1, 200_003, 513, 7, 1),
                                         (3, 4099, 60, 30, 3)])
def test_gap_kernel_equals_plain(cuda, mode, gap, C, U, W, E):
    """Random rows (read lengths 0..16*W, so lists of every length, many
    longer than 14) and candidates over the whole reference, its first and
    last words included (the window is clamped at both ends)."""
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    ref32, blob, shape = _random_blob(mode, C, U, W, E, nw=1 << 16,
                                      seed=C + W + gap)
    shape["gap"] = gap
    r, b = torch.from_numpy(ref32).to(cuda), torch.from_numpy(blob).to(cuda)
    before = extend_gap_blob.launches
    got = extend_gap_blob(r, b, **shape)
    torch.cuda.synchronize()
    assert extend_gap_blob.launches == before + 1
    assert [t.dtype for t in got] == [torch.uint8, torch.int16, torch.int16]
    assert got[2].shape == (C, 2 * gap, 14)
    want_dev = extend_kernel_blob(r, b, **shape)
    want_cpu = extend_gap_blob(torch.from_numpy(ref32),
                               torch.from_numpy(blob), **shape)
    assert extend_gap_blob.launches == before + 1  # CPU call: no launch
    for name, g, w, c in zip(("counts", "pos0", "pos1"), got, want_dev,
                             want_cpu):
        assert torch.equal(g, w), name
        assert torch.equal(g.cpu(), c), name


def _gap_against_plain(cuda, ref32, blob, shape):
    """The gap kernel's (counts, pos0, pos1) on the card, asserted equal to
    the plain version's on the same tensors; returned on the CPU."""
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    r, b = torch.from_numpy(ref32).to(cuda), torch.from_numpy(blob).to(cuda)
    before = extend_gap_blob.launches
    got = extend_gap_blob(r, b, **shape)
    torch.cuda.synchronize()
    assert extend_gap_blob.launches == before + 1
    want = extend_kernel_blob(r, b, **shape)
    for name, g, w in zip(("counts", "pos0", "pos1"), got, want):
        assert torch.equal(g, w), name
    return [t.cpu() for t in got]


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
@pytest.mark.parametrize("C", [127, 128, 129, 257, 256 * 40 + 1])
def test_gap_kernel_block_boundaries(cuda, mode, C):
    """Waves that end on either side of a block of 128 candidates, at gap 3
    and W 30 (the largest output tiles and window): the last block copies
    only its own candidates' spans, its tail narrower than 16 bytes."""
    ref32, blob, shape = _random_blob(mode, C, max(1, C // 5), 30, 3,
                                      nw=1 << 14, seed=C)
    _gap_against_plain(cuda, ref32, blob, {**shape, "gap": 3})


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
def test_gap_kernel_every_list_full(cuda, mode):
    """Rows of 480 random bases against random reference words: every main
    and shifted alignment has at least 14 mismatches, so every list holds
    14 positions and none is padding."""
    W, C = 30, 4099
    ref32, blob, shape = _random_blob(mode, C, 41, W, 1, nw=1 << 14, seed=9,
                                      readlen=16 * W)
    _cnt, pos0, pos1 = _gap_against_plain(cuda, ref32, blob,
                                          {**shape, "gap": 3})
    assert (pos0 < 16 * W).all() and (pos1 < 16 * W).all()


@pytest.mark.parametrize("mode", ["oneway", "multiway", "nt3"])
def test_gap_kernel_every_list_padding(cuda, mode):
    """Rows of read length 0: no lane lies under the length mask, so every
    list is 14 entries of padding (the read length, 0)."""
    ref32, blob, shape = _random_blob(mode, 1000, 7, 7, 2, nw=1 << 14,
                                      seed=3, readlen=0)
    _cnt, pos0, pos1 = _gap_against_plain(cuda, ref32, blob,
                                          {**shape, "gap": 3})
    assert (pos0 == 0).all() and (pos1 == 0).all()


def test_gap_empty_wave_does_not_launch(cuda):
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    ref32 = torch.zeros(512, dtype=torch.int32, device=cuda)
    blob = torch.tensor([0, 0, 100] + [0] * 14, dtype=torch.int32,
                        device=cuda)
    before = extend_gap_blob.launches
    cnt, pos0, pos1 = extend_gap_blob(ref32, blob, mode="oneway", gap=3, W=7,
                                      nw=256, C=0, U=1, E=1)
    assert cnt.shape == (0,) and pos0.shape == (0, 14)
    assert pos1.shape == (0, 6, 14)
    assert extend_gap_blob.launches == before


def test_watchdog_raises_on_a_real_event(cuda, monkeypatch):
    """An armed context with a deadline of 0 (BASAL_TPU_WATCHDOG_MIN=0, a
    cost of 1e-12 s per candidate) is handed a gapped wave of 2^18
    candidates the moment it is launched: its 52 MB of results are still
    being copied, so the fetch raises and counts one stall.  The same
    context then fetches a wave with the watchdog off, equal to the plain
    version."""
    import types

    from basal_tpu_torch.align.pipeline import TorchDeviceContext, download
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend import extend_kernel_blob
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    C, U, W, E, nw = 1 << 18, 2048, 7, 1, 1 << 16
    ref32, blob, shape = _random_blob("oneway", C, U, W, E, nw=nw, seed=5)
    shape["gap"] = 3
    ctx = TorchDeviceContext(
        types.SimpleNamespace(ref32=ref32.view(np.uint32).reshape(2, nw)),
        AlignParams(conversion="C:T", randseed=1, gap=3), cuda)
    ctx.meas_t, ctx.meas_n, ctx._meas_skip = 1e-12, 1, 0
    b = torch.from_numpy(blob).to(cuda)

    def wave():
        out = extend_gap_blob(ctx.ref32, b, **shape)
        return download(C, U, E, out, 0.0, (b,))

    monkeypatch.delenv("BASAL_TPU_WATCHDOG", raising=False)
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "0")
    assert ctx.watchdog_timeout(C) == pytest.approx(8e-12 * C)
    with pytest.raises(RuntimeError, match=f"C={C} U={U} E={E} gap=3"):
        ctx.fetch([wave()])
    assert ctx.stalls == 1
    torch.cuda.synchronize()
    monkeypatch.setenv("BASAL_TPU_WATCHDOG", "0")
    got = ctx.fetch([wave()])
    want = extend_kernel_blob(ctx.ref32, b, **shape)
    for name, g, w in zip(("counts", "pos0", "pos1"), got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy().astype(np.int32),
                                      err_msg=name)
    assert ctx.stalls == 1


def _tiny_data(tmp_path, rule, seed=7, n_reads=300):
    """A 9 kbp genome and mixed-length converted reads, some with Ns, every
    fourth read with a deletion of 1-3 bases."""
    rng = np.random.default_rng(seed)
    nt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(nt, size=9000)
    (tmp_path / "ref.fa").write_bytes(b">c1\n" + g.tobytes() + b"\n")
    frm, tos = rule.split(":")
    with open(tmp_path / "reads.fq", "wb") as f:
        for i in range(n_reads):
            ln = int(rng.integers(64, 121))
            pos = int(rng.integers(0, len(g) - ln))
            s = g[pos:pos + ln].copy()
            conv = (s == ord(frm)) & (rng.random(ln) < 0.5)
            s[conv] = ord(tos[0])
            if i % 5 == 0:
                s[int(rng.integers(0, ln))] = ord("N")
            if i % 4 == 0:
                j = int(rng.integers(15, ln - 15))
                s = np.delete(s, np.arange(j, j + int(rng.integers(1, 4))))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(),
                                                b"I" * len(s)))


@pytest.mark.parametrize("rule,nt3,n_mis", [("C:T", False, False),
                                            ("A:CGT", False, False),
                                            ("C:T", True, False),
                                            ("A:G", False, True)])
def test_pipeline_cuda_equals_cpu(cuda, tmp_path, monkeypatch, rule, nt3,
                                  n_mis):
    """run_single_end, device forced: the same SAM on the card as with the
    plain version on the CPU, every wave through the kernel."""
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.ops.extend_cuda import extend_counts_blob
    _tiny_data(tmp_path, rule)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = AlignParams(conversion=rule, randseed=11, nt3=nt3, n_mis=n_mis,
                        out_unmap=True, batch_reads=100)
        buf = io.BytesIO()
        before = extend_counts_blob.launches
        al = run_single_end(p, str(tmp_path / "ref.fa"),
                            str(tmp_path / "reads.fq"), out_fh=buf,
                            device=dev)
        launches = extend_counts_blob.launches - before
        assert al.stage["cand_device"] > 0 and al.stage["cand_host"] == 0
        assert launches == (al._dev.up_waves if dev == "cuda" else 0)
        outs[dev] = buf.getvalue()
    assert outs["cpu"].count(b"\n") > 300
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("rule,gap", [("T:-", 3), ("C:T", 1), ("A:CGT", 2)])
def test_gapped_pipeline_cuda_equals_cpu(cuda, tmp_path, monkeypatch, rule,
                                         gap):
    """Gapped run_single_end, device forced: every wave through the gap
    kernel, the same SAM as the plain gap core on the CPU."""
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    _tiny_data(tmp_path, "T:T" if rule == "T:-" else rule)  # no-op conversion
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = AlignParams(conversion=rule, randseed=11, gap=gap, out_unmap=True,
                        batch_reads=100)
        buf = io.BytesIO()
        before = extend_gap_blob.launches
        al = run_single_end(p, str(tmp_path / "ref.fa"),
                            str(tmp_path / "reads.fq"), out_fh=buf,
                            device=dev)
        launches = extend_gap_blob.launches - before
        assert al.stage["cand_device"] > 0 and al.stage["cand_host"] == 0
        assert al.stage["cand_visit"] == 0
        assert launches == (al._dev.up_waves if dev == "cuda" else 0)
        outs[dev] = buf.getvalue()
    assert outs["cpu"].count(b"\n") > 300
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("gap", [0, 2])
def test_pair_end_cuda_equals_cpu(cuda, tmp_path, monkeypatch, gap):
    """run_pair_end, device forced: both mates' waves through the count
    (gap 0) or gap kernel, the same SAM as on the CPU."""
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    from basal_tpu_torch.pairs.pipeline import run_pair_end
    rng = np.random.default_rng(3)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=9000)
    (tmp_path / "ref.fa").write_bytes(b">c1\n" + g.tobytes() + b"\n")
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    with open(tmp_path / "r1.fq", "wb") as f1, \
            open(tmp_path / "r2.fq", "wb") as f2:
        for i in range(200):
            ins = int(rng.integers(150, 400))
            pos = int(rng.integers(0, len(g) - ins))
            frag = g[pos:pos + ins].copy()
            frag[(frag == ord("C")) & (rng.random(ins) < 0.5)] = ord("T")
            r1, r2 = frag[:90], comp[frag[-90:]][::-1]
            if gap and i % 3 == 0:
                r1 = np.delete(r1, np.arange(40, 40 + int(rng.integers(1, 3))))
            f1.write(b"@p%d/1\n%s\n+\n%s\n" % (i, r1.tobytes(),
                                                 b"I" * len(r1)))
            f2.write(b"@p%d/2\n%s\n+\n%s\n" % (i, r2.tobytes(),
                                                 b"I" * len(r2)))
    counter = extend_gap_blob if gap else extend_counts_blob
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = AlignParams(conversion="C:T", randseed=5, gap=gap, pairend=True,
                        out_unmap=True, batch_reads=60)
        buf = io.BytesIO()
        before = counter.launches
        al = run_pair_end(p, str(tmp_path / "ref.fa"),
                          str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
                          out_fh=buf, device=dev)
        assert al.stage["cand_device"] > 0 and al.stage["cand_host"] == 0
        assert counter.launches - before == (al._dev.up_waves
                                             if dev == "cuda" else 0)
        outs[dev] = buf.getvalue()
    assert outs["cpu"].count(b"\n") > 400
    assert outs["cuda"] == outs["cpu"]


def _candidates(tmp_path, rule, gap):
    """(params, reference, encoded batch, candidate table) of _tiny_data's
    reads: every candidate of every stratum."""
    from basal_tpu_torch.align.candidates import (SeedScheduler,
                                                  build_candidates)
    from basal_tpu_torch.align.rng import MyRand
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.index.seedindex import build_index
    from basal_tpu_torch.reads.encode import encode_batch
    from basal_tpu_torch.reads.io import open_reads
    _tiny_data(tmp_path, "T:T" if rule == "T:-" else rule)
    p = AlignParams(conversion=rule, randseed=11, gap=gap)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    index = build_index(ref, p)
    rd = open_reads(str(tmp_path / "reads.fq"), p)
    enc = encode_batch(p, rd.next_batch())
    rd.close()
    sched = SeedScheduler(p, index, MyRand(11))
    table = build_candidates(p, index, enc, sched)
    return p, ref, enc, table


@pytest.mark.parametrize("rule,gap", [("C:T", 0), ("T:-", 3)])
@pytest.mark.parametrize("n_dp,n_rs", [(1, 4), (2, 2), (4, 1)])
def test_sharded_context_on_one_card_equals_single(cuda, tmp_path, rule, gap,
                                                   n_dp, n_rs):
    """The dp x rs mesh over a repeated cuda:0: counts (and gapped pos0 /
    pos1) equal the single context's and the CPU mesh's; the kernel
    launches once per wave of a dp slice and rs shard."""
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.ops.extend_cuda import (extend_counts_blob,
                                                 extend_gap_blob)
    from basal_tpu_torch.parallel.mesh import (ShardedTorchDeviceContext,
                                               make_mesh)
    p, ref, enc, table = _candidates(tmp_path, rule, gap)
    args = (enc, table.loc, table.plane.astype(np.int32), table.row)
    assert table.loc.size > 1000
    want = TorchDeviceContext(ref, p, cuda).extend(*args)
    counter = extend_gap_blob if gap else extend_counts_blob
    card = torch.device("cuda", 0)
    mesh = make_mesh(n_dp, n_rs, [card] * (n_dp * n_rs))
    ctx = ShardedTorchDeviceContext(ref, p, mesh)
    before = counter.launches
    got = ctx.extend(*args)
    assert counter.launches - before == ctx.up_waves * n_rs
    assert ctx.up_waves >= n_dp
    on_cpu = ShardedTorchDeviceContext(
        ref, p, make_mesh(n_dp, n_rs, [torch.device("cpu")] * n_dp * n_rs)
    ).extend(*args)
    for part in range(3 if gap else 1):
        np.testing.assert_array_equal(got[part], want[part])
        np.testing.assert_array_equal(got[part], on_cpu[part])
