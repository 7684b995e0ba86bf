"""The CUDA count kernel on the card == its plain PyTorch version.

Marked ``cuda``: each test skips where torch finds no card.  This file
imports neither jax nor conftest, so that it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers: equality is exact.
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


def _random_blob(mode, C, U, W, E, nw, seed):
    """A wave blob with random rows: read lengths 0..16*W, N-counts, E
    exception rows, candidates spread over both planes and the whole
    reference (margins included)."""
    from basal_tpu_torch.ops.extend_cuda import blob_words
    rng = np.random.default_rng(seed)
    loc = rng.integers(0, 16 * (nw - W - 1), C).astype(np.uint32)
    plane = rng.integers(0, 2, C).astype(np.uint32)
    cuts = np.sort(rng.integers(1, C, U - 1)) if U > 1 else np.zeros(0, int)
    row_off = np.concatenate([[0], cuts, [C]]).astype(np.int32)
    readlen = rng.integers(0, 16 * W + 1, U).astype(np.uint32)
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


def _tiny_data(tmp_path, rule, seed=7, n_reads=300):
    """A 9 kbp genome and mixed-length converted reads, some with Ns."""
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
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * ln))


@pytest.mark.parametrize("rule,nt3,n_mis", [("C:T", False, False),
                                            ("A:CGT", False, False),
                                            ("C:T", True, False),
                                            ("A:G", False, True)])
def test_pipeline_cuda_equals_cpu(cuda, tmp_path, monkeypatch, rule, nt3,
                                  n_mis):
    """run_single_end, device forced: the same SAM on the card as with the
    plain version on the CPU, every wave through the kernel."""
    from basal_tpu.config import AlignParams
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
