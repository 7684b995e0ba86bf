"""The port's device choice never falls back on its own.

On a host without a CUDA card: ``BASAL_TPU_TORCH_DEVICE=cuda`` (the
default) raises, the CLI exits non-zero with that error (single-end and
paired-end), and ``chip_smoke.py`` fails without printing a result, both
from the checkout and from a directory that holds nothing else of the
repo.  The kernel wrappers take their plain versions only for CPU tensors
and reject shapes their kernels do not take.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("these checks need a host without a CUDA card")


def _env(**kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT), **kw}
    env.pop("BASAL_TPU_TORCH_DEVICE", None)
    env.update(kw)
    return env


def test_resolve_device_cuda_without_card_raises(no_card, monkeypatch):
    from basal_tpu_torch.align.pipeline import resolve_device
    monkeypatch.delenv("BASAL_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    monkeypatch.setenv("BASAL_TPU_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    monkeypatch.setenv("BASAL_TPU_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.setenv("BASAL_TPU_TORCH_DEVICE", "mps")
    with pytest.raises(ValueError, match="want cpu or cuda"):
        resolve_device()


def test_aligner_cuda_without_card_raises(no_card, tmp_path, rng):
    from basal_tpu_torch.align.pipeline import TorchSingleEndAligner
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.index.seedindex import build_index
    from conftest import make_ref, random_genome
    make_ref(tmp_path / "ref.fa", [("c1", random_genome(rng, 6000))])
    p = AlignParams(conversion="C:T", randseed=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSingleEndAligner(p, ref, build_index(ref, p), device="cuda")


def test_cli_cuda_without_card_fails(no_card, tmp_path, rng):
    from conftest import convert_reads, make_fastq, make_ref, random_genome
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    make_fastq(tmp_path / "reads.fq", convert_reads(rng, g, 10, 80, "C:T"))
    r = subprocess.run(
        [sys.executable, "-m", "basal_tpu_torch.cli", "-a", "reads.fq",
         "-d", "ref.fa", "-M", "C:T", "-S", "1", "-o", "out.sam"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_cli_paired_end_cuda_without_card_fails(no_card, tmp_path, rng):
    from conftest import make_fastq, make_ref, random_genome
    from test_differential_pe import pe_reads
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    r1, r2 = pe_reads(rng, g, 10, 80)
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    r = subprocess.run(
        [sys.executable, "-m", "basal_tpu_torch.cli", "-a", "r1.fq", "-b",
         "r2.fq", "-d", "ref.fa", "-M", "C:T", "-S", "1", "-o", "out.sam"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _gap_shape(**kw):
    from basal_tpu_torch.ops.extend_cuda import blob_words
    shape = dict(mode="oneway", gap=2, W=7, nw=64, C=4, U=2, E=1)
    shape.update(kw)
    blob = torch.zeros(blob_words(shape["mode"], shape["W"], shape["C"],
                                  shape["U"], shape["E"]), dtype=torch.int32)
    return torch.zeros(2 * shape["nw"], dtype=torch.int32), blob, shape


def test_gap_wrapper_rejects_bad_shapes():
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    ref32, blob, shape = _gap_shape()
    cnt, pos0, pos1 = extend_gap_blob(ref32, blob, **shape)
    assert cnt.shape == (4,) and pos0.shape == (4, 14)
    assert pos1.shape == (4, 4, 14)
    for bad in ({"gap": 0}, {"gap": 4}):
        with pytest.raises(ValueError, match="gap"):
            extend_gap_blob(ref32, blob, **{**shape, **bad})
    ref32, blob, shape = _gap_shape(W=31)
    with pytest.raises(ValueError, match="W <= 30"):
        extend_gap_blob(ref32, blob, **shape)
    ref32, blob, shape = _gap_shape()
    with pytest.raises(ValueError, match="holds"):
        extend_gap_blob(ref32, blob[:-1].contiguous(), **shape)
    with pytest.raises(ValueError, match="int32"):
        extend_gap_blob(ref32, blob.to(torch.int64), **shape)
    with pytest.raises(ValueError, match="mode"):
        extend_gap_blob(ref32, blob, **{**shape, "mode": "twoway"})


def test_gap_wrapper_never_takes_plain_version_off_cpu():
    """A tensor that is not on the CPU never reaches the plain gap core: on
    a device without a gap kernel the wrapper raises."""
    from basal_tpu_torch.ops.extend_cuda import extend_gap_blob
    ref32, blob, shape = _gap_shape()
    with pytest.raises(ValueError, match="no gap kernel"):
        extend_gap_blob(ref32.to("meta"), blob.to("meta"), **shape)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card(no_card, tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    else:
        env = _env()
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no CUDA device" in r.stderr
