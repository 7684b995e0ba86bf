"""The port's seed index built with torch (``index/device_build.py``)
against the host build (``index/seedindex.py:build_index``), table for
table; where ``build_index_on`` builds; and the SE and PE pipelines with
the torch build in place, against basal_tpu's SAM.

The torch build runs here on CPU tensors (``device_build(..., "cpu")``);
on the card ``tests/test_torch_cuda.py`` holds it against the host build.
"""

import io
import random

import numpy as np
import pytest
import torch

from conftest import make_ref, norm_sam, random_genome
from test_differential_se import run_ours
from test_torch_pairs import PE_ARGS, _pe_data
from test_torch_pipeline import _data

from basal_tpu_torch import trace
from basal_tpu_torch.config import AlignParams
from basal_tpu_torch.index import device_build as db
from basal_tpu_torch.index.reference import Block, load_reference
from basal_tpu_torch.index.seedindex import build_index


def _genome(tmp_path, seed=7):
    """Three chromosomes with N runs (several blocks each, one of them
    shorter than a seed), lower case, and copies of one element, so that
    many k-mers occur on both planes and several times."""
    rng = random.Random(seed)
    elem = random_genome(rng, 200)
    seqs = []
    for c, n in enumerate((9000, 5200, 3100)):
        parts = []
        while sum(map(len, parts)) < n:
            parts.append(random_genome(rng, rng.randrange(150, 700)))
            parts.append(elem if rng.random() < 0.5 else elem.lower())
            if rng.random() < 0.3:
                parts.append("N" * rng.randrange(1, 40))
                parts.append(random_genome(rng, rng.randrange(3, 15)))
                parts.append("N" * rng.randrange(1, 9))
        seqs.append((f"chr{c}", "".join(parts)[:n]))
    make_ref(tmp_path / "ref.fa", seqs)
    return str(tmp_path / "ref.fa")


def _equal(got, want):
    for f in ("starts", "counts", "n1", "locs"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.max_kmer_num == want.max_kmer_num


CASES = [("C:T", 12, 1), ("C:T", 16, 4), ("A:G", 12, 4), ("A:G", 16, 1),
         ("A:CGT", 12, 4), ("A:CGT", 12, 1)]


@pytest.mark.parametrize("rule,seed,interval", CASES)
def test_device_build_equals_host(tmp_path, rule, seed, interval):
    p = AlignParams(conversion=rule, seed_size=seed, index_interval=interval)
    ref = load_reference(_genome(tmp_path), p)
    assert len({b.id for b in ref.blocks}) == 6 and len(ref.blocks) > 12
    want = build_index(ref, p)
    assert want.locs.size == db.n_positions(ref, p)
    _equal(db.device_build(ref, p, "cpu"), want)


@pytest.mark.parametrize("interval", [1, 16])
def test_repeated_positions_stay(tmp_path, interval):
    """Seed 10 at interval 16: a block's first position lies before its
    begin and can repeat the last of the block before (64 here); both
    entries stay, as in the host build."""
    p = AlignParams(conversion="C:T", seed_size=10, index_interval=interval)
    ref = load_reference(_genome(tmp_path, seed=3), p)
    ref.blocks = sorted([Block(0, 40, 75), Block(0, 76, 120),
                         Block(0, 33, 39), Block(1, 5, 900)],
                        key=lambda b: (b.id, b.begin))
    want = build_index(ref, p)
    _equal(db.device_build(ref, p, "cpu"), want)
    assert want.counts.max() > 1


@pytest.mark.parametrize("interval", [1, 4])
def test_block_edges(tmp_path, interval):
    """Blocks shorter than the seed, exactly one seed long, starting off the
    interval's grid, ending where the last window fits; a plane with none
    on one chromosome."""
    p = AlignParams(conversion="A:G", seed_size=12, index_interval=interval)
    ref = load_reference(_genome(tmp_path, seed=11), p)
    blocks = [Block(0, 0, 5), Block(0, 7, 19), Block(0, 30, 42),
              Block(0, 43, 56), Block(0, 61, 300), Block(1, 2, 13),
              Block(1, 15, 4000), Block(2, 100, 111), Block(2, 113, 2000),
              Block(4, 5, 17), Block(5, 1, 3000)]
    ref.blocks = sorted(blocks, key=lambda b: (b.id, b.begin))
    want = build_index(ref, p)
    _equal(db.device_build(ref, p, "cpu"), want)


def test_empty_reference_tables(tmp_path):
    """No block long enough for a seed: empty locs, zero tables."""
    p = AlignParams(conversion="C:T", seed_size=12, index_interval=4)
    ref = load_reference(_genome(tmp_path), p)
    ref.blocks = [Block(0, 0, 8), Block(1, 5, 14)]
    got = db.device_build(ref, p, "cpu")
    _equal(got, build_index(ref, p))
    assert got.locs.size == 0 and not got.counts.any()


def test_host_builds_on_cpu(tmp_path):
    p = AlignParams(conversion="C:T", seed_size=12)
    ref = load_reference(_genome(tmp_path), p)
    assert db.build_place(ref, p, "cpu") is None
    trace.enable()
    try:
        index, place = db.build_index_on(ref, p, torch.device("cpu"))
        names = {s.name for s in trace.snapshot()}
    finally:
        trace.disable()
    assert place == "host"
    assert not any(n.startswith("index.device_build") for n in names)
    _equal(index, build_index(ref, p))


def test_card_memory_decides(tmp_path, monkeypatch):
    """The card path only where its footprint and the margin fit in the
    free memory ``mem_get_info`` reports; else the host builds."""
    p = AlignParams(conversion="C:T", seed_size=12)
    ref = load_reference(_genome(tmp_path), p)
    need = db.card_bytes(ref, p) + db.MARGIN
    free = {"b": need - 1}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free["b"], 80 << 30))
    card = torch.device("cuda")
    assert db.build_place(ref, p, card) is None
    index, place = db.build_index_on(ref, p, card)
    assert place == "host"
    _equal(index, build_index(ref, p))
    free["b"] = need
    assert db.build_place(ref, p, card) == card


def test_card_bytes_counts_each_part(tmp_path):
    p = AlignParams(conversion="C:T", seed_size=12, index_interval=4)
    ref = load_reference(_genome(tmp_path), p)
    n = db.n_positions(ref, p)
    assert db.card_bytes(ref, p) == (ref.ref32.nbytes + 16 * n
                                     + 16 * 3 ** 12)


def test_host_builds_past_one_sort(tmp_path, monkeypatch):
    """More positions than one sort takes: the host builds, whatever the
    card's free memory."""
    p = AlignParams(conversion="C:T", seed_size=12)
    ref = load_reference(_genome(tmp_path), p)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 << 30, 80 << 30))
    card = torch.device("cuda")
    assert db.build_place(ref, p, card) == card
    monkeypatch.setattr(db, "MAX_POSITIONS", db.n_positions(ref, p) - 1)
    assert db.build_place(ref, p, card) is None


def test_build_spans(tmp_path):
    p = AlignParams(conversion="C:T", seed_size=12)
    ref = load_reference(_genome(tmp_path), p)
    trace.enable()
    try:
        db.device_build(ref, p, "cpu")
        spans = {s.name: s for s in trace.snapshot()}
    finally:
        trace.disable()
    top = spans["index.device_build"]
    for name in ("seeds", "sort", "copy"):
        assert spans[f"index.device_build.{name}"].parent == top.id


def _params(argv):
    from basal_tpu_torch import cli
    return cli.params_from_args(argv, *cli.parse_args(argv))


@pytest.fixture
def torch_build_on_cpu(monkeypatch):
    """The pipelines build their index with the plain torch build on the CPU,
    and count its builds."""
    builds = []
    real = db.device_build

    def build(ref, params, device):
        builds.append(str(device))
        return real(ref, params, device)

    monkeypatch.setattr(db, "build_place",
                        lambda ref, params, device: torch.device("cpu"))
    monkeypatch.setattr(db, "device_build", build)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    return builds


def test_single_end_sam_with_torch_index(tmp_path, rng, monkeypatch,
                                         torch_build_on_cpu):
    from basal_tpu_torch.align.pipeline import run_single_end
    _data(tmp_path, rng, "A:G")
    argv = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G", "-S", "17",
            "-u", "-V", "0"]
    p = _params(argv)
    buf = io.BytesIO()
    logs = []
    run_single_end(p, str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq"),
                   out_fh=buf, device="cpu", command_line=" ".join(argv),
                   log=lambda *a: logs.append(a[0]))
    assert torch_build_on_cpu == ["cpu"]
    assert any(m.startswith("create seed table on cpu.") for m in logs)
    got = norm_sam(buf.getvalue().decode("latin1"))
    want = norm_sam(run_ours(argv, tmp_path))
    assert len(got) > 100
    assert got == want


def test_pair_end_sam_with_torch_index(tmp_path, rng, monkeypatch,
                                       torch_build_on_cpu):
    from basal_tpu_torch.pairs.pipeline import run_pair_end
    _pe_data(tmp_path, rng, "C:T")
    argv = PE_ARGS + ["-M", "C:T", "-S", "1", "-u"]
    p = _params(argv)
    buf = io.BytesIO()
    run_pair_end(p, str(tmp_path / "ref.fa"), str(tmp_path / "r1.fq"),
                 str(tmp_path / "r2.fq"), out_fh=buf, device="cpu",
                 command_line=" ".join(argv))
    assert torch_build_on_cpu == ["cpu"]
    got = norm_sam(buf.getvalue().decode("latin1"))
    want = norm_sam(run_ours(argv, tmp_path))
    assert sum(not ln.startswith("@") for ln in got) >= 80
    assert got == want
