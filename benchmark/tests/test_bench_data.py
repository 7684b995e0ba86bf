"""The input generators: deterministic per seed, the mrna mix inside the
unique segments, each read's origin, the FASTQ the reader takes."""

import gzip

import numpy as np
import pytest

from benchkit import data

GENOME = dict(name="chr1", length=300_000, seed=5, unique_min=300,
              unique_max=1200, element_len=300, copies_min=1, copies_max=3,
              divergence=0.05)
MRNA = dict(source="transcripts", seed=9, transcripts=50, len_min=1000,
            len_max=4000, zipf=1.0)
AG = dict(read_len=100, rule="A:G", rate=0.98, subst=0.005, n_frac=0.02)


@pytest.fixture(scope="module")
def genome():
    return data.repeat_genome(GENOME)


@pytest.fixture(scope="module")
def ref(genome):
    seq, seg = genome
    return data.Ref(seq, np.array([[0, seq.size]]), ["chr1"], seg)


def test_genome_deterministic_with_repeats(genome):
    seq, seg = genome
    again, seg2 = data.repeat_genome(GENOME)
    assert seq.size == GENOME["length"]
    assert np.array_equal(seq, again) and np.array_equal(seg, seg2)
    assert set(np.unique(seq).tolist()) <= set(b"ACGT")
    unique = (seg[:, 1] - seg[:, 0]).sum() / seq.size
    assert 0.45 < unique < 0.65          # about 45% of the genome repeats
    other, _ = data.repeat_genome(dict(GENOME, seed=6))
    assert not np.array_equal(seq, other)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 7])
def test_reads_deterministic_per_seed(ref, seed):
    a = data.make_reads(ref, MRNA, AG, 3000, seed)
    b = data.make_reads(ref, MRNA, AG, 3000, seed)
    c = data.make_reads(ref, MRNA, AG, 3000, seed + 1)
    assert np.array_equal(a.chars, b.chars)
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.minus, b.minus)
    assert not np.array_equal(a.chars, c.chars)
    assert a.chars.shape == (3000, 100) and (a.lens == 100).all()


def test_mrna_reads_only_from_unique_segments(ref):
    seg = ref.unique
    rng = np.random.default_rng(3)
    starts = data.source("transcripts")(rng, ref, MRNA, 20000, 108)
    k = np.searchsorted(seg[:, 0], starts, side="right") - 1
    assert (k >= 0).all()
    assert (starts >= seg[k, 0]).all() and (starts + 108 <= seg[k, 1]).all()
    # Zipf(1) expression: loci repeat far more than uniform draws would
    assert np.unique(starts).size < 0.9 * starts.size


def test_unknown_source_is_refused(ref):
    with pytest.raises(ValueError, match="unknown traffic source"):
        data.make_reads(ref, dict(MRNA, source="nowhere"), AG, 10, 1)


def test_reads_are_their_origin_converted(ref):
    chem = dict(AG, subst=0.0, n_frac=0.0)
    rd = data.make_reads(ref, MRNA, chem, 4000, 11)
    win = ref.chars[rd.start[:, None] + np.arange(100)]
    win[rd.minus] = data.revcomp(win[rd.minus])
    assert 0.3 < rd.minus.mean() < 0.7
    a = win == ord("A")
    assert (rd.chars[~a] == win[~a]).all()
    assert 0.97 < (rd.chars[a] == ord("G")).mean() < 0.99


def test_fastq_gz_names(tmp_path, ref):
    reads = data.make_reads(ref, MRNA, AG, 2500, 1).chars
    path = tmp_path / "r.fq.gz"
    data.write_fastq_gz(path, reads, block=1000, threads=2)
    lines = gzip.open(path).read().split(b"\n")
    assert len(lines) == 4 * 2500 + 1
    assert int(lines[4 * 5][2:]) == 5 and len(lines[4 * 5 + 1]) == 100
    assert lines[4 * 2499][:2] == b"@r" and int(lines[4 * 2499][2:]) == 2499
    assert lines[4 * 7 + 1] == reads[7].tobytes()
    assert lines[4 * 7 + 3] == b"I" * 100
