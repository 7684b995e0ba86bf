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


def _digest(rd) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in (rd.chars, rd.start, rd.minus):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


#: make_reads of the A:G chemistry before the deletion chemistry came:
#: 3,000 reads (one block) and 300,000 (two blocks), seed 2**31 + 7
FROZEN = {3000: "eb30871e77da7c0994dc0098f81fce367cbd52d41b2adf8ececdbb"
                "73b72fbe83",
          300000: "3728949357fc93fa0334cca846995c7280821735f0522410e56477"
                  "a18b52ea80"}


@pytest.mark.parametrize("n", sorted(FROZEN))
def test_conversion_reads_unchanged(ref, n):
    assert _digest(data.make_reads(ref, MRNA, AG, n, 2 ** 31 + 7)) == \
        FROZEN[n]
    # the read set's cache key
    assert data.key([MRNA, AG, 3000, 7, "genome-x"]) == "727472cc7889a062"


def test_chunks_make_only_their_blocks(ref):
    n = data.CHUNK + 5000
    full = data.make_reads(ref, MRNA, AG, n, 4)
    part = data.make_reads(ref, MRNA, AG, n, 4, chunks={1})
    assert np.array_equal(part.chars[data.CHUNK:], full.chars[data.CHUNK:])
    assert np.array_equal(part.minus[data.CHUNK:], full.minus[data.CHUNK:])
    assert not part.chars[:data.CHUNK].any()


BID = dict(read_len=100, rule="T:-", site_share=0.05, rate=0.6, subst=0.0,
           n_frac=0.0, minus_share=0.5)


def _with_deletions_put_back(ref, rd, i):
    """The read rebuilt from its genome span and its recorded deletions
    (each deleted base a T on the read's strand), and whether the span is
    used up exactly."""
    span = int(rd.span[i])
    w = ref.chars[rd.start[i]:rd.start[i] + span]
    if rd.minus[i]:
        w = data.revcomp(w[None])[0]
    dels = [(int(d), int(k)) for d, k in rd.dels[i] if d >= 0]
    # walk the span: keep a base unless a deletion starts at this offset
    out, j, di = [], 0, 0
    while len(out) < rd.chars.shape[1]:
        if di < len(dels) and len(out) == dels[di][0]:
            assert (w[j:j + dels[di][1]] == ord("T")).all()
            j += dels[di][1]
            di += 1
            continue
        out.append(w[j])
        j += 1
    return np.array(out, np.uint8), j == span and di == len(dels)


def test_deletion_reads_match_their_deletions():
    seq, seg = data.repeat_genome(GENOME)
    ref = data.Ref(seq, np.array([[0, seq.size]]), ["chr1"], seg, seed=5)
    rd = data.make_reads(ref, MRNA, BID, 4000, 3)
    has = rd.dels[:, 0, 0] >= 0
    assert 0.3 < has.mean() < 0.8          # 25 T per read, 5% sites, 60%
    assert (rd.dels[:, :, 0] != 0).all()   # a read begins at a base it holds
    for i in range(len(rd.chars)):
        got, whole = _with_deletions_put_back(ref, rd, i)
        assert whole and np.array_equal(got, rd.chars[i]), i
    # the same sites in another read set: a base deleted in one is a site
    other = data.make_reads(ref, MRNA, BID, 4000, 4)
    assert (other.dels[:, 0, 0] >= 0).mean() > 0.3
    # no deletion without sites; the seed is needed
    none = data.make_reads(ref, MRNA, dict(BID, site_share=0.0), 500, 3)
    assert (none.dels[:, :, 0] == -1).all() and (none.span == 100).all()
    with pytest.raises(ValueError, match="seed"):
        data.make_reads(data.Ref(seq, ref.seqs, ["chr1"], seg), MRNA, BID,
                        10, 3)
