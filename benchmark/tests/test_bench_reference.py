"""The plain reference on hand-made cases: the rules, the strand planes,
and the SAM record check against the record itself and the read's
origin."""

import numpy as np
import pytest
import torch

from benchkit import data
from benchkit import reference as ref

rng = np.random.default_rng(4)
G = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2000)]
COMP = {ord(a): ord(b) for a, b in zip("ACGTN", "TGCAN")}


def rc(s: bytes) -> bytes:
    return bytes(COMP[c] for c in reversed(s))


ONE = np.array([[0, G.size]])


def run(rule, loc, plane, read: bytes):
    g = ref.Genome(G, ONE, "cpu")
    r = np.frombuffer(read, np.uint8)[None, :].copy()
    return ref.extend(ref.Rule(rule), g, torch.tensor([loc]),
                      torch.tensor([plane]), torch.from_numpy(r),
                      torch.tensor([len(read)]))


def test_rule_codes():
    ag = ref.Rule("A:G")
    assert ag.mode == "oneway"
    assert [ag.code[c] for c in b"ACGT"] == [1, 0, 3, 2]
    assert ref.Rule("T:-").mode == "multiway"
    assert ref.Rule("A:CGT").mode == "multiway"
    assert ref.Rule("C:T", nt3=True).mode == "nt3"


def test_ag_rule_forgives_read_g_on_reference_a():
    seg = G[100:150].tobytes()
    conv = seg.replace(b"A", b"G")
    assert run("A:G", ref.MARGIN + 100, 0, conv).item() == 0
    back = bytearray(seg)
    i = seg.index(b"G")
    back[i] = ord("A")                     # read A on reference G
    assert run("A:G", ref.MARGIN + 100, 0, bytes(back)).item() == 1
    assert run("T:-", ref.MARGIN + 100, 0, conv).item() == \
        seg.count(b"A")


def test_reverse_plane_coordinates():
    P = 32 * (-(-G.size // 32) + 2)
    read = rc(G[100:150].tobytes())
    assert run("T:-", ref.MARGIN + P - 150, 1, read).item() == 0
    assert run("T:-", ref.MARGIN + P - 151, 1, read).item() > 10


def test_n_is_no_mismatch_in_the_count():
    seg = bytearray(G[300:360].tobytes())
    seg[7] = ord("N")
    assert run("T:-", ref.MARGIN + 300, 0, bytes(seg)).item() == 0


def test_mismatch_limit():
    assert ref.mismatch_limit(110, 100) == 10      # -v 0.1 (the default)
    assert ref.mismatch_limit(108, 100) == 8
    assert ref.mismatch_limit(4, 100) == 4
    assert ref.mismatch_limit(150, 100) == 15      # MAXSNPS


def record(pos, seq, nm, flag=0, zs="++", name="r0"):
    return (f"{name}\t{flag}\tchr1\t{pos}\t255\t{len(seq)}M\t*\t0\t0\t"
            f"{seq}\t{'I' * len(seq)}\tNM:i:{nm}\tZS:Z:{zs}\n").encode()


REF = data.Ref(G, ONE, ["chr1"])
AG = ref.Rule("A:G")


def check(line, r, start=500, minus=False, unique=True, limit=10):
    return ref.check_record(line, AG, REF, r,
                            lambda i: ref.Origin(start, minus, unique),
                            limit, False)


@pytest.fixture
def reads():
    seg = G[500:600].tobytes()
    return np.frombuffer(seg.replace(b"A", b"G"), np.uint8)[None, :].copy()


def test_record_check_against_itself(reads):
    seq = reads[0].tobytes().decode()
    assert check(record(501, seq, 0), reads) is None
    assert check(record(501, seq, 1), reads).startswith("NM")
    bad = "T" + seq[1:] if seq[0] != "T" else "C" + seq[1:]
    assert check(record(501, bad, 0), reads) == "SEQ/QUAL"
    assert check(record(501, seq, 0, zs="+-"), reads) == "ZS/flag"
    assert check(record(501, seq, 0).replace(b"100M", b"99M1I"),
                 reads) == "CIGAR/POS"


def test_record_check_against_the_origin(reads):
    seq = reads[0].tobytes().decode()
    unmapped = f"r0\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{'I' * 100}\n"
    assert check(unmapped.encode(), reads) == "unmapped within the limit"
    # an origin over the limit may go unmapped
    far = G[900:1000].tobytes().replace(b"A", b"G")
    over = np.frombuffer(far, np.uint8)[None, :].copy()
    line = f"r0\t4\t*\t0\t0\t*\t*\t0\t0\t{far.decode()}\t{'I' * 100}\n"
    assert check(line.encode(), over) is None
    # a hit with a consistent NM elsewhere than a unique origin
    other = G[1200:1300].tobytes()
    nm = ref.mismatches(AG, reads[0], np.frombuffer(other, np.uint8), False)
    assert nm > 10
    assert check(record(1201, seq, nm), reads).startswith(
        "worse than its origin")
    # equal NM at another place: not at a unique origin, right otherwise
    twin = G.copy()
    twin[1200:1300] = G[500:600]
    r2 = data.Ref(twin, ONE, ["chr1"])
    o = lambda i, u: ref.Origin(500, False, u)    # noqa: E731
    line = record(1201, seq, 0)
    assert ref.check_record(line, AG, r2, reads, lambda i: o(i, True), 10,
                            False) == "not at its origin"
    assert ref.check_record(line, AG, r2, reads, lambda i: o(i, False), 10,
                            False) is None


def test_record_check_minus_strand():
    read = rc(G[700:800].tobytes()).replace(b"A", b"G")
    r = np.frombuffer(read, np.uint8)[None, :].copy()
    line = record(701, rc(read).decode(), 0, flag=16, zs="-+")
    assert check(line, r, start=700, minus=True) is None
    assert check(line, r, start=700, minus=False) == "not at its origin"
    assert check(record(701, rc(read).decode(), 0, flag=16, zs="-+")
                 .replace(b"\t701\t", b"\t702\t"), r, start=700,
                 minus=True).startswith("NM")


def test_several_sequences_on_both_planes():
    lens = np.array([700, 1000, 300])
    seqs = np.stack([np.concatenate([[0], np.cumsum(lens)[:-1]]), lens], 1)
    g = ref.Genome(G, seqs, "cpu")
    P = 32 * (-(-lens // 32) + 2)
    anchor = ref.MARGIN + np.concatenate([[0], np.cumsum(P)[:-1]])
    pos = torch.tensor([[anchor[1] + 5, anchor[1] + 999, anchor[1] + 1000,
                         anchor[2] - 1]])
    got = g.plane_chars(pos, torch.tensor([0]))[0].tolist()
    assert got == [G[705], G[1699], ord("N"), ord("N")]
    k = P[1] - 1 - 10                       # plane 1 of sequence 1
    got = g.plane_chars(torch.tensor([[anchor[1] + k]]), torch.tensor([1]))
    assert got.item() == COMP[int(G[700 + 10])]


# -- gapped waves and records -------------------------------------------------

#: a genome of period 4: a shift by 1 to 3 bases mismatches every base, a
#: shift by 4 none
PERIODIC = np.frombuffer(b"ACGT" * 50, np.uint8).copy()


def gapped(rule, read: bytes, x: int, plane=0, gap=4):
    g = ref.Genome(PERIODIC, np.array([[0, PERIODIC.size]]), "cpu")
    r = np.frombuffer(read, np.uint8)[None, :].copy()
    P = 32 * (-(-PERIODIC.size // 32) + 2)
    loc = ref.MARGIN + x if plane == 0 else ref.MARGIN + P - len(read) - x
    return [t[0].tolist() for t in ref.extend_gap(
        ref.Rule(rule), g, torch.tensor([loc]), torch.tensor([plane]),
        torch.from_numpy(r), torch.tensor([len(read)]), gap)]


def test_extend_gap_hand_built():
    read = bytearray(PERIODIC[20:60].tobytes())          # 40 bases
    read[5] = ord("A") if read[5] != ord("A") else ord("C")
    count, pos0, pos1 = gapped("T:-", bytes(read), 20)
    assert count == 1
    assert pos0 == [5] + [40] * 13                        # padded with L
    assert len(pos1) == 8                                 # -1 +1 ... -4 +4
    for tt in range(6):                                   # shifts 1 to 3
        assert pos1[tt] == list(range(14))                # every base
    for tt in (6, 7):                                     # shifts -4, +4
        assert pos1[tt] == [40 - 1 - 5] + [40] * 13       # the substitution
    # the reverse plane: the read reverse-complemented, so that the
    # substitution lies at 34
    count, pos0, pos1 = gapped("T:-", rc(bytes(read)), 20, plane=1)
    assert count == 1 and pos0 == [34] + [40] * 13
    # the substituted base matches the genome moved by one shift of 1 to
    # 3 and by the one 4 away (period 4): there distance 5 is missing
    skip5 = [0, 1, 2, 3, 4] + list(range(6, 15))
    assert sorted(map(tuple, pos1[:6])) == [tuple(range(14))] * 4 + [
        tuple(skip5)] * 2
    assert pos1[6:] == [[5] + [40] * 13] * 2


def test_extend_gap_lists_an_n_by_its_code():
    # A:G codes C and N alike: an N over a C is no mismatch in the lists,
    # over an A it is; neither counts without -N
    read = bytearray(PERIODIC[20:60].tobytes())          # ACGT... from 20
    read[1], read[4] = ord("N"), ord("N")                 # over C, over A
    count, pos0, _ = gapped("A:G", bytes(read), 20)
    assert count == 0
    assert pos0 == [4] + [40] * 13


def test_extend_gap_equals_the_ports_cpu_gap_path(tmp_path):
    """Seeded random waves through the port's own device context on the
    CPU (``extend_kernel_blob(..., gap=3)``): every count and position."""
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.reads.encode import encode_batch
    from basal_tpu_torch.reads.io import ReadRec
    rng = np.random.default_rng(12)
    genome = data.NT[rng.integers(0, 4, 30000)]
    seqs = np.array([[0, 20000], [20000, 10000]])
    data._save_ref(tmp_path, data.Ref(genome, seqs, ["a", "b"]))
    lens = seqs[:, 1]
    P = 32 * (-(-lens // 32) + 2)
    anchor = ref.MARGIN + np.concatenate([[0], np.cumsum(P)[:-1]])
    for rule in ("T:-", "A:G", "C:T"):
        p = AlignParams(conversion=rule, gap=3, randseed=1)
        n, C = 200, 4000
        starts = rng.integers(0, 9000, n) + np.where(rng.random(n) < 0.5,
                                                     0, 20000)
        reads = genome[starts[:, None] + np.arange(100)].copy()
        reads[rng.random(reads.shape) < 0.03] = ord("N")
        enc = encode_batch(p, [ReadRec(i, 0, f"r{i}", reads[i].tobytes()
                                       .decode(), "I" * 100)
                               for i in range(n)])
        row = np.sort(rng.integers(0, 2 * n, C))
        i = row >> 1
        chrom = (starts[i] >= 20000).astype(int)
        x = starts[i] - seqs[chrom, 0] + rng.integers(-5, 6, C)
        plane = rng.integers(0, 2, C)
        loc = np.where(plane == 0, anchor[chrom] + x,
                       anchor[chrom] + P[chrom] - 100 - x)
        ctx = TorchDeviceContext(load_reference(str(tmp_path / "ref.fa"), p),
                                 p, "cpu")
        got = ctx.extend(enc, loc, plane, row)
        want = ref.extend_gap(
            ref.Rule(rule), ref.Genome(genome, seqs, "cpu"),
            torch.from_numpy(loc), torch.from_numpy(plane),
            torch.from_numpy(ref.chains(reads[i], np.full(C, 100), row & 1)),
            torch.full((C,), 100), 3)
        assert (got[0] == 0).sum() > 50              # true hits among them
        for name, g, w in zip(("counts", "pos0", "pos1"), got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=rule + name)


def test_gap_scan_takes_the_first_find():
    L = 100
    # a clean deletion at 50: the main alignment mismatches from 50 on, the
    # alignment shifted by +1 before 50 (nearest at 49: distance 50)
    p0 = list(range(50, 64))
    minus1 = [list(range(14))]            # shift -1: everywhere
    plus1 = [50, 51, 60, 61]              # distances 50, 51, ... (< 50 in)
    assert ref.gap_scan(p0, minus1 + [plus1], L, 14, 1) == (1, 50, 1)
    # near the end (97) the gap moves back to L - gap_edge = 94 at the
    # score found at 97: the three shifted mismatches nearer the end than
    # gap_edge count
    short = [[0, 1, 2, 3, 4, 5]]          # none as far as gap_edge
    assert ref.gap_scan([97, 98, 99], short + [[3, 4, 5, 6]], L, 14,
                        1) == (1, 94, 3 + 1)
    # a threshold under 1 + shift finds nothing
    assert ref.gap_scan(p0, minus1 + [plus1], L, 1, 1) is None
    # nothing within the edges
    assert ref.gap_scan([2, 3], minus1 + [[1, 2]], L, 14, 1) is None


def _designed(bases: dict) -> np.ndarray:
    g = G.copy()
    for k, v in bases.items():
        g[k] = ord(v)
    return g


def gap_record(pos, cigar, seq, nm, flag=0, zs="++"):
    return (f"r0\t{flag}\tchr1\t{pos}\t255\t{cigar}\t*\t0\t0\t{seq}\t"
            f"{'I' * len(seq)}\tNM:i:{nm}\tZS:Z:{zs}\n").encode()


def gap_check(line, genome, read, start=500, span=101, minus=False,
              gap=3, unique=True):
    r = data.Ref(genome, ONE, ["chr1"])
    pieces = (0, span - 100) if span > 100 else (0,)
    return ref.check_record(
        line, ref.Rule("T:-"), r, read,
        lambda i: ref.Origin(start, minus, unique, span, pieces), 10, False,
        gap=gap)


def test_gapped_record_with_a_deletion():
    g = _designed({549: "A", 550: "T", 551: "C", 552: "G"})
    read = np.concatenate([g[500:550], g[551:601]])[None, :].copy()
    seq = read[0].tobytes().decode()
    assert gap_check(gap_record(501, "50M1D50M", seq, 1), g, read) is None
    assert gap_check(gap_record(501, "50M1D50M", seq, 2), g,
                     read).startswith("NM")
    assert gap_check(gap_record(501, "49M1D51M", seq, 1), g,
                     read).startswith("NM")
    assert gap_check(gap_record(501, "50M1I49M", seq, 1), g,
                     read).startswith("NM")
    assert gap_check(gap_record(501, "50M4D50M", seq, 4), g,
                     read) == "CIGAR/POS"                 # k over -g 3
    assert gap_check(gap_record(501, "50M1D49M", seq, 1), g,
                     read) == "CIGAR/POS"                 # 99 bases
    # the ungapped record at the origin is worse than the gapped one
    nm = ref.mismatches(ref.Rule("T:-"), read[0], g[500:600], False)
    assert nm > 10
    assert gap_check(gap_record(501, "100M", seq, nm), g,
                     read).startswith("worse than its origin")
    # on the minus strand: the same record, reverse plane (ZS -+)
    rread = np.frombuffer(rc(read[0].tobytes()), np.uint8)[None, :].copy()
    line = gap_record(501, "50M1D50M", seq, 1, flag=16, zs="-+")
    assert gap_check(line, g, rread, minus=True) is None
    # a gapped record in an ungapped run stays wrong
    assert gap_check(gap_record(501, "50M1D50M", seq, 1), g, read,
                     gap=0) == "CIGAR/POS"


def test_gapped_record_with_an_insertion():
    g = _designed({549: "C", 550: "G"})
    read = np.concatenate([g[500:550], np.frombuffer(b"A", np.uint8),
                           g[550:599]])[None, :].copy()
    seq = read[0].tobytes().decode()
    line = gap_record(501, "50M1I49M", seq, 1)
    assert gap_check(line, g, read, span=99) is None
    assert gap_check(gap_record(501, "50M1I49M", seq, 0), g, read,
                     span=99).startswith("NM")
    assert gap_check(gap_record(501, "50M1I49M", seq, 1), g, read,
                     span=99, gap=0) == "CIGAR/POS"


def test_gapped_record_where_the_gap_moves_at_the_edge():
    # a deletion at 95: GapAlign finds it there and moves it back to
    # L - gap_edge = 94, where base 94 mismatches the shifted alignment
    g = _designed(dict(zip(range(594, 601), "ACGTACG")))
    read = np.concatenate([g[500:595], g[596:601]])[None, :].copy()
    seq = read[0].tobytes().decode()
    assert gap_check(gap_record(501, "94M1D6M", seq, 2), g, read) is None
    assert gap_check(gap_record(501, "95M1D5M", seq, 1), g,
                     read).startswith("NM")
    assert gap_check(gap_record(501, "94M1D6M", seq, 1), g,
                     read).startswith("NM")


def test_gapped_origin_counts_only_what_the_seeds_reach():
    # a deletion 10 bases into the read: no seed segment lies before it on
    # the read's strand, so the gapped alignment there is not sure; on the
    # other plane it lies 90 bases in and is found
    g = _designed({509: "A", 510: "T", 511: "C"})
    read = np.concatenate([g[500:510], g[511:601]])
    rule = ref.Rule("T:-")
    r = data.Ref(g, ONE, ["chr1"])
    o = ref.Origin(500, False, True, 101, (0, 1))
    fwd = ref.Frame(rule, r, 0, G.size, read, 0, 500, 3)
    assert not fwd.seeded(16, 4)
    assert ref.Frame(rule, r, 0, G.size, read, 0, 501, 3).seeded(16, 4)
    m, at = ref.gap_origin(rule, r, read, o, False, 3, 14)
    assert m is not None and 501 in at or 502 in at
