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
