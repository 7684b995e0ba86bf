"""The plain reference that decides ``correct``.

It recomputes, from the benchmark's own inputs (the genome's characters
and the reads it generated from the seed), what the timed path produced:

- ``extend``: a candidate's mismatch count, base by base in plain
  PyTorch (any device), from the semantics of BASAL's conversion rules;
- ``check_record``: a SAM record, field by field, against the read and
  the genome, and against where the read was drawn from: a read within
  the mismatch limit at its origin has to be mapped, no worse than its
  origin, and at its origin where that lies in a unique segment.

It imports nothing of the program, of ``basal_tpu`` or of jax.  The rule
tables are a frozen copy of ``compile_conversion_rule``
(``basal_tpu/config.py`` at commit 6c33d98; BASAL's ``param.cpp:163-263``).

Coordinates.  The program's locations are on two strand planes of the
reference's sequences end to end (``Genome``); margin and padding compare
as code 0.  ``ref`` below is ``data.Ref`` with ``index``, a name's
position in ``names``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MARGIN = 12800      # REF_MARGIN (400 u64 words) x 32 bases
MAXSNPS = 15


class Rule:
    """Code tables of a ``-M X:Y...`` conversion rule: ``code[c]`` the
    2-bit code of char c (non-ACGT: 0), ``mread[c]`` 01 for a convert-to
    base, 11 for another base, 0 for a non-base; ``mode`` as the rule
    compares (oneway, multiway or nt3)."""

    def __init__(self, rule: str, nt3: bool = False):
        refnt = rule[0].upper()
        readnts = ""
        for ch in rule[2:]:
            if ch.upper() not in readnts:
                readnts += ch.upper()
        bit = {refnt: 1}
        if len(readnts) == 1 and readnts != "-":
            bit[readnts] = 3
        other = iter([0, 2, 3])
        for b in "ACGT":
            if b not in bit:
                bit[b] = next(other)
        self.code = np.zeros(256, np.uint8)
        self.mread = np.zeros(256, np.uint8)
        for b in "ACGT":
            for c in (b, b.lower()):
                self.code[ord(c)] = bit[b]
                self.mread[ord(c)] = 1 if b in readnts else 3
        self.valid = np.zeros(256, bool)
        self.valid[list(b"ACGTacgt")] = True
        one_way = len(readnts) == 1 and readnts != "-"
        self.mode = "nt3" if nt3 else ("oneway" if one_way else "multiway")
        self.code0 = "ACGT"[[bit[b] for b in "ACGT"].index(0)]


def flags(rule: Rule, read: torch.Tensor, mread: torch.Tensor,
          ref: torch.Tensor) -> torch.Tensor:
    """Mismatch per position of 2-bit read and reference codes."""
    if rule.mode == "nt3":
        def xt(v):
            return torch.where(v == 3, torch.ones_like(v), v)
        return (xt(read) ^ xt(ref)) != 0
    xc = torch.where(ref == 1, torch.ones_like(ref), torch.full_like(ref, 3))
    if rule.mode == "oneway":
        return ((read & xc) ^ ref) != 0
    m2 = xc | mread
    m3 = m2 & (((m2 & 2) >> 1) | ((m2 & 1) << 1))
    return ((((~m3) & 3 & m2) | (m3 & read)) ^ ref) != 0


class Genome:
    """Plane characters of a reference by concatenated location.  Sequence
    i starts at ``MARGIN + sum(P_j, j < i)``, where P_j is its length padded
    with N to ``32 * (ceil(len / 32) + 2)``; plane 1 holds each padded
    sequence reverse-complemented over the same locations."""

    def __init__(self, chars: np.ndarray, seqs: np.ndarray, device):
        starts, lens = seqs[:, 0], seqs[:, 1]
        padded = 32 * (-(-lens // 32) + 2)
        anchor = MARGIN + np.concatenate([[0], np.cumsum(padded)[:-1]])
        t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(device)
             for k, v in dict(start=starts, len=lens, P=padded,
                              anchor=anchor).items()}
        self.start, self.len, self.P, self.anchor = (
            t["start"], t["len"], t["P"], t["anchor"])
        self.seq = torch.from_numpy(np.ascontiguousarray(chars)).to(device)
        comp = np.full(256, ord("N"), np.uint8)
        for a, b in zip(b"ACGTacgt", b"TGCAtgca"):
            comp[a] = b
        self.comp = torch.from_numpy(comp).to(device)
        self.device = device

    def plane_chars(self, pos: torch.Tensor, plane: torch.Tensor):
        """Characters at concatenated locations ``pos`` [C, n] of planes
        ``plane`` [C]; N outside every sequence."""
        i = (torch.searchsorted(self.anchor, pos, right=True) - 1).clamp(
            0, self.anchor.numel() - 1)
        k = pos - self.anchor[i]
        n = self.len[i]
        x = torch.where(plane[:, None] == 0, k, self.P[i] - 1 - k)
        inside = (k >= 0) & (k < self.P[i]) & (x >= 0) & (x < n)
        c = self.seq[self.start[i] + torch.minimum(x.clamp(min=0), n - 1)]
        c = torch.where(plane[:, None] == 0, c, self.comp[c.long()])
        return torch.where(inside, c, torch.full_like(c, ord("N")))


def extend(rule: Rule, genome: Genome, loc, plane, reads: torch.Tensor,
           lens: torch.Tensor, n_mis: bool = False) -> torch.Tensor:
    """Mismatch counts [C] (int32, saturating at 255) of candidates at
    ``loc`` on ``plane`` for the read chains ``reads`` [C, Lmax] (chars, N
    past each length ``lens``)."""
    dev = genome.device
    code = torch.from_numpy(rule.code).to(dev)
    mr = torch.from_numpy(rule.mread).to(dev)
    valid = torch.from_numpy(rule.valid).to(dev)
    reads = reads.to(dev).long()
    lens = lens.to(dev).long()
    loc = loc.to(dev).long()
    plane = plane.to(dev).long()
    Lmax = reads.shape[1]
    j = torch.arange(Lmax, device=dev)
    inlen = j[None, :] < lens[:, None]
    refc = code[genome.plane_chars(loc[:, None] + j[None, :], plane).long()]
    f0 = flags(rule, code[reads], mr[reads], refc)
    counts = (f0 & valid[reads] & inlen).sum(1)
    if n_mis:
        counts = counts + (~valid[reads] & inlen).sum(1)
    return counts.clamp(max=255).to(torch.int32)


def chains(reads: np.ndarray, lens: np.ndarray, chain: np.ndarray):
    """Read chains: the read as it is (chain 0) or its reverse complement
    (chain 1), left-aligned, N past the length."""
    comp = np.full(256, ord("N"), np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    j = np.arange(reads.shape[1])[None, :]
    n = np.asarray(lens)[:, None]
    src = np.where((np.asarray(chain)[:, None] == 1) & (j < n), n - 1 - j, j)
    out = np.take_along_axis(reads, src, axis=1)
    return np.where(np.asarray(chain)[:, None] == 1, comp[out], out)


# -- SAM records ------------------------------------------------------------

CM = np.full(256, ord("N"), np.uint8)
for _x, _y in zip(b"ACGT", b"TGCA"):
    CM[_x] = _y


def mismatches(rule: Rule, seq: np.ndarray, genome_chars: np.ndarray,
               minus: bool, n_mis: bool = False) -> int:
    """Mismatches of SEQ as a record writes it (the read, or under flag
    0x10 its reverse complement) against the genome's characters under it,
    under the rule; on the minus strand the complements compare.  An N is
    no mismatch unless -N counts it."""
    if minus:
        seq, genome_chars = CM[seq], CM[genome_chars]
    t = torch.from_numpy
    mis = flags(rule, t(rule.code[seq]), t(rule.mread[seq]),
                t(rule.code[genome_chars]))
    if not n_mis:
        mis &= t(rule.valid[seq])
    else:
        mis |= ~t(rule.valid[seq])
    return int(mis.sum())


def mismatch_limit(max_snp_num: int, length: int) -> int:
    """A read's mismatch budget under -v (``max_snp_num`` 100 + percent,
    or a count under 100), as BASAL computes it (align.cpp:550-556)."""
    if max_snp_num < 100:
        return min(max_snp_num, MAXSNPS)
    return min(int((max_snp_num - 100) / 100.0 * length + 0.5), MAXSNPS)


@dataclass
class Origin:
    """Where a read was drawn from: its window's first base in the genome's
    characters, its strand, and whether the window lies inside one unique
    segment (no other copy in the genome)."""
    start: int
    minus: bool
    unique: bool


def check_record(line: bytes, rule: Rule, ref, reads: np.ndarray,
                 origins, limit: int, out_ref: bool, n_mis: bool = False):
    """None if the record is right, else why not.

    Against itself: the read it names exists; SEQ and QUAL are the read
    (or, under flag 0x10, its reverse complement and reversed quality); a
    mapped record's strands (ZS) agree with flag 0x10, it lies inside the
    sequence it names, its NM equals the mismatches recounted at its POS
    under the rule, and with -R its XR is the genome around it.

    Against the read's origin (``origins(i) -> Origin``), with m the
    mismatches recounted there: a read with m <= ``limit`` is mapped
    (``"unmapped within the limit"``), its NM is no more than m
    (``"worse than its origin"``), and a read from a unique segment is
    reported at its origin, POS and strand (``"not at its origin"``)."""
    f = line.decode("latin1").rstrip("\n").split("\t")
    if len(f) < 11 or not f[0].startswith("r"):
        return "malformed"
    i = int(f[0][1:])
    if not 0 <= i < len(reads):
        return "unknown read"
    flag, pos = int(f[1]), int(f[3])
    seq = reads[i].tobytes().decode()
    n = len(seq)
    qual = "I" * n
    rev = bool(flag & 0x10)
    comp = str.maketrans("ACGTN", "TGCAN")
    if (f[9], f[10]) != ((seq.translate(comp)[::-1], qual[::-1]) if rev
                         else (seq, qual)):
        return "SEQ/QUAL"
    o = origins(i)
    k, a = _sequence_of(ref, o.start)
    og = ref.chars[o.start:o.start + n]
    written = np.frombuffer(f[9].encode(), np.uint8)
    o_seq = CM[written[::-1]] if rev != o.minus else written
    m = mismatches(rule, o_seq, og, o.minus, n_mis)
    if flag & 0x4:
        return "unmapped within the limit" if m <= limit else None
    tags = dict((t[:2], t[5:]) for t in f[11:])
    zs = tags.get("ZS", "")
    if len(zs) != 2 or ((zs[0] == "-") ^ (zs[1] == "-")) != rev:
        return "ZS/flag"
    if f[2] not in ref.index:
        return "RNAME"
    b, G = ref.seqs[ref.index[f[2]]].tolist()
    if f[5] != f"{n}M" or pos < 1 or pos - 1 + n > G:
        return "CIGAR/POS"
    nm = mismatches(rule, written, ref.chars[b + pos - 1:b + pos - 1 + n],
                    zs[0] == "-", n_mis)
    if str(nm) != tags.get("NM"):
        return f"NM {tags.get('NM')} recounted {nm}"
    if out_ref:
        lo = max(pos - 3, 0)
        want = "".join(chr(ref.chars[b + x]) if x < G else rule.code0
                       for x in range(lo, pos - 1 + n + 2))
        if tags.get("XR", "").upper() != want:
            return "XR"
    if nm > m:
        return f"worse than its origin (NM {nm}, origin {m})"
    if o.unique and (ref.index[f[2]] != k or pos != o.start - a + 1
                     or rev != o.minus):
        return "not at its origin"
    return None


def _sequence_of(ref, x: int):
    """(index, first character) of the sequence holding character x."""
    k = int(np.searchsorted(ref.seqs[:, 0], x, side="right")) - 1
    return k, int(ref.seqs[k, 0])
