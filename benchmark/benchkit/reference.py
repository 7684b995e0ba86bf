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

import re
from dataclasses import dataclass

import numpy as np
import torch

MARGIN = 12800      # REF_MARGIN (400 u64 words) x 32 bases
MAXSNPS = 15
GAP_EDGE = 6        # BASAL's gap_edge (param.cpp:57): no gap this near an end


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


K_POS = 14          # MAXSNPS - 1: the most mismatch positions GapAlign reads


def shifts(gap: int) -> list:
    """The gap kernel's shifted alignments in order: -1, +1, ..., -gap,
    +gap."""
    return [t * sign for t in range(1, gap + 1) for sign in (-1, 1)]


def first_positions(hit: torch.Tensor, score: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """The K_POS smallest ``score`` [C, n] where ``hit``, in ascending
    order, padded with each row's read length ``lens``."""
    s = torch.where(hit, score, lens[:, None].expand_as(score))
    return torch.sort(s, dim=1).values[:, :K_POS].to(torch.int32)


def extend_gap(rule: Rule, genome: Genome, loc, plane, reads: torch.Tensor,
               lens: torch.Tensor, gap: int, n_mis: bool = False):
    """What a gapped wave gives GapAlign (BASAL ``align.cpp:348-410``) for
    each candidate: (counts [C], pos0 [C, K_POS], pos1 [C, 2 gap, K_POS]),
    int32.

    ``counts`` as ``extend``.  ``pos0``: the read positions of the first
    K_POS mismatches of the alignment at ``loc``, ascending.  ``pos1``: for
    the alignments at loc - 1, loc + 1, loc - 2, loc + 2, ... up to
    loc +- gap, the first K_POS mismatches counted from the read's end, as
    their distance from it (length - 1 - position), ascending.  A position
    is a mismatch under the rule at any base inside the read's length, an
    N included (its code against the reference's); lists are padded with
    the read's length."""
    dev = genome.device
    counts = extend(rule, genome, loc, plane, reads, lens, n_mis)
    code = torch.from_numpy(rule.code).to(dev)
    mr = torch.from_numpy(rule.mread).to(dev)
    reads = reads.to(dev).long()
    lens = lens.to(dev).long()
    loc = loc.to(dev).long()
    plane = plane.to(dev).long()
    j = torch.arange(reads.shape[1], device=dev)
    inlen = j[None, :] < lens[:, None]
    rc, rm = code[reads], mr[reads]

    def mismatch(shift: int) -> torch.Tensor:
        refc = code[genome.plane_chars(loc[:, None] + shift + j[None, :],
                                       plane).long()]
        return flags(rule, rc, rm, refc) & inlen

    pos0 = first_positions(mismatch(0), j[None, :].expand_as(reads), lens)
    from_end = lens[:, None] - 1 - j[None, :]
    pos1 = [first_positions(mismatch(s), from_end, lens) for s in shifts(gap)]
    return counts, pos0, torch.stack(pos1, 1)


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
    characters, its strand, whether the window lies inside one unique
    segment (no other copy in the genome), the genome bases it spans (more
    than its length where a deletion chemistry took bases out), and where
    after ``start`` each piece of the read between deletions would align
    ungapped (the bases deleted before it on the forward strand)."""
    start: int
    minus: bool
    unique: bool
    span: int = 0
    pieces: tuple = (0,)


def check_record(line: bytes, rule: Rule, ref, reads: np.ndarray,
                 origins, limit: int, out_ref: bool, n_mis: bool = False,
                 gap: int = 0, gap_edge: int = GAP_EDGE, seeding=(16, 4)):
    """None if the record is right, else why not.

    Against itself: the read it names exists; SEQ and QUAL are the read
    (or, under flag 0x10, its reverse complement and reversed quality); a
    mapped record's strands (ZS) agree with flag 0x10, it lies inside the
    sequence it names, its NM equals the mismatches recounted at its POS
    under the rule, and with -R its XR is the genome around it: from 2
    bases before POS to 2 past the read's length from POS, as BASAL writes
    it (align.cpp:646-658), whatever the CIGAR.

    Against the read's origin (``origins(i) -> Origin``), with m the
    mismatches recounted there: a read with m <= ``limit`` is mapped
    (``"unmapped within the limit"``), its NM is no more than m
    (``"worse than its origin"``), and a read from a unique segment is
    reported at its origin, POS and strand (``"not at its origin"``).

    With ``gap`` 0 any CIGAR but ``{n}M`` is wrong.  With ``gap`` > 0
    (``-g``; ``seeding`` is the run's seed size and index interval) a
    record may also hold one gap, ``aMkDbM`` or ``aMkIbM`` with 1 <= k <=
    gap, that consumes the read's n bases over a reference span inside
    the sequence; its NM and gap position are what GapAlign takes with its
    main alignment at that span's start (plane 0, ZS ``+.``) or end (plane
    1), under a threshold up to the read's budget (``gap_scan``): where
    the gap was not moved at ``gap_edge`` that is the mismatches recounted
    along the CIGAR under the rule, plus k.  The origin is then what one
    gap can reach there (``gap_origin``): m is the least score the aligner
    surely finds, the POS one of an alignment there that scores m or less,
    and where the aligner surely finds nothing the origin is not
    checked."""
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
    written = np.frombuffer(f[9].encode(), np.uint8)
    o_seq = CM[written[::-1]] if rev != o.minus else written
    if gap:
        thres = read_budget(limit, gap, n)
        m, at = gap_origin(rule, ref, o_seq, o, n_mis, gap, thres, gap_edge,
                           seeding)
    else:
        og = ref.chars[o.start:o.start + n]
        m, at = mismatches(rule, o_seq, og, o.minus, n_mis), {o.start - a + 1}
    if flag & 0x4:
        return ("unmapped within the limit" if m is not None and m <= limit
                else None)
    tags = dict((t[:2], t[5:]) for t in f[11:])
    zs = tags.get("ZS", "")
    if len(zs) != 2 or ((zs[0] == "-") ^ (zs[1] == "-")) != rev:
        return "ZS/flag"
    if f[2] not in ref.index:
        return "RNAME"
    b, G = ref.seqs[ref.index[f[2]]].tolist()
    plane = int(zs[0] == "-")
    c = GAPPED.fullmatch(f[5]) if gap else None
    if c is None:
        if f[5] != f"{n}M" or pos < 1 or pos - 1 + n > G:
            return "CIGAR/POS"
        nm = mismatches(rule, written, ref.chars[b + pos - 1:b + pos - 1 + n],
                        plane == 1, n_mis)
        if str(nm) != tags.get("NM"):
            return f"NM {tags.get('NM')} recounted {nm}"
    else:
        lead, gone, op, tail = int(c[1]), int(c[2]), c[3], int(c[4])
        span = lead + tail + (gone if op == "D" else 0)
        if (not 1 <= gone <= gap or lead < 1 or tail < 1
                or lead + tail + (gone if op == "I" else 0) != n
                or pos < 1 or pos - 1 + span > G):
            return "CIGAR/POS"
        anchor = pos - 1 if plane == 0 else pos - 1 + span - 1
        p0, p1 = gap_lists(rule, ref, b, G, written, plane, anchor, gap)
        takes = [gap_scan(p0, p1, n, th, gap, gap_edge)
                 for th in range(2, thres + 1)]
        nm = tags.get("NM", "")
        nm = int(nm) if nm.isdigit() else None
        if (pos, f[5], nm) not in {_placed(t, n, plane, anchor)
                                   for t in takes if t}:
            return (f"NM {tags.get('NM')} {f[5]}, GapAlign takes "
                    f"{takes[-1] and _placed(takes[-1], n, plane, anchor)}")
    if out_ref:
        lo = max(pos - 3, 0)
        want = "".join(chr(ref.chars[b + x]) if x < G else rule.code0
                       for x in range(lo, pos - 1 + n + 2))
        if tags.get("XR", "").upper() != want:
            return "XR"
    if m is None:
        return None
    if nm > m:
        return f"worse than its origin (NM {nm}, origin {m})"
    if o.unique and (ref.index[f[2]] != k or pos not in at
                     or rev != o.minus):
        return "not at its origin"
    return None


# -- gapped SAM records ------------------------------------------------------

GAPPED = re.compile(r"(\d+)M(\d+)([DI])(\d+)M")


def read_budget(limit: int, gap: int, length: int) -> int:
    """A read's mismatch budget in a gapped run, as BASAL's FilterReads
    sets it (align.cpp:550-561): the -v limit plus 1 + gap, at most
    MAXSNPS, scaled by (length - 1) / length.  GapAlign's threshold starts
    there."""
    rms = min(limit + 1 + gap, MAXSNPS)
    return (rms + 1) * max(length - 1, 0) // max(length, 1)


def gap_scan(p0, p1, length: int, thres: int, gap: int,
             gap_edge: int = GAP_EDGE):
    """The gapped alignment BASAL's GapAlign (align.cpp:348-410) takes at a
    candidate under the threshold ``thres``, from the main alignment's
    mismatch positions ``p0`` (ascending) and, for each shift -1, +1, -2,
    +2, ..., the shifted alignment's mismatches as distances from the
    read's end (``p1[tt]``, ascending): (shift, gap position, score) or
    None.

    The read's first ``g`` bases follow the main alignment and the rest
    the shifted one (shift > 0: a deletion, < 0: an insertion); g is the
    i-th main mismatch and the rest starts past the j-th shifted mismatch
    from the end, the first such (i, j) in order, both at least
    ``gap_edge`` from the ends; the score is i + j + |shift|.  The first
    find is kept, not the best.  A gap found nearer the read's end than
    ``gap_edge`` is then moved back to that edge without rescoring: the
    score still counts the main alignment's mismatches between the two
    places, which the CIGAR puts after the gap, so there it need not be
    the mismatches recounted along the CIGAR plus |shift|."""
    if thres < 2:
        return None
    for shift, m2s in zip(shifts(gap), p1):
        t = abs(shift)
        if thres < 1 + t:
            break
        lead = min(shift, 0)
        last = length - t - 1
        for i in range(thres - t):
            g = p0[i] if i < len(p0) else length
            if not gap_edge <= g < last:
                continue
            for j in range(thres - t - i):
                m2 = m2s[j] if j < len(m2s) else length
                if not gap_edge <= m2 < last or g + m2 - lead < length:
                    continue
                return shift, min(g, length - gap_edge + lead), i + j + t
    return None


def _forward(ref, b: int, G: int, lo: int, hi: int) -> np.ndarray:
    """Characters of the sequence at [b, b + G) at offsets [lo, hi), N
    outside it."""
    x = np.arange(lo, hi)
    inside = (x >= 0) & (x < G)
    out = np.full(x.size, ord("N"), np.uint8)
    out[inside] = ref.chars[b + x[inside]]
    return out


class Frame:
    """The read as written on the forward strand, aligned on ``plane``
    with its main alignment anchored at sequence offset ``anchor``: plane
    0 reads the forward strand from the left end of the span, plane 1 the
    reverse strand from its right end with the read reverse-complemented,
    as the aligner compares them.  ``mism(shift)`` flags each read base
    that mismatches the alignment moved by ``shift`` under the rule, an N
    included (the gap kernel's position lists have it so)."""

    def __init__(self, rule: Rule, ref, b: int, G: int, written, plane: int,
                 anchor: int, gap: int):
        L = written.size
        if plane == 0:
            self.read = written
            self.genome = _forward(ref, b, G, anchor - gap, anchor + L + gap)
        else:
            self.read = CM[written[::-1]]
            self.genome = CM[_forward(ref, b, G, anchor - L - gap + 1,
                                      anchor + gap + 1)[::-1]]
        self.rule, self.gap, self.L = rule, gap, L
        t = torch.from_numpy
        self._rc, self._rm = t(rule.code[self.read]), t(rule.mread[self.read])

    def mism(self, shift: int) -> np.ndarray:
        g = self.genome[self.gap + shift:self.gap + shift + self.L]
        return flags(self.rule, self._rc, self._rm,
                     torch.from_numpy(self.rule.code[g])).numpy()

    def lists(self):
        """GapAlign's lists (p0, p1): see ``gap_scan``."""
        return np.flatnonzero(self.mism(0)), [
            np.sort(self.L - 1 - np.flatnonzero(self.mism(s)))
            for s in shifts(self.gap)]

    def seeded(self, seed_size: int, interval: int) -> bool:
        """Whether the aligner surely finds this main alignment as a
        candidate: one of the read's seed segments (BASAL's probes,
        ``profile[k][i] + start - i`` for i < interval, ``start`` up to
        (L - interval + 1) mod seed_size; param.cpp:70-74, align.cpp:
        468-524) holds only bases that match it exactly, no N, so that its
        probe on the index's grid hits."""
        L = self.L
        ok = ~self.mism(0) & self.rule.valid[self.read]
        bad = np.concatenate([[0], np.cumsum(~ok)])
        extra = (L - interval + 1) % seed_size
        i = np.arange(interval)
        for k in range((L - interval + 1) // seed_size):
            off = -(-(k * seed_size + i) // interval) * interval - i
            lo, hi = int(off.min()), int(off.max()) + extra + seed_size
            if hi <= L and bad[hi] == bad[lo]:
                return True
        return False


def gap_lists(rule: Rule, ref, b: int, G: int, written: np.ndarray,
              plane: int, anchor: int, gap: int):
    """GapAlign's lists (p0, p1) of the main alignment at ``anchor`` on
    ``plane`` (``Frame``)."""
    return Frame(rule, ref, b, G, written, plane, anchor, gap).lists()


def _placed(got, L: int, plane: int, anchor: int):
    """(POS, CIGAR, score) on the forward strand of ``gap_scan``'s find
    from the main alignment at ``anchor`` on ``plane``."""
    shift, g, score = got
    k, op = abs(shift), "D" if shift > 0 else "I"
    if plane == 0:
        first, lead = anchor, g
    else:                       # the span ends at the anchor, read reversed
        first, lead = anchor - (L + shift) + 1, L + min(shift, 0) - g
    tail = L - lead - (k if op == "I" else 0)
    return first + 1, f"{lead}M{k}{op}{tail}M", score


def gap_origin(rule, ref, written, o: Origin, n_mis: bool, gap: int,
               thres: int, gap_edge: int = GAP_EDGE, seeding=(16, 4)):
    """(m, POS set) of what one gap can reach at the read's origin, for the
    read as written on the forward strand there.

    The alignments there: the read ungapped where each piece of it between
    deletions lies (``Origin.pieces``), and what GapAlign takes
    (``gap_scan``, under the read's budget ``thres``) from each of those on
    either plane.  Each is surely found where the aligner surely has its
    main alignment as a candidate (``Frame.seeded``); a gapped one is a
    hit only once per POS, the first visited kept, so at a POS reached on
    both planes the worse score is the sure one.  m is the least sure
    score (None where nothing is sure), and the POS set holds every
    alignment's POS that scores m or less."""
    n = written.size
    k, _ = _sequence_of(ref, o.start)
    b, G = ref.seqs[k].tolist()
    x = o.start - b
    sure, could, gapped = [], {}, {}
    for left in sorted({x + d for d in o.pieces}):
        for plane in (0, 1):
            anchor = left if plane == 0 else left + n - 1
            fr = Frame(rule, ref, b, G, written, plane, anchor, gap)
            seeded = fr.seeded(*seeding)
            score = mismatches(rule, written, ref.chars[b + left:b + left + n],
                               plane == 1, n_mis)
            could[left + 1] = min(score, could.get(left + 1, score))
            if seeded:
                sure.append(score)
            got = gap_scan(*fr.lists(), n, thres, gap, gap_edge)
            if got is not None:
                p, _, score = _placed(got, n, plane, anchor)
                gapped.setdefault(p, []).append((score, seeded))
    for p, found in gapped.items():
        worst = max(s for s, _ in found)
        could[p] = min([v for v, _ in found] + [could.get(p, worst)])
        if any(seeded for _, seeded in found):
            sure.append(worst)
    if not sure:
        return None, set()
    m = min(sure)
    return m, {p for p, v in could.items() if v <= m}


def _sequence_of(ref, x: int):
    """(index, first character) of the sequence holding character x."""
    k = int(np.searchsorted(ref.seqs[:, 0], x, side="right")) - 1
    return k, int(ref.seqs[k, 0])
