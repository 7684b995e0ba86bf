"""The benchmark's inputs: a genome made from a configuration's fixed seed,
and reads made from ``--seed`` by one general generator that reads a
traffic mix's parameters.

Frozen copies, rewritten for numpy in bulk (no code of the program or of
``bench.py`` / ``chip_smoke.py`` is imported):

- the repeat genome of ``bench.py:58-71`` at commit 6c33d98: unique
  segments of 300-1,200 bp, each followed by 1-3 copies of one 300 bp
  element, every base of a copy replaced by a random base with p 0.05;
- ``convert`` and ``add_ns`` of ``chip_smoke.py:198-225`` at commit
  6c33d98: conversions and substitutions, and one N in a share of the
  reads.

A rule whose read side is ``-`` (BID-seq's ``T:-``) is a deletion
chemistry: a share ``site_share`` of the genome's ``frm`` bases on each
strand are sites, drawn once from the genome's seed (a hash of the
position, so no genome-sized table is made); a read that covers a site
loses that base with p ``rate`` and is filled back to ``read_len`` from
the bases that follow in its window.  Each read's deletions are recorded
(``Reads.dels``).  Substitutions and Ns follow as for a conversion.

Where a read starts is the mix's ``source``: ``benchmark/sources/<source>.py``
with ``starts(rng, ref, mix, n, span)``, found by name, so a new kind of
traffic is a new file and a new mix of a known kind a data file alone.

Files are cached under ``<cache>/`` keyed by a hash of their parameters, so
a genome is written once per checkout and a read set once per (mix, seed,
count).  Nothing here imports torch, so a child process can make the data
without loading the program's libraries.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from typing import Optional

import numpy as np

NT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b
LINE = 60  # FASTA line width


def key(obj) -> str:
    """A short stable hash of JSON-able parameters."""
    blob = json.dumps(obj, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def revcomp(seqs: np.ndarray) -> np.ndarray:
    """Reverse complement of each row of a [n, L] char matrix."""
    return COMP[seqs[:, ::-1]]


# -- genome ---------------------------------------------------------------

def repeat_genome(g: dict):
    """(chars uint8 [length], unique segments int64 [n, 2] as [start, end))
    of the repeat genome that ``g`` describes (keys: length, seed,
    unique_min, unique_max, element_len, copies_min, copies_max,
    divergence)."""
    rng = np.random.default_rng(g["seed"])
    total = int(g["length"])
    elen = int(g["element_len"])
    element = rng.choice(NT, size=elen)
    mean_unit = ((g["unique_min"] + g["unique_max"]) / 2
                 + elen * (g["copies_min"] + g["copies_max"]) / 2)
    n = int(total / mean_unit * 1.2) + 16
    ulen = rng.integers(g["unique_min"], g["unique_max"], n)
    ncopy = rng.integers(g["copies_min"], g["copies_max"] + 1, n)
    unit = ulen + elen * ncopy
    ends = np.cumsum(unit)
    n = int(np.searchsorted(ends, total)) + 1
    if n > len(unit):
        raise ValueError("genome units drawn too short; raise the margin")
    ulen, ncopy, unit = ulen[:n], ncopy[:n], unit[:n]
    starts = ends[:n] - unit
    seq = np.empty(int(starts[-1] + unit[-1]), np.uint8)
    step = 1 << 24
    for a in range(0, seq.size, step):  # uniform bases, in blocks
        b = min(a + step, seq.size)
        seq[a:b] = NT[rng.integers(0, 4, b - a, dtype=np.uint8)]
    # copies: [start + ulen, start + unit) holds ncopy elements
    cstart = np.repeat(starts + ulen, ncopy) + elen * (
        np.arange(int(ncopy.sum())) - np.repeat(np.cumsum(ncopy) - ncopy,
                                                ncopy))
    for a in range(0, cstart.size, 1 << 16):
        cs = cstart[a:a + (1 << 16)]
        idx = cs[:, None] + np.arange(elen)[None, :]
        keep = rng.random(idx.shape) >= g["divergence"]
        seq[idx] = np.where(keep, element[None, :], seq[idx])
    seq = seq[:total]
    seg = np.stack([starts, np.minimum(starts + ulen, total)], axis=1)
    return seq, seg[seg[:, 0] < seg[:, 1]]


def write_fasta(f, name: str, seq: np.ndarray) -> None:
    """One FASTA record into the open binary file ``f``."""
    n = seq.size // LINE
    body = np.empty((n, LINE + 1), np.uint8)
    body[:, :LINE] = seq[:n * LINE].reshape(n, LINE)
    body[:, LINE] = ord("\n")
    f.write(b">" + name.encode() + b"\n")
    body.tofile(f)
    if seq.size > n * LINE:
        f.write(seq[n * LINE:].tobytes() + b"\n")


@dataclass
class Ref:
    """A reference as the benchmark holds it: its sequences' characters
    end to end, each sequence's (start, length) in them, their names, its
    unique segments ([start, end) in ``chars``) and the seed it was made
    from (which places a deletion chemistry's sites)."""
    chars: np.ndarray
    seqs: np.ndarray
    names: list
    unique: Optional[np.ndarray] = None
    seed: Optional[int] = None

    @cached_property
    def index(self) -> dict:
        return {n: i for i, n in enumerate(self.names)}


def _save_ref(d: Path, ref: Ref) -> None:
    with open(d / "ref.fa", "wb") as f:
        for name, (a, n) in zip(ref.names, ref.seqs.tolist()):
            write_fasta(f, name, ref.chars[a:a + n])
    ref.chars.tofile(d / "ref.seq")
    np.save(d / "seqs.npy", ref.seqs)
    (d / "names.json").write_text(json.dumps(ref.names))
    if ref.unique is not None:
        np.save(d / "unique.npy", ref.unique)


def load_ref(d: Path) -> Ref:
    u = d / "unique.npy"
    done = d / "done"
    seed = (json.loads(done.read_text()).get("seed") if done.exists()
            else None)
    return Ref(np.fromfile(d / "ref.seq", np.uint8), np.load(d / "seqs.npy"),
               json.loads((d / "names.json").read_text()),
               np.load(u) if u.exists() else None, seed)


def ensure_reference(cache: Path, genome: dict) -> Path:
    """The genome's directory (``ref.fa`` for the program; ``ref.seq``,
    ``seqs.npy``, ``names.json`` and ``unique.npy`` for the benchmark),
    made once and reused."""
    gdir = cache / f"genome-{key(genome)}"
    if not (gdir / "done").exists():
        gdir.mkdir(parents=True, exist_ok=True)
        seq, seg = repeat_genome(genome)
        _save_ref(gdir, Ref(seq, np.array([[0, seq.size]], np.int64),
                            [genome.get("name", "chr1")], seg))
        (gdir / "done").write_text(json.dumps(genome, sort_keys=True))
    return gdir


# -- traffic --------------------------------------------------------------

SOURCES = Path(__file__).resolve().parents[1] / "sources"


def source(name: str):
    """The ``starts`` function of ``benchmark/sources/<name>.py``."""
    path = SOURCES / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic source {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"benchsource_{name}",
                                                  path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.starts


def convert(rng, reads: np.ndarray, frm: str, to: str, rate: float,
            subst: float) -> np.ndarray:
    """Each ``frm`` base becomes one of ``to`` with p ``rate``, then every
    base is replaced by a random base with p ``subst``."""
    conv = (reads == ord(frm)) & (rng.random(reads.shape, np.float32) < rate)
    tos = np.frombuffer(to.encode(), np.uint8)
    if len(tos) == 1:
        reads = np.where(conv, tos[0], reads)
    else:
        reads = np.where(conv, rng.choice(tos, size=reads.shape), reads)
    return substitute(rng, reads, subst)


def substitute(rng, reads: np.ndarray, subst: float) -> np.ndarray:
    """Every base replaced by a random base with p ``subst`` (the count
    drawn as a binomial, the places uniformly)."""
    out = reads.astype(np.uint8)
    err = rng.integers(0, out.size, rng.binomial(out.size, subst))
    out.reshape(-1)[err] = rng.choice(NT, size=err.size)
    return out


def add_ns(rng, reads: np.ndarray, length: int, frac: float) -> None:
    """One N in about ``frac`` of the reads."""
    hit = np.flatnonzero(rng.random(len(reads)) < frac)
    reads[hit, (rng.random(hit.size) * length).astype(np.int64)] = ord("N")


CHUNK = 1 << 18   # reads converted per block
DEL_PAD = 8       # bases a deletion read's window holds past read_len


def site_draw(seed: int, key: np.ndarray) -> np.ndarray:
    """A uniform number in [0, 1) for each key, fixed by the seed
    (splitmix64 of seed and key): the same key draws the same number in
    every read set."""
    z = np.asarray(key, np.int64).astype(np.uint64)
    z = z + np.uint64((int(seed) * 0x9E3779B97F4A7C15) % (1 << 64))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)


@dataclass
class Reads:
    """n reads: their characters [n, L], the first base in ``Ref.chars``
    of the genome span each was read from (on the forward strand), and
    whether it was read from the minus strand.  Under a deletion chemistry
    ``dels`` [n, DEL_PAD, 2] holds each read's deletions, in order, as
    (read offset, length) in the read's own 5'-to-3' frame, padded with
    (-1, 0): offset d, length k means the read's first d bases precede k
    deleted genome bases."""
    chars: np.ndarray
    start: np.ndarray
    minus: np.ndarray
    dels: Optional[np.ndarray] = None

    @property
    def lens(self) -> np.ndarray:
        return np.full(len(self.chars), self.chars.shape[1], np.int64)

    @property
    def span(self) -> np.ndarray:
        """Genome bases each read's span covers: its length and its
        deleted bases."""
        if self.dels is None:
            return self.lens
        return self.lens + self.dels[:, :, 1].sum(1)


def delete(rng, win: np.ndarray, first: np.ndarray, minus: np.ndarray,
           frm: str, chem: dict, seed: int, L: int):
    """Deletion chemistry on windows ``win`` [m, L + DEL_PAD] in the reads'
    own frame (minus-strand windows already reverse-complemented) that
    start at ``first`` on the forward strand: a site is a ``frm`` base
    whose draw from the genome's ``seed`` (keyed by position and strand)
    is under ``site_share``; each site a read covers is deleted with p
    ``rate`` and the read is filled back to L from the window.  A window's
    first base is never deleted (a read begins at a base it holds).
    Returns (reads [m, L], forward first base of each read's span,
    deletions [m, DEL_PAD, 2])."""
    m, S = win.shape
    lose = (win == ord(frm)) & (rng.random(win.shape, np.float32)
                                < chem["rate"])
    lose[:, 0] = False
    rows, cols = np.nonzero(lose)
    fwd = np.where(minus[rows], first[rows] + (S - 1 - cols),
                   first[rows] + cols)
    hit = site_draw(seed, 2 * fwd + minus[rows]) < chem["site_share"]
    reads = np.ascontiguousarray(win[:, :L])
    used = np.full(m, L)
    dels = np.zeros((m, DEL_PAD, 2), np.int16)
    dels[:, :, 0] = -1
    some = np.unique(rows[hit])                  # the reads that lose bases
    if some.size:
        gone = np.zeros((some.size, S), bool)
        gone[np.searchsorted(some, rows[hit]), cols[hit]] = True
        gone &= np.cumsum(gone, axis=1) <= S - L     # L bases always remain
        take = np.argsort(gone, axis=1, kind="stable")[:, :L]
        reads[some] = np.take_along_axis(win[some], take, axis=1)
        used[some] = take[:, -1] + 1             # window bases consumed
        j = np.arange(S)
        gone &= j[None, :] < used[some][:, None]
        kept_before = j[None, :] - (np.cumsum(gone, axis=1) - gone)
        r, c = np.nonzero(gone)
        key = r.astype(np.int64) * (S + 1) + kept_before[r, c]
        runs, length = np.unique(key, return_counts=True)
        r = runs // (S + 1)
        rank = np.arange(r.size) - np.searchsorted(r, r)
        dels[some[r], rank, 0] = runs % (S + 1)
        dels[some[r], rank, 1] = length
    start = np.where(minus, first + S - used, first)
    return reads, start, dels


def make_reads(ref: Ref, mix: dict, chem: dict, n: int, seed: int,
               chunks=None) -> Reads:
    """n reads drawn where the mix's source says and converted as the
    chemistry says (keys: read_len, rule, rate, subst, n_frac,
    minus_share; a deletion chemistry also site_share).  Each block of
    CHUNK reads draws from a generator of its own, so ``chunks``, a set of
    block numbers, makes those blocks alone: the other rows stay zero (and
    take no memory until written)."""
    rng = np.random.default_rng([seed, 0])
    L = int(chem["read_len"])
    frm, to = chem["rule"].split(":")
    pad = DEL_PAD if to == "-" else 0
    starts = source(mix["source"])(rng, ref, mix, n, L + pad)
    windows = np.lib.stride_tricks.sliding_window_view(ref.chars, L + pad)
    alloc = np.empty if chunks is None else np.zeros
    reads = alloc((n, L), np.uint8)
    minus = np.zeros(n, bool)
    dels = None
    if pad:
        if ref.seed is None:
            raise ValueError("a deletion chemistry needs the genome's seed")
        dels = alloc((n, DEL_PAD, 2), np.int16)
    for a in range(0, n, CHUNK):
        if chunks is not None and a // CHUNK not in chunks:
            continue
        b = min(a + CHUNK, n)
        r = np.random.default_rng([seed, 1, a])
        win = windows[starts[a:b]]
        m = minus[a:b] = r.random(b - a) < chem.get("minus_share", 0.5)
        win[m] = revcomp(win[m])
        if pad:
            got, starts[a:b], dels[a:b] = delete(
                r, win, starts[a:b], m, frm, chem, ref.seed, L)
            reads[a:b] = substitute(r, got, chem["subst"])
        else:
            reads[a:b] = convert(r, win, frm, to, chem["rate"],
                                 chem["subst"])
        add_ns(r, reads[a:b], L, chem["n_frac"])
    return Reads(reads, starts, minus, dels)


def fastq_block(reads: np.ndarray, first: int) -> bytes:
    """FASTQ records ``@r<index>`` of a block of reads of one length, the
    index written with a fixed width so that the records make a matrix."""
    B, L = reads.shape
    idx = np.arange(first, first + B, dtype=np.int64)[:, None]
    digits = (idx // 10 ** np.arange(11, -1, -1, dtype=np.int64)) % 10
    name = np.concatenate([np.full((B, 2), np.frombuffer(b"@r", np.uint8)),
                           (digits + ord("0")).astype(np.uint8),
                           np.full((B, 1), ord("\n"), np.uint8)], axis=1)
    rec = np.concatenate([
        name, reads, np.full((B, 3), np.frombuffer(b"\n+\n", np.uint8)),
        np.full((B, L), ord("I"), np.uint8),
        np.full((B, 1), ord("\n"), np.uint8)], axis=1)
    return rec.tobytes()


def _gzip_member(data: bytes) -> bytes:
    c = zlib.compressobj(1, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def write_fastq_gz(path: Path, reads: np.ndarray, block: int = 100_000,
                   threads: int = 4) -> None:
    """Gzip FASTQ of the reads, named ``r<index>``, as concatenated gzip
    members compressed side by side (``gzip`` reads them as one stream)."""
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f, ThreadPoolExecutor(threads) as ex:
        starts = range(0, len(reads), block)
        blocks = ex.map(lambda a: _gzip_member(
            fastq_block(reads[a:a + block], a)), starts)
        for b in blocks:
            f.write(b)
    os.replace(tmp, path)


def ensure_reads(cache: Path, rdir: Path, mix: dict, chem: dict, n: int,
                 seed: int) -> Path:
    """``reads.fq.gz`` of (reference, mix, chemistry, seed, count), made
    once."""
    d = cache / f"reads-{key([mix, chem, n, seed, rdir.name])}"
    fq = d / "reads.fq.gz"
    if fq.exists():
        return fq
    d.mkdir(parents=True, exist_ok=True)
    write_fastq_gz(fq, make_reads(load_ref(rdir), mix, chem, n, seed).chars)
    return fq


def child_main(spec_json: str) -> None:
    """Entry of the data-making child process: makes the reference and the
    reads that a JSON spec describes and prints their paths as JSON."""
    spec = json.loads(spec_json)
    cache = Path(spec["cache"])
    rdir = ensure_reference(cache, spec["genome"])
    fq = ensure_reads(cache, rdir, spec["mix"], spec["chem"], spec["n"],
                      spec["seed"])
    print(json.dumps(dict(ref_dir=str(rdir), fasta=str(rdir / "ref.fa"),
                          reads=str(fq))))


if __name__ == "__main__":
    import sys
    child_main(sys.argv[1])
