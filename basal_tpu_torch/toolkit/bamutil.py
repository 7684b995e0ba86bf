"""Minimal samtools-equivalent operations over our own BAM codec, so the
reference's pipeline recipes (basal_pipeline_examples/*.sh) run without an
external samtools/sambamba:

  view  -F <flags> / --include-flags <flags>, SAM<->BAM, region query
  sort  coordinate sort (external spill-merge; bounded RSS on multi-GB BAMs,
        like the recipes' external `samtools sort`)
  fastq BAM -> FASTQ (mate-aware naming)
  index .bai writer (reference driver: pysam.index, basalkit.py:303-321)

All paths stream records (generator in -> sink out); nothing materializes a
whole multi-GB file as a Python list.

Copied from ``basal_tpu/toolkit/bamutil.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import gzip
import heapq
import os
import sys
import tempfile
from typing import Iterable, Iterator, List, Optional

from .bamio import BamWriter, iter_bam_sam_lines


def _iter_any(path: str) -> Iterator[str]:
    """Stream SAM lines (header first) from a SAM or BAM file."""
    if path.upper().endswith(".BAM"):
        yield from iter_bam_sam_lines(path)
    else:
        for line in open(path):
            line = line.rstrip("\n")
            if line:
                yield line


class _Sink:
    """Line sink writing SAM text, a BAM file, or stdout; buffers lines to
    keep BamWriter on its record-only C-encoder fast path."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path is None:
            self.fh = sys.stdout
        elif path.upper().endswith(".BAM"):
            self.fh = BamWriter(path)
        else:
            self.fh = open(path, "w")
        self.buf: List[str] = []
        self.nbytes = 0

    def write_line(self, line: str):
        self.buf.append(line)
        self.nbytes += len(line) + 1
        if self.nbytes >= 1 << 22:
            self.flush()

    def flush(self):
        if self.buf:
            self.fh.write("\n".join(self.buf) + "\n")
            self.buf = []
            self.nbytes = 0

    def close(self):
        self.flush()
        if self.path is not None:
            self.fh.close()


def _write_lines(lines: Iterable[str], path: Optional[str]):
    sink = _Sink(path)
    try:
        for l in lines:
            sink.write_line(l)
    finally:
        sink.close()


def view(path: str, out: Optional[str] = None, exclude_flags: int = 0,
         include_flags: int = 0, with_header: bool = True,
         header_only: bool = False, region: Optional[str] = None):
    if region:
        _view_region(path, region, out, exclude_flags, include_flags,
                     with_header)
        return

    def gen():
        for l in _iter_any(path):
            if l.startswith("@"):
                if with_header or header_only:
                    yield l
                continue
            if header_only:  # samtools view -H: header lines only
                continue
            flag = int(l.split("\t", 2)[1])
            if exclude_flags and (flag & exclude_flags):
                continue
            if include_flags and not (flag & include_flags):
                continue
            yield l
    _write_lines(gen(), out)


def _parse_region(region: str):
    """chr / chr:beg / chr:beg-end (1-based inclusive, samtools syntax)."""
    if ":" not in region:
        return region, 0, 1 << 60
    ref, _, span = region.partition(":")
    span = span.replace(",", "")
    if "-" in span:
        b, _, e = span.partition("-")
        return ref, max(0, int(b) - 1), int(e)
    return ref, max(0, int(span) - 1), 1 << 60


def _view_region(path: str, region: str, out: Optional[str],
                 exclude_flags: int, include_flags: int, with_header: bool):
    from .bamindex import build_index, fetch_sam_lines
    if not path.upper().endswith(".BAM"):
        raise SystemExit("region queries need a coordinate-sorted BAM")
    if not os.path.exists(path + ".bai"):
        build_index(path)
    ref, beg, end = _parse_region(region)

    def gen():
        if with_header:
            for l in _iter_any(path):
                if not l.startswith("@"):
                    break
                yield l
        for l in fetch_sam_lines(path, ref, beg, end):
            flag = int(l.split("\t", 2)[1])
            if exclude_flags and (flag & exclude_flags):
                continue
            if include_flags and not (flag & include_flags):
                continue
            yield l
    _write_lines(gen(), out)


def _sort_key_fn(chrs):
    def key(l: str) -> tuple:
        f = l.split("\t", 4)
        return (chrs.get(f[2], 1 << 30), int(f[3]))
    return key


def sort(path: str, out: str, mem_lines: int = 1_000_000):
    """Coordinate sort with bounded memory: runs of ``mem_lines`` records
    are sorted in RAM and spilled to gzip temp files, then k-way merged
    (heapq.merge is stable, so the result is byte-identical to a full
    in-memory stable sort).  Small inputs never spill."""
    it = _iter_any(path)
    header: List[str] = []
    first_rec = None
    for l in it:
        if l.startswith("@"):
            header.append(l)
        else:
            first_rec = l
            break
    chrs = {}
    for l in header:
        if l.startswith("@SQ"):
            d = dict(f.split(":", 1) for f in l.split("\t")[1:])
            chrs[d["SN"]] = len(chrs)
    key = _sort_key_fn(chrs)

    run: List[str] = []
    spills: List[str] = []
    tmpdir = None
    if first_rec is not None:
        run.append(first_rec)
        for l in it:
            run.append(l)
            if len(run) >= mem_lines:
                run.sort(key=key)
                if tmpdir is None:
                    tmpdir = tempfile.mkdtemp(prefix="bamutil_sort_")
                p = os.path.join(tmpdir, f"run{len(spills)}.gz")
                with gzip.open(p, "wt", compresslevel=1) as f:
                    f.write("\n".join(run) + "\n")
                spills.append(p)
                run = []
    run.sort(key=key)

    def read_run(p):
        with gzip.open(p, "rt") as f:
            for line in f:
                yield line.rstrip("\n")

    try:
        if spills:
            merged = heapq.merge(*[read_run(p) for p in spills], run, key=key)
        else:
            merged = iter(run)

        sink = _Sink(out)
        try:
            for l in header:
                sink.write_line(l)
            for l in merged:
                sink.write_line(l)
        finally:
            sink.close()
    finally:
        for p in spills:
            os.unlink(p)
        if tmpdir:
            os.rmdir(tmpdir)


def index(path: str, out: Optional[str] = None) -> str:
    from .bamindex import build_index
    return build_index(path, out)


def to_fastq(path: str, out: Optional[str] = None):
    from ..align.sam import revcomp
    opener = (gzip.open(out, "wt") if out and out.endswith(".gz")
              else open(out, "w") if out else sys.stdout)
    try:
        for l in _iter_any(path):
            if l.startswith("@"):
                continue
            f = l.split("\t")
            flag = int(f[1])
            seq, qual = f[9], f[10]
            if flag & 0x10:
                seq = revcomp(seq)
                qual = qual[::-1]
            name = f[0]
            if flag & 0x40:
                name += "/1"
            elif flag & 0x80:
                name += "/2"
            opener.write(f"@{name}\n{seq}\n+\n{qual}\n")
    finally:
        if out:
            opener.close()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: bamutil {view|sort|fastq|index} ...", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    import argparse
    if cmd == "view":
        p = argparse.ArgumentParser(prog="bamutil view")
        p.add_argument("input")
        p.add_argument("region", nargs="?", default=None,
                       help="chr[:beg[-end]] (needs/creates .bai)")
        p.add_argument("-o", "--out", default=None)
        p.add_argument("-F", type=lambda x: int(x, 0), default=0,
                       dest="exclude")
        p.add_argument("--include-flags", type=lambda x: int(x, 0), default=0)
        p.add_argument("-H", action="store_true", dest="header_only")
        a = p.parse_args(rest)
        view(a.input, a.out, a.exclude, a.include_flags,
             header_only=a.header_only, region=a.region)
    elif cmd == "sort":
        p = argparse.ArgumentParser(prog="bamutil sort")
        p.add_argument("input")
        p.add_argument("-o", "--out", required=True)
        p.add_argument("-m", "--mem-lines", type=int, default=1_000_000)
        a = p.parse_args(rest)
        sort(a.input, a.out, a.mem_lines)
    elif cmd == "index":
        p = argparse.ArgumentParser(prog="bamutil index")
        p.add_argument("input")
        p.add_argument("-o", "--out", default=None)
        a = p.parse_args(rest)
        index(a.input, a.out)
    elif cmd == "fastq":
        p = argparse.ArgumentParser(prog="bamutil fastq")
        p.add_argument("input")
        p.add_argument("-o", "--out", default=None)
        a = p.parse_args(rest)
        to_fastq(a.input, a.out)
    else:
        print(f"unknown bamutil command: {cmd}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
