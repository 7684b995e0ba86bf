"""Self-contained BGZF + BAM codec (no external samtools, no pysam).

Replaces both vendored libbam *input* (reads.cpp:34-37,88-107) and the
reference's ``popen("samtools view -bS -")`` *output* pipe (main.cpp:504-513)
— the aligner must not silently depend on an external binary (SURVEY §2.2).

BGZF: gzip members with the BC extra field carrying the compressed block
size; EOF marker block appended on close.  Records follow the SAM/BAM spec
the reference's libbam (samtools 0.1.18) understands.

Copied from ``basal_tpu/toolkit/bamio.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

_BGZF_HDR = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"  # gzip hdr, FEXTRA
             b"\x06\x00\x42\x43\x02\x00")                   # XLEN=6, BC, len=2
BGZF_EOF = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43"
            b"\x02\x00\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00")

_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}
_NT16_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NT16_CODE.update({c.lower(): i for i, c in enumerate("=acmgrsvtwyhkdbn")})
# byte translate tables so encode_bam_record packs seq/qual without a
# per-base Python loop (the loop cost 5-9s per 60k-record PE BAM)
_NT16_TRANS = bytes(_NT16_CODE.get(chr(i), 15) for i in range(256))
_QUAL_TRANS = bytes(min(max(i - 33, 0), 93) for i in range(256))


def reg2bin(beg: int, end: int) -> int:
    """BAM bin computation (SAM spec / bam.h)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _deflate_block(chunk: bytes, level: int) -> bytes:
    """One complete BGZF block for ``chunk`` (independent of every other
    block by format — each is a self-delimiting gzip member)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    # BSIZE = total block length - 1 (SAM spec §4.1; block = 16-byte
    # header + 2-byte BSIZE + cdata + 8-byte CRC/ISIZE = len(cdata)+26;
    # cf. BGZF_EOF: 28-byte block carries 0x1b = 27).
    bsize = len(cdata) + 25
    return (_BGZF_HDR + struct.pack("<H", bsize) + cdata
            + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                          len(chunk)))


class BgzfWriter:
    """BGZF writer with block-parallel compression.

    The reference offloads BAM compression to a samtools child process
    (main.cpp:505); here the deflate runs on a small thread pool instead —
    zlib releases the GIL, blocks are independent by format, and a FIFO
    future queue preserves block order.  ``threads<=1`` (or tiny outputs,
    which never exceed one block) keeps the serial path.
    """

    def __init__(self, path: str, level: int = 6, threads: Optional[int] = None):
        self.fh = open(path, "wb")
        self.level = level
        self.buf = bytearray()
        if threads is None:
            import os
            threads = min(4, os.cpu_count() or 1)
        self._pool = None
        self._futs = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            from collections import deque
            self._pool = ThreadPoolExecutor(threads)
            self._futs = deque()
            self._max_inflight = threads * 4

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 0xF000:
            self._flush_block(bytes(self.buf[:0xF000]))
            del self.buf[:0xF000]

    def _flush_block(self, chunk: bytes):
        if self._pool is None:
            self.fh.write(_deflate_block(chunk, self.level))
            return
        self._futs.append(self._pool.submit(_deflate_block, chunk,
                                            self.level))
        while len(self._futs) > self._max_inflight:
            self.fh.write(self._futs.popleft().result())

    def close(self):
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf = bytearray()
        if self._pool is not None:
            while self._futs:
                self.fh.write(self._futs.popleft().result())
            self._pool.shutdown()
        self.fh.write(BGZF_EOF)
        self.fh.close()


def parse_cigar(cig: str) -> List[tuple]:
    out = []
    n = 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, ch))
            n = 0
    return out


def encode_aux(tag: str, typ: str, val: str) -> bytes:
    t = tag.encode()
    if typ == "i":
        return t + b"i" + struct.pack("<i", int(val))
    if typ == "A":
        return t + b"A" + val.encode()[:1]
    if typ == "Z":
        return t + b"Z" + val.encode() + b"\x00"
    if typ == "f":
        return t + b"f" + struct.pack("<f", float(val))
    # B arrays / H hex: pass through as Z for robustness
    return t + b"Z" + val.encode() + b"\x00"


def encode_bam_record(fields: List[str], ref_ids: dict) -> bytes:
    (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
     qual) = fields[:11]
    flag = int(flag)
    pos = int(pos) - 1
    refid = ref_ids.get(rname, -1)
    if rnext == "=":
        nrefid = refid
    else:
        nrefid = ref_ids.get(rnext, -1)
    npos = int(pnext) - 1
    cig = [] if cigar == "*" else parse_cigar(cigar)
    l_seq = 0 if seq == "*" else len(seq)
    end = pos + 1
    if cig:
        end = pos + sum(n for n, op in cig if op in "MDN=X")
    bin_ = reg2bin(pos if pos >= 0 else 0, end if end > pos else pos + 1)
    name_b = qname.encode() + b"\x00"
    rec = bytearray()
    rec += struct.pack("<iiBBHHHiiii", refid, pos, len(name_b), int(mapq),
                       bin_, len(cig), flag, l_seq, nrefid, npos, int(tlen))
    rec += name_b
    for n, op in cig:
        rec += struct.pack("<I", (n << 4) | _CIGAR_CODE[op])
    if l_seq:
        codes = seq.encode("latin1").translate(_NT16_TRANS)
        if l_seq % 2:
            codes += b"\x00"
        import numpy as _np
        cb = _np.frombuffer(codes, _np.uint8)
        rec += ((cb[0::2] << 4) | cb[1::2]).astype(_np.uint8).tobytes()
    if qual == "*" or seq == "*":
        rec += b"\xff" * l_seq
    else:
        rec += qual.encode("latin1").translate(_QUAL_TRANS)
    for f in fields[11:]:
        tag, typ, val = f.split(":", 2)
        rec += encode_aux(tag, typ, val)
    return struct.pack("<i", len(rec)) + bytes(rec)


class BamWriter:
    """File-like sink for SAM text that writes a BAM file.

    Buffers header lines until the first record, then emits the BAM header
    block; thereafter encodes records on the fly.  Used by the CLI for
    ``-o out.bam`` (replacing main.cpp:504-513's samtools pipe).
    """

    def __init__(self, path: str):
        self.bgzf = BgzfWriter(path)
        self.header_lines: List[str] = []
        self.refs: List[tuple] = []
        self.ref_ids: dict = {}
        self.header_done = False
        self._tail = b""
        self._native_ok = True   # flips off after one C-encoder punt

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def write(self, text):
        if isinstance(text, str):
            text = text.encode("latin1")
        data = self._tail + text
        cut = data.rfind(b"\n")
        if cut < 0:
            self._tail = data
            return
        self._tail = data[cut + 1:]
        chunk = data[:cut + 1]
        while not self.header_done and chunk.startswith(b"@"):
            eol = chunk.index(b"\n")
            self._line(chunk[:eol].decode("latin1"))
            chunk = chunk[eol + 1:]
        if not chunk:
            return
        if self._native_ok and b"\n@" not in chunk \
                and not chunk.startswith(b"@"):
            # record-only chunk: one C-encoder pass (engine.cpp
            # bt_sam_to_bam, ~20x the per-line Python encoder)
            if not self.header_done:
                self._emit_header()
            from ..native import sam_records_to_bam
            enc = sam_records_to_bam(chunk, [n for n, _ in self.refs])
            if enc is not None:
                self.bgzf.write(enc)
                return
            self._native_ok = False
        for line in chunk.decode("latin1").split("\n"):
            self._line(line)

    def _line(self, line: str):
        if not line:
            return
        if line.startswith("@"):
            self.header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:])
                self.ref_ids[d["SN"]] = len(self.refs)
                self.refs.append((d["SN"], int(d["LN"])))
            return
        if not self.header_done:
            self._emit_header()
        self.bgzf.write(encode_bam_record(line.split("\t"), self.ref_ids))

    def _emit_header(self):
        text = ("\n".join(self.header_lines) + "\n").encode() \
            if self.header_lines else b""
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(self.refs))
        for name, ln in self.refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self.bgzf.write(bytes(out))
        self.header_done = True

    def close(self):
        if self._tail:
            self._line(self._tail.decode("latin1"))
            self._tail = b""
        if not self.header_done:
            self._emit_header()
        self.bgzf.close()


def read_bgzf(path: str) -> bytes:
    """Decompress a BGZF file by walking blocks via the BSIZE field.

    Strict: validates the gzip/FEXTRA magic, the BC extra field, BSIZE
    (total block length - 1), and each block's CRC32 — unlike Python's
    gzip module, which ignores BC and would hide a bad BSIZE.
    """
    out = bytearray()
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        hdr = data[off:off + 18]
        if len(hdr) < 18:
            raise ValueError(f"truncated BGZF block header at {off}")
        if hdr[:4] != b"\x1f\x8b\x08\x04" or hdr[12:16] != b"\x42\x43\x02\x00":
            raise ValueError(f"bad BGZF magic at {off}")
        bsize = struct.unpack_from("<H", hdr, 16)[0] + 1
        block = data[off:off + bsize]
        if len(block) < bsize:
            raise ValueError(f"truncated BGZF block at {off}")
        cdata = block[18:bsize - 8]
        chunk = zlib.decompress(cdata, -15)
        crc, isize = struct.unpack_from("<II", block, bsize - 8)
        if crc != (zlib.crc32(chunk) & 0xFFFFFFFF) or isize != len(chunk):
            raise ValueError(f"BGZF CRC/ISIZE mismatch at {off}")
        out += chunk
        off += bsize
    return bytes(out)


def decode_bam_to_sam(path: str) -> str:
    """Decode a BAM file to SAM text (toolkit BAM input + tests).  Records
    decode through the C twin (engine.cpp:bt_bam_to_sam, ~20x) when the
    native engine is available; decode_records_py is the golden fallback
    (and handles float aux, whose repr() the C side punts on)."""
    import io
    raw = read_bgzf(path)
    fh = io.BufferedReader(io.BytesIO(raw))
    assert fh.read(4) == b"BAM\x01"
    l_text = struct.unpack("<i", fh.read(4))[0]
    text = fh.read(l_text).decode(errors="replace")
    n_ref = struct.unpack("<i", fh.read(4))[0]
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack("<i", fh.read(4))[0]
        name = fh.read(ln)[:-1].decode()
        refs.append((name, struct.unpack("<i", fh.read(4))[0]))
    from ..native import bam_records_to_sam
    body = bam_records_to_sam(memoryview(raw)[fh.tell():],
                              [n for n, _ in refs])
    if body is not None:
        head = (text.rstrip("\n") + "\n") if text else ""
        # degenerate no-header no-record file: decode_records_py below
        # returns "\n".join([]) + "\n"
        return (head + body.decode("latin1")) or "\n"
    out = [text.rstrip("\n")] if text else []
    out += decode_records_py(raw[fh.tell():], refs)
    return "\n".join(out) + "\n"


def decode_records_py(raw: bytes, refs: List[tuple]) -> List[str]:
    """Pure-Python BAM record decoder over concatenated records (golden
    fallback for the C twin; exact SAM text semantics incl. float aux)."""
    import io
    fh = io.BufferedReader(io.BytesIO(raw))
    out: List[str] = []
    nt16 = "=ACMGRSVTWYHKDBN"
    while True:
        hdr = fh.read(4)
        if len(hdr) < 4:
            break
        sz = struct.unpack("<i", hdr)[0]
        d = fh.read(sz)
        (refid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, nrefid, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", d, 0)
        off = 32
        qname = d[off:off + l_rn - 1].decode()
        off += l_rn
        cig = ""
        for i in range(n_cig):
            v = struct.unpack_from("<I", d, off + 4 * i)[0]
            cig += f"{v >> 4}{_CIGAR_OPS[v & 0xF]}"
        off += 4 * n_cig
        seq = "".join(nt16[(d[off + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
                      for i in range(l_seq))
        off += (l_seq + 1) // 2
        qual = "".join(chr(q + 33) for q in d[off:off + l_seq])
        off += l_seq
        rname = refs[refid][0] if refid >= 0 else "*"
        rnext = "=" if nrefid == refid and nrefid >= 0 else (
            refs[nrefid][0] if nrefid >= 0 else "*")
        tags = []
        while off < len(d):
            tag = d[off:off + 2].decode()
            typ = chr(d[off + 2])
            off += 3
            if typ in "cC":
                val = str(d[off] if typ == "C" else
                          struct.unpack_from("<b", d, off)[0])
                off += 1
                typ = "i"
            elif typ in "sS":
                val = str(struct.unpack_from("<h" if typ == "s" else "<H",
                                             d, off)[0])
                off += 2
                typ = "i"
            elif typ in "iI":
                val = str(struct.unpack_from("<i" if typ == "i" else "<I",
                                             d, off)[0])
                off += 4
                typ = "i"
            elif typ == "f":
                val = repr(struct.unpack_from("<f", d, off)[0])
                off += 4
            elif typ == "A":
                val = chr(d[off])
                off += 1
            elif typ == "Z":
                end = d.index(0, off)
                val = d[off:end].decode()
                off = end + 1
            else:
                break
            tags.append(f"{tag}:{typ}:{val}")
        qual_out = "*" if (l_seq and set(qual) == {chr(0xFF + 33)}) else qual
        fields = [qname, str(flag), rname, str(pos + 1), str(mapq),
                  cig or "*", rnext, str(npos + 1), str(tlen), seq or "*",
                  qual_out]
        out.append("\t".join(fields + tags))
    return out


def iter_bam_sam_lines(path: str, chunk_bytes: int = 1 << 23):
    """Stream a BAM file as SAM lines (header lines first) in bounded
    memory: BGZF blocks are walked one at a time, complete records are
    batched into ~chunk_bytes buffers and decoded via the C twin
    (decode_records_py fallback per chunk).  Replaces whole-file
    decode_bam_to_sam for toolkit streaming paths (bamutil view/sort/fastq
    on multi-GB BAMs)."""
    from .bamindex import iter_bgzf_blocks
    from ..native import bam_records_to_sam
    blocks = iter_bgzf_blocks(path)
    buf = bytearray()

    def fill(need: int) -> bool:
        while len(buf) < need:
            try:
                buf.extend(next(blocks)[1])
            except StopIteration:
                return False
        return True

    if not fill(12) or bytes(buf[:4]) != b"BAM\x01":
        raise ValueError(f"not a BAM file: {path}")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    fill(8 + l_text + 4)
    text = bytes(buf[8:8 + l_text]).decode(errors="replace")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        fill(off + 4)
        ln = struct.unpack_from("<i", buf, off)[0]
        fill(off + 8 + ln)
        refs.append((bytes(buf[off + 4:off + 4 + ln - 1]).decode(),
                     struct.unpack_from("<i", buf, off + 4 + ln)[0]))
        off += 8 + ln
    for line in text.splitlines():
        if line:
            yield line
    del buf[:off]
    names = [n for n, _ in refs]

    def decode(chunk: bytes):
        body = bam_records_to_sam(memoryview(chunk), names)
        if body is not None:
            for line in body.decode("latin1").splitlines():
                yield line
        else:
            yield from decode_records_py(chunk, refs)

    while True:
        if not fill(4):
            if buf:
                raise ValueError("truncated BAM record size")
            return
        # extend to a batch of complete records >= chunk_bytes
        end = 0
        while True:
            if not fill(end + 4):
                break
            sz = struct.unpack_from("<i", buf, end)[0]
            if not fill(end + 4 + sz):
                raise ValueError("truncated BAM record")
            end += 4 + sz
            if end >= chunk_bytes:
                break
        yield from decode(bytes(buf[:end]))
        del buf[:end]
