"""BAI (BAM index) writer / reader / region query over our own BGZF codec.

The reference's mergeBAM driver ends with ``pysam.sort`` + ``pysam.index``
(reference basalkit.py:303-321); downstream consumers (IGV, region
views) need the ``.bai``.  This module replicates the *behavior* of samtools
0.1.18's index builder (reference samtools/bam_index.c:152-256
``bam_index_core``; serialization :258-320 ``bam_index_save``) on top of a
streaming BGZF walk, including its quirks:

- bins are taken from the record's ``bin`` field, not recomputed;
- the linear (16 kb window) index only sees mapped records with tid>=0, its
  length is ``end_window+1`` of the LAST such record (it can shrink), zero
  entries are back-filled from the left starting at window 1;
- per-ref metadata pseudo-bin 37450 carries (off_beg, off_end) and
  (n_mapped, n_unmapped) chunk pairs;
- adjacent chunks whose virtual offsets share a BGZF block are merged
  (bam_index.c:129 ``v>>16 == u>>16``);
- a trailing uint64 counts coordinate-less reads; record iteration stops
  binning at the first tid<0 record (bam_index.c:203 ``if (save_tid < 0)
  break``) and counts the remainder as n_no_coor.

samtools writes bins in khash iteration order; we write them sorted by bin
id (order is semantically irrelevant — readers load into a hash).  The test
suite compares our index against ``.oracle/samtools index`` output
*semantically* (parsed bins/chunks/linear/counts) and drives samtools
``view <region>`` through our .bai for independent validation.

Copied from ``basal_tpu/toolkit/bamindex.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: the docstring of fetch_sam_lines names the
reference's ``samtools/bam_index.c`` without a directory.
"""

from __future__ import annotations

import struct
import zlib
from bisect import bisect_right
from typing import Dict, Iterator, List, Tuple

BAM_MAX_BIN = 37450  # (8^6-1)/7 + 1, bam_index.c:45
LIDX_SHIFT = 14      # 16 kb linear-index windows


def iter_bgzf_blocks(path: str) -> Iterator[Tuple[int, bytes]]:
    """Stream (compressed_offset, uncompressed_chunk) per BGZF block.

    Bounded memory (one block at a time) — unlike bamio.read_bgzf which
    materializes the whole file.  Same strict validation.
    """
    with open(path, "rb") as fh:
        coff = 0
        while True:
            hdr = fh.read(18)
            if not hdr:
                return
            if len(hdr) < 18:
                raise ValueError(f"truncated BGZF block header at {coff}")
            if hdr[:4] != b"\x1f\x8b\x08\x04" or \
                    hdr[12:16] != b"\x42\x43\x02\x00":
                raise ValueError(f"bad BGZF magic at {coff}")
            bsize = struct.unpack_from("<H", hdr, 16)[0] + 1
            rest = fh.read(bsize - 18)
            if len(rest) < bsize - 18:
                raise ValueError(f"truncated BGZF block at {coff}")
            chunk = zlib.decompress(rest[:-8], -15)
            crc, isize = struct.unpack_from("<II", rest, len(rest) - 8)
            if crc != (zlib.crc32(chunk) & 0xFFFFFFFF) or isize != len(chunk):
                raise ValueError(f"BGZF CRC/ISIZE mismatch at {coff}")
            yield coff, chunk
            coff += bsize


class _VoffCursor:
    """Maps uncompressed stream positions to BGZF virtual offsets.

    Mirrors bgzf_tell semantics (samtools bgzf.c): a position that falls
    exactly at the end of block i reports (coff_i << 16 | ulen_i), not
    (coff_{i+1} << 16 | 0) — the reader only advances block_address lazily
    on the next read.  Position 0 is (0, 0).
    """

    def __init__(self):
        self.starts: List[int] = []   # uncompressed stream start per block
        self.coffs: List[int] = []
        self.ulens: List[int] = []
        self.total = 0

    def add_block(self, coff: int, ulen: int):
        self.starts.append(self.total)
        self.coffs.append(coff)
        self.ulens.append(ulen)
        self.total += ulen

    def drop_before(self, pos: int):
        """Forget blocks entirely before stream position ``pos`` (keep the
        one containing pos, and its predecessor for the block-end case)."""
        i = bisect_right(self.starts, pos) - 1
        if i > 1:
            del self.starts[:i - 1]
            del self.coffs[:i - 1]
            del self.ulens[:i - 1]

    def voff(self, pos: int) -> int:
        if pos == 0:
            return 0
        i = bisect_right(self.starts, pos) - 1
        if i >= 0 and pos == self.starts[i] and i > 0:
            i -= 1  # prefer earlier block: offset == its ulen
        return (self.coffs[i] << 16) | (pos - self.starts[i])


def iter_bam_records_voff(path: str):
    """Yield ``(beg_voff, end_voff, refid, pos, bin, flag, end_coor)`` per
    record, after first yielding ``("header", header_text, refs)``.

    end_coor is bam_calend: pos + sum of M/D/N/=/X lengths (min 1 op read);
    0-length alignment treated as length 1 (bam.h bam_calend + insert_offset2
    uses end-1 >> 14, samtools guards via cigar).  Streaming: memory is
    bounded by one record + one block.
    """
    cur = _VoffCursor()
    buf = bytearray()
    base = 0        # stream position of buf[0]
    blocks = iter_bgzf_blocks(path)

    def fill(need: int) -> bool:
        while len(buf) < need:
            try:
                coff, chunk = next(blocks)
            except StopIteration:
                return False
            cur.add_block(coff, len(chunk))
            buf.extend(chunk)
        return True

    if not fill(12):
        raise ValueError("not a BAM file (empty)")
    if bytes(buf[:4]) != b"BAM\x01":
        raise ValueError("not a BAM file (bad magic)")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    fill(8 + l_text + 4)
    header_text = bytes(buf[8:8 + l_text]).decode(errors="replace")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        fill(off + 4)
        ln = struct.unpack_from("<i", buf, off)[0]
        fill(off + 8 + ln)
        name = bytes(buf[off + 4:off + 4 + ln - 1]).decode()
        refs.append((name, struct.unpack_from("<i", buf, off + 4 + ln)[0]))
        off += 8 + ln
    yield ("header", header_text, refs)

    pos_stream = base + off
    del buf[:off]
    base = pos_stream
    while True:
        cur.drop_before(base)
        if not fill(4):
            if buf:
                raise ValueError("truncated BAM record size")
            return
        sz = struct.unpack_from("<i", buf, 0)[0]
        if not fill(4 + sz):
            raise ValueError("truncated BAM record")
        beg_voff = cur.voff(base)
        refid, pos, _lrn, _mapq, bin_, n_cig, flag = \
            struct.unpack_from("<iiBBHHH", buf, 4)
        l_rn = buf[12]
        end_coor = pos + 1
        if n_cig:
            co = 4 + 32 + l_rn
            rlen = 0
            for i in range(n_cig):
                v = struct.unpack_from("<I", buf, co + 4 * i)[0]
                if (v & 0xF) in (0, 2, 3, 7, 8):  # M D N = X
                    rlen += v >> 4
            end_coor = pos + (rlen if rlen else 1)
        base += 4 + sz
        del buf[:4 + sz]
        end_voff = cur.voff(base)
        yield (beg_voff, end_voff, refid, pos, bin_, flag, end_coor)


def build_index(bam_path: str, bai_path: str = None) -> str:
    """Build a .bai for a coordinate-sorted BAM (bam_index_core twin)."""
    bai_path = bai_path or bam_path + ".bai"
    it = iter_bam_records_voff(bam_path)
    _, _text, refs = next(it)
    n = len(refs)
    bins: List[Dict[int, List[List[int]]]] = [{} for _ in range(n)]
    lidx: List[List[int]] = [[] for _ in range(n)]
    lidx_n = [0] * n

    def ins(tid, b, u, v):
        bins[tid].setdefault(b, []).append([u, v])

    def ins2(tid, pos, end_coor, offset):
        beg = pos >> LIDX_SHIFT
        end = (end_coor - 1) >> LIDX_SHIFT
        arr = lidx[tid]
        if len(arr) < end + 1:
            arr.extend([0] * (end + 1 - len(arr)))
        for i in range(beg, end + 1):
            if arr[i] == 0:
                arr[i] = offset
        lidx_n[tid] = end + 1

    save_bin = save_tid = last_tid = last_bin = -1
    last_coor = -1
    save_off = last_off = off_beg = off_end = None
    n_mapped = n_unmapped = n_no_coor = 0
    first = True
    ended_early = False
    for beg_voff, end_voff, tid, pos, bin_, flag, end_coor in it:
        if first:
            save_off = last_off = off_beg = off_end = beg_voff
            first = False
        if tid < 0:
            n_no_coor += 1
        if (last_tid < tid and tid >= 0) or (last_tid >= 0 and tid < 0):
            last_tid = tid
            last_bin = -1
        elif tid >= 0 and (last_tid & 0xFFFFFFFF) > (tid & 0xFFFFFFFF):
            raise ValueError("BAM is not coordinate-sorted (chr order)")
        elif tid >= 0 and last_coor > pos:
            raise ValueError("BAM is not coordinate-sorted (pos order)")
        if tid >= 0 and not (flag & 0x4):
            ins2(tid, pos, end_coor, last_off)
        if bin_ != last_bin:
            if save_bin != -1:
                ins(save_tid, save_bin, save_off, last_off)
            if last_bin == -1 and save_tid != -1:
                off_end = last_off
                ins(save_tid, BAM_MAX_BIN, off_beg, off_end)
                ins(save_tid, BAM_MAX_BIN, n_mapped, n_unmapped)
                n_mapped = n_unmapped = 0
                off_beg = off_end
            save_off = last_off
            save_bin = last_bin = bin_
            save_tid = tid
            if save_tid < 0:
                ended_early = True
                break
        if flag & 0x4:
            n_unmapped += 1
        else:
            n_mapped += 1
        last_off = end_voff
        last_coor = pos
    if ended_early:
        # remaining records are coordinate-less; count them
        for rec in it:
            n_no_coor += 1
            if rec[2] >= 0:
                raise ValueError(
                    "BAM is not sorted: coordinate reads after tid<0 reads")
    elif save_tid >= 0:
        end_of_data = last_off
        ins(save_tid, save_bin, save_off, end_of_data)
        ins(save_tid, BAM_MAX_BIN, off_beg, end_of_data)
        ins(save_tid, BAM_MAX_BIN, n_mapped, n_unmapped)

    # merge adjacent chunks that share a BGZF block (bam_index.c:116-138)
    for tid in range(n):
        for b, lst in bins[tid].items():
            if b == BAM_MAX_BIN:
                continue
            m = 0
            for l in range(1, len(lst)):
                if lst[m][1] >> 16 == lst[l][0] >> 16:
                    lst[m][1] = lst[l][1]
                else:
                    m += 1
                    lst[m] = lst[l]
            del lst[m + 1:]
    # fill_missing (bam_index.c:140-149)
    for tid in range(n):
        arr = lidx[tid]
        for j in range(1, lidx_n[tid]):
            if arr[j] == 0:
                arr[j] = arr[j - 1]

    with open(bai_path, "wb") as fp:
        fp.write(b"BAI\x01")
        fp.write(struct.pack("<i", n))
        for tid in range(n):
            bd = bins[tid]
            fp.write(struct.pack("<i", len(bd)))
            for b in sorted(bd):
                lst = bd[b]
                fp.write(struct.pack("<Ii", b, len(lst)))
                for u, v in lst:
                    fp.write(struct.pack("<QQ", u, v))
            nl = lidx_n[tid]
            fp.write(struct.pack("<i", nl))
            for v in lidx[tid][:nl]:
                fp.write(struct.pack("<Q", v))
        fp.write(struct.pack("<Q", n_no_coor))
    return bai_path


def load_index(bai_path: str):
    """Parse a .bai into (per-ref {bin: [(u,v)...]}, per-ref linear list,
    n_no_coor) — used both for region queries and for semantic comparison
    with samtools-generated indexes in tests."""
    with open(bai_path, "rb") as fp:
        data = fp.read()
    if data[:4] != b"BAI\x01":
        raise ValueError("bad BAI magic")
    n = struct.unpack_from("<i", data, 4)[0]
    off = 8
    bins, lidx = [], []
    for _ in range(n):
        nb = struct.unpack_from("<i", data, off)[0]
        off += 4
        bd = {}
        for _ in range(nb):
            b, nc = struct.unpack_from("<Ii", data, off)
            off += 8
            bd[b] = [struct.unpack_from("<QQ", data, off + 16 * i)
                     for i in range(nc)]
            off += 16 * nc
        nl = struct.unpack_from("<i", data, off)[0]
        off += 4
        lidx.append(list(struct.unpack_from(f"<{nl}Q", data, off)))
        off += 8 * nl
        bins.append(bd)
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return bins, lidx, n_no_coor


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (SAM spec / bam.h reg2bins)."""
    out = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def _read_block_at(fh, coff: int) -> Tuple[bytes, int]:
    """Read + decompress the single BGZF block at compressed offset ``coff``
    (fh must be seekable).  Returns (uncompressed_chunk, block_size)."""
    fh.seek(coff)
    hdr = fh.read(18)
    if len(hdr) < 18:
        raise ValueError(f"truncated BGZF block header at {coff}")
    if hdr[:4] != b"\x1f\x8b\x08\x04" or hdr[12:16] != b"\x42\x43\x02\x00":
        raise ValueError(f"bad BGZF magic at {coff}")
    bsize = struct.unpack_from("<H", hdr, 16)[0] + 1
    rest = fh.read(bsize - 18)
    if len(rest) < bsize - 18:
        raise ValueError(f"truncated BGZF block at {coff}")
    return zlib.decompress(rest[:-8], -15), bsize


def fetch_sam_lines(bam_path: str, ref: str, beg: int, end: int,
                    bai_path: str = None, stats: dict = None) -> List[str]:
    """Region query: SAM lines of records overlapping [beg, end) (0-based).

    Seeks directly to the compressed offsets of the .bai's candidate chunks
    (samtools bam_fetch, reference samtools/bam_index.c:523-553:
    bam_seek to each chunk's beg voff, read until its end voff) — only the
    BGZF blocks covering the selected chunks are read and decompressed, and
    memory is bounded by one chunk's in-flight records.  Pass ``stats`` (a
    dict) to receive {"compressed_bytes_read", "blocks_read"} for I/O
    accounting (tests assert a small fraction of the file is touched).
    """
    from ..native import bam_records_to_sam
    bai_path = bai_path or bam_path + ".bai"
    it = iter_bam_records_voff(bam_path)
    _, _text, refs = next(it)
    it.close()
    names = [nm for nm, _ in refs]
    tids = {nm: i for i, nm in enumerate(names)}
    if ref not in tids:
        return []
    tid = tids[ref]
    bins, lidx, _ = load_index(bai_path)
    bd = bins[tid]
    min_off = 0
    w = beg >> LIDX_SHIFT
    if w < len(lidx[tid]):
        min_off = lidx[tid][w]
    chunks = []
    for b in reg2bins(beg, end):
        for u, v in bd.get(b, ()):  # type: ignore[arg-type]
            if v > min_off:
                chunks.append((max(u, min_off), v))
    chunks.sort()
    # coalesce overlapping/adjacent chunks (voff order == file order) so no
    # block is decompressed twice and no record decoded twice
    merged: List[List[int]] = []
    for u, v in chunks:
        if merged and u <= merged[-1][1]:
            if v > merged[-1][1]:
                merged[-1][1] = v
        else:
            merged.append([u, v])

    n_cbytes = 0
    n_blocks = 0
    out: List[str] = []
    with open(bam_path, "rb") as fh:
        for u, v in merged:
            coff = u >> 16
            chunk, bsize = _read_block_at(fh, coff)
            n_cbytes += bsize
            n_blocks += 1
            next_coff = coff + bsize
            buf = bytearray(chunk)
            # block table for stream-pos -> voff (record starts only, so the
            # containing-block convention suffices; see module docstring for
            # why boundary records still compare >= v correctly)
            blk_starts = [0]
            blk_coffs = [coff]
            p = u & 0xFFFF
            base = 0  # stream position of buf[0]
            while True:
                # voff of the record start at stream position p
                bi = bisect_right(blk_starts, p) - 1
                rv = (blk_coffs[bi] << 16) | (p - blk_starts[bi])
                if rv >= v:
                    break
                # ensure the 4-byte size, then the whole record
                need = p - base + 4
                eof = False
                while len(buf) < need:
                    try:
                        chunk, bsize = _read_block_at(fh, next_coff)
                    except ValueError:
                        eof = True
                        break
                    n_cbytes += bsize
                    n_blocks += 1
                    blk_starts.append(base + len(buf))
                    blk_coffs.append(next_coff)
                    next_coff += bsize
                    buf.extend(chunk)
                    if not chunk and bsize:
                        continue  # empty (EOF-marker) block mid-stream
                if eof or len(buf) < need:
                    break
                sz = struct.unpack_from("<i", buf, p - base)[0]
                need = p - base + 4 + sz
                while len(buf) < need:
                    chunk, bsize = _read_block_at(fh, next_coff)
                    n_cbytes += bsize
                    n_blocks += 1
                    blk_starts.append(base + len(buf))
                    blk_coffs.append(next_coff)
                    next_coff += bsize
                    buf.extend(chunk)
                o = p - base
                rtid, rpos = struct.unpack_from("<ii", buf, o + 4)
                l_rn = buf[o + 12]
                n_cig = struct.unpack_from("<H", buf, o + 16)[0]
                rlen = 0
                co = o + 36 + l_rn
                for i in range(n_cig):
                    cv = struct.unpack_from("<I", buf, co + 4 * i)[0]
                    if (cv & 0xF) in (0, 2, 3, 7, 8):
                        rlen += cv >> 4
                rend = rpos + (rlen if rlen else 1)
                if rtid == tid and rpos < end and rend > beg:
                    rec = bytes(buf[o:o + 4 + sz])
                    body = bam_records_to_sam(memoryview(rec), names)
                    if body is None:  # pragma: no cover
                        raise ValueError("record decode failed")
                    out.append(body.decode("latin1").rstrip("\n"))
                elif rtid > tid or (rtid == tid and rpos >= end):
                    # coordinate-sorted: nothing later can overlap — stop
                    # the whole fetch (bam_fetch's ret>0 break)
                    if stats is not None:
                        stats["compressed_bytes_read"] = n_cbytes
                        stats["blocks_read"] = n_blocks
                    return out
                p += 4 + sz
                # bound memory: drop consumed blocks behind p
                bi = bisect_right(blk_starts, p) - 1
                if bi > 0:
                    drop = blk_starts[bi] - base
                    del buf[:drop]
                    base += drop
                    del blk_starts[:bi]
                    del blk_coffs[:bi]
    if stats is not None:
        stats["compressed_bytes_read"] = n_cbytes
        stats["blocks_read"] = n_blocks
    return out
