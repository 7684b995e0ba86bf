"""Reference genome loading and 2-bit packing (TPU-native layout).

Equivalent of the reference's ``refbase.{h,cpp}`` loader/packer
(``RefSeq::LoadNextSeq/BinSeq/cBinSeq/UnmaskRegion/Run_ConvertBinseq``,
refbase.cpp:13-252) with one layout change: sequences are packed into
**uint32 words of 16 bases** (TPU has no native int64) instead of u64 words
of 32.  A u64 word in the reference equals two consecutive u32 words here,
so all coordinates and anchors are bit-compatible.

Layout: two concatenated planes
  plane 0: every sequence forward, remapped 2-bit codes (first base in MSBs)
  plane 1: every sequence reverse-complemented (cf. cBinSeq, refbase.cpp:85-101)
with a 400-u64-word (=12800 base) margin before/after (REF_MARGIN,
refbase.h:16) and 2 u64 pad words per sequence (BINSEQPAD).  Margin/pad bases
encode as code 0 ('N' through the LUT), deterministically zero here (the
reference leaves margins uninitialized; they only affect candidates that are
later rejected by bounds checks, so zero-fill is output-equivalent).

Copied from ``basal_tpu/index/reference.py`` at cb4d597: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, List, Tuple

import numpy as np

from ..config import (AlignParams, BINSEQPAD, REF_MARGIN, SEGLEN, SEGLEN32)

USEFUL = np.zeros(256, dtype=bool)
for _c in "ACGTacgt":
    USEFUL[ord(_c)] = True
NXMASK = np.zeros(256, dtype=bool)
for _c in "NXnx":
    NXMASK[ord(_c)] = True


def open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.open(path, "rb"))
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, byte-array of sequence chars).  Name is the first
    whitespace-delimited token after '>' (refbase.cpp:23 ``fin>>_name``).

    Whole-file numpy parse (newline strip via boolean mask) — the reference
    streams line by line; at 50 Mbp+ that costs tens of seconds in Python."""
    with open_maybe_gz(path) as f:
        data = f.read()
    pos = 0
    while True:
        start = data.find(b">", pos)
        if start < 0:
            return
        hdr_end = data.find(b"\n", start)
        if hdr_end < 0:
            return
        header = data[start + 1:hdr_end]
        name = header.split()[0].decode() if header.split() else ""
        nxt = data.find(b">", hdr_end)
        body = data[hdr_end + 1:nxt if nxt >= 0 else len(data)]
        arr = np.frombuffer(body, dtype=np.uint8)
        # strip \n \r \t and spaces in one comparison (all whitespace is
        # <= 0x20; sequence chars incl. IUPAC/lowercase/'-' are all above)
        yield name, arr[arr > 0x20]
        if nxt < 0:
            return
        pos = nxt


def pack_codes_u32(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes (len multiple of 16) into u32 words, first base in
    bits 31:30 (big-endian base order, matching the reference's u64 packing
    split into hi/lo u32)."""
    assert codes.size % SEGLEN32 == 0
    c = codes.reshape(-1, SEGLEN32).astype(np.uint32)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    return np.bitwise_or.reduce(c << shifts[None, :], axis=1)


@dataclasses.dataclass
class RefTitle:
    name: str
    size: int
    rc_offset: int  # padded length in bases (refbase.cpp:195)


@dataclasses.dataclass
class Block:
    """Unmasked (indexable) region, plane-local base coords (refbase.h:32-37)."""
    id: int      # even = fwd plane of chr id//2, odd = RC plane
    begin: int
    end: int


@dataclasses.dataclass
class PackedReference:
    titles: List[RefTitle]          # one per chr (the reference stores 2; ours
                                    # maps chr-index c -> titles[c >> 1])
    ref32: np.ndarray               # uint32 [2, NW32] fwd / RC planes
    ref_anchor: np.ndarray          # int64 [nchr+1] concatenated base anchors
    blocks: List[Block]
    sum_length: int

    @property
    def total_num(self) -> int:
        return len(self.titles)

    def title_of(self, chr_index: int) -> RefTitle:
        """chr_index uses the reference convention: 2*chr + plane."""
        return self.titles[chr_index >> 1]


def load_reference(path: str, params: AlignParams) -> PackedReference:
    rule = params.rule
    titles: List[RefTitle] = []
    blocks: List[Block] = []
    fwd_words: List[np.ndarray] = []
    rc_words: List[np.ndarray] = []
    count = 0
    sum_length = 0

    try:  # fused C++ map+pack (one pass over the chars vs ~16 numpy passes)
        from ..native import native_available, native_pack_ref
        pack_native = native_available()
    except Exception:  # noqa: BLE001 - native engine is optional
        pack_native = False

    for name, seq in iter_fasta(path):
        length = len(seq)
        nwords64 = (length + SEGLEN - 1) // SEGLEN + BINSEQPAD
        padded = np.full(nwords64 * SEGLEN, ord("N"), dtype=np.uint8)
        padded[:length] = seq
        titles.append(RefTitle(name=name, size=length, rc_offset=nwords64 * SEGLEN))
        # RC plane: reverse-complement of the *padded* sequence (cBinSeq reads
        # from the padded end backwards, refbase.cpp:85-101)
        if pack_native:
            fwd_words.append(native_pack_ref(padded, rule.alphabet))
            rc_words.append(native_pack_ref(padded, rule.rev_alphabet,
                                            reverse=True))
        else:
            fwd_words.append(pack_codes_u32(rule.alphabet[padded]))
            rc_words.append(pack_codes_u32(rule.rev_alphabet[padded[::-1]]))
        blocks.extend(_unmask_region(seq, count, nwords64 * SEGLEN))
        count += 2
        sum_length += length

    blocks.sort(key=lambda b: (b.id, b.begin))

    margin32 = REF_MARGIN * 2  # u32 words in the margin
    total32 = sum(w.size for w in fwd_words)
    nw32 = total32 + 2 * margin32
    ref32 = np.zeros((2, nw32), dtype=np.uint32)
    # anchors: ref_anchor[0]=REF_MARGIN*32; ref_anchor[i+1]=(cum_words64+REF_MARGIN)*32
    # (refbase.cpp:222-226)
    anchors = [REF_MARGIN * SEGLEN]
    cum = 0
    off = margin32
    for w, cw in zip(fwd_words, rc_words):
        ref32[0, off:off + w.size] = w
        ref32[1, off:off + cw.size] = cw
        off += w.size
        cum += w.size // 2
        anchors.append((cum + REF_MARGIN) * SEGLEN)

    return PackedReference(
        titles=titles, ref32=ref32,
        ref_anchor=np.asarray(anchors, dtype=np.int64),
        blocks=blocks, sum_length=sum_length,
    )


def _unmask_region(seq: np.ndarray, count: int, total_len: int) -> List[Block]:
    """Scan for indexable runs >=16bp (RefSeq::UnmaskRegion, refbase.cpp:103-128).

    A run starts at the next ACGT/acgt char and ends at the next N/X/n/x char;
    other IUPAC letters neither start nor end a run.  NOTE: the reference's
    '<5bp gap merge' branch is dead code (it compares a fwd block id against
    the last *mirrored* block's id, which never matches), so no merging here.
    Mirrored RC-plane blocks use the padded total length.
    """
    length = len(seq)
    try:  # single C++ pass (the numpy transition scan below materializes
        # several length-sized boolean temporaries — ~3.5 s at 200 Mbp)
        from ..native import native_unmask_blocks
        nat = native_unmask_blocks(seq, USEFUL, NXMASK)
    except Exception:  # noqa: BLE001 - native engine is optional
        nat = None
    if nat is not None:
        out = []
        for b, e in zip(nat[0].tolist(), nat[1].tolist()):
            out.append(Block(id=count, begin=b, end=e))
            out.append(Block(id=count + 1, begin=total_len - e,
                             end=total_len - b))
        return out
    useful = USEFUL[seq]
    nx = NXMASK[seq]
    out: List[Block] = []
    # Only RUN STARTS can ever be selected by the scan below: ``begin`` is
    # the first useful char at/after an nx position (never useful), so its
    # predecessor is non-useful; ``bend`` is the first nx char after a
    # useful char, so its predecessor is non-nx.  Scanning transitions
    # instead of every position avoids materializing a ~length-sized int64
    # index array (400 MB and seconds of nonzero on an N-free 50 Mbp
    # genome, where every base is useful).
    useful_idx = np.flatnonzero(useful[1:] & ~useful[:-1]) + 1
    if length and useful[0]:
        useful_idx = np.concatenate([[0], useful_idx])
    nx_idx = np.flatnonzero(nx[1:] & ~nx[:-1]) + 1
    if length and nx[0]:
        nx_idx = np.concatenate([[0], nx_idx])
    end = 0
    while end < length:
        k = np.searchsorted(useful_idx, end)
        if k == len(useful_idx):
            break
        begin = int(useful_idx[k])
        k2 = np.searchsorted(nx_idx, begin)
        bend = int(nx_idx[k2]) if k2 < len(nx_idx) else length
        bend = min(bend, length)
        if bend - begin >= 16:
            out.append(Block(id=count, begin=begin, end=bend))
            out.append(Block(id=count + 1, begin=total_len - bend, end=total_len - begin))
        end = bend  # bend > begin >= end always (useful and nx are disjoint)
    return out
