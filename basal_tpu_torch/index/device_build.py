"""The dense seed index built on the run's card.

``build_index_on(ref, params, device)`` returns the ``SeedIndex`` of
``index.seedindex.build_index``, bit for bit: ``starts`` int64 [3^s]
(0 for an empty k-mer), ``counts`` and ``n1`` int32, ``locs`` uint32 with
each k-mer's chain-0 entries first, then its chain-1 entries, each chain in
block-traversal order, and the same ``max_kmer_num``.  It builds on the card
when the run's device is CUDA and the build fits in the card's free memory
with a margin (``build_place``); elsewhere, a CPU run or a reference too
large for the card, ``build_index`` builds on the host.

``device_build`` runs on the card through the kernels of
``csrc/index_build.cu`` and on CPU tensors through their plain torch
version (the CPU tests), in three steps over the stream of probed
positions: chain 0 then chain 1, blocks in (id, begin) order, each block's
positions ``start .. i2`` step I plus its anchor (``_chain_positions``).

1. ``index.device_build.seeds``: the packed words go up; per entry, its
   position from the blocks' runs, its seed from the words
   (``bits.seeds_from_words``' arithmetic), and per k-mer the count and the
   chain-0 count.
2. ``index.device_build.sort``: one stable sort of the positions by seed,
   which is ``locs``: within a k-mer the entries keep the stream's order;
   ``starts`` is the counts' exclusive prefix sum, 0 for an empty k-mer.
3. ``index.device_build.copy``: the four tables come back into host arrays
   allocated as ``native.native_build_seed_index`` allocates them
   (``np.empty``, ``madvise_hugepage``); no host array as long as the
   positions exists.  The over-represented cutoff is computed on the host
   (``seedindex._kmer_cutoff_dense``), and the card's cache is emptied
   before the aligners start.

What the card holds (``card_bytes``): the packed words (8 B a word pair),
16 B per position (seed and position, each twice for the sort) and 16 B
per k-mer slot (``counts``, ``n1``, ``starts``), with the sort's scratch
inside ``MARGIN``.  At seed size 16, interval 4: 400 Mbp (2 x 100M
positions) about 4.1 GB; hg38's 3.1 Gbp (about 1.55 G positions, 194M
words a plane) about 27.0 GB, which an 80 GB card takes on the card path.
A sort takes at most 2^31 - 1 positions (``MAX_POSITIONS``, about 8.5 Gbp
at interval 4); a larger reference is built on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..config import AlignParams
from ..native import madvise_hugepage
from ..ops.bitops import u32, xt16_base3
from .reference import PackedReference
from .seedindex import SeedIndex, _kmer_cutoff_dense, build_index

#: free card memory the build leaves untouched
MARGIN = 1 << 30
#: card bytes per position: keys and positions, each with the sort's
#: second buffer
ENTRY_BYTES = 16
#: card bytes per k-mer slot: counts, n1 (int32) and starts (int64)
SLOT_BYTES = 16
#: the most positions one sort takes (CUB's int item count)
MAX_POSITIONS = (1 << 31) - 1


def _chain_runs(ref: PackedReference, params: AlignParams, chain: int):
    """(first position, number of positions) of each block of one strand
    plane that has any, in traversal order (``_chain_positions``)."""
    I, s = params.index_interval, params.seed_size
    blocks = [b for b in ref.blocks if b.id % 2 == chain]
    ids = np.array([b.id for b in blocks], np.int64)
    start = np.array([b.begin for b in blocks], np.int64) // I * I
    i2 = (np.array([b.end for b in blocks], np.int64) - s) // I * I
    keep = i2 >= start
    base = ref.ref_anchor[ids[keep] // 2] + start[keep]
    return base, (i2[keep] - start[keep]) // I + 1


def n_positions(ref: PackedReference, params: AlignParams) -> int:
    return int(sum(_chain_runs(ref, params, c)[1].sum() for c in (0, 1)))


def card_bytes(ref: PackedReference, params: AlignParams) -> int:
    """The card memory ``device_build`` takes, the sort's scratch aside
    (``MARGIN`` covers it)."""
    return (ref.ref32.nbytes + ENTRY_BYTES * n_positions(ref, params)
            + SLOT_BYTES * params.total_kmers)


def build_place(ref: PackedReference, params: AlignParams,
                device) -> Optional[torch.device]:
    """The card to build the index on: ``device`` when it is a CUDA device
    whose free memory holds ``card_bytes`` and ``MARGIN`` and the positions
    fit one sort, else None (the host builds)."""
    device = torch.device(device)
    if device.type != "cuda" or n_positions(ref, params) > MAX_POSITIONS:
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return device if card_bytes(ref, params) + MARGIN <= free else None


def build_index_on(ref: PackedReference, params: AlignParams,
                   device) -> Tuple[SeedIndex, str]:
    """The seed index and where it was built: on the card that
    ``build_place`` names, else on the host (``build_index``)."""
    card = build_place(ref, params, device)
    if card is None:
        return build_index(ref, params), "host"
    return device_build(ref, params, card), str(card)


def _runs(ref, params, device):
    """(first stream index, first position) of every run on ``device``,
    chain 0's then chain 1's, each chain's indices from 0; then the number
    of runs and of positions of each chain."""
    firsts, bases, nruns, ns = [], [], [], []
    for c in (0, 1):
        base, n = _chain_runs(ref, params, c)
        firsts.append(np.cumsum(n) - n)
        bases.append(base)
        nruns.append(base.size)
        ns.append(int(n.sum()))
    first = torch.from_numpy(np.concatenate(firsts).astype(np.int64))
    base = torch.from_numpy(np.concatenate(bases).astype(np.int64))
    return first.to(device), base.to(device), nruns, ns


def _seeds_plain(words, first, base, nruns, ns, params):
    """(keys, positions, counts, n1) of the stream with torch ops on any
    device: what ``bt_index_seeds`` computes."""
    nk, I, s = params.total_kmers, params.index_interval, params.seed_size
    keys, vals = [], []
    for c, (a, b) in enumerate(((0, nruns[0]), (nruns[0], sum(nruns)))):
        j = torch.arange(ns[c], dtype=torch.int64, device=words.device)
        run = torch.searchsorted(first[a:b], j, right=True) - 1
        pos = base[a:b][run] + I * (j - first[a:b][run])
        w = pos >> 4
        sh = (pos & 15) << 1
        win = ((u32(words[c][w]) << sh)
               | (u32(words[c][w + 1]) >> (32 - sh))) & 0xFFFFFFFF
        keys.append(xt16_base3(win) // 3 ** (16 - s))
        vals.append(pos)
    counts = torch.bincount(torch.cat(keys), minlength=nk)
    n1 = torch.bincount(keys[0], minlength=nk)
    return (torch.cat(keys), torch.cat(vals), counts.to(torch.int32),
            n1.to(torch.int32))


def _sort_plain(keys, vals, counts, params):
    """(starts, locs) with torch ops: what ``bt_index_sort`` computes."""
    counts = counts.to(torch.int64)
    starts = torch.where(counts > 0, torch.cumsum(counts, 0) - counts, 0)
    vals = vals[torch.sort(keys, stable=True)[1]]
    # u32 positions as the int32 of the same bits
    return starts, (((vals + (1 << 31)) & 0xFFFFFFFF)
                    - (1 << 31)).to(torch.int32)


def _seeds_card(words, first, base, nruns, ns, params):
    """``_seeds_plain`` by ``csrc/index_build.cu``'s ``bt_index_seeds``:
    keys and positions in row 0 of [2, n] int32 buffers, row 1 the sort's
    second buffer."""
    from ..ops import _build
    dev = words.device
    nk, n = params.total_kmers, ns[0] + ns[1]
    keys = torch.empty((2, n), dtype=torch.int32, device=dev)
    vals = torch.empty((2, n), dtype=torch.int32, device=dev)
    counts = torch.empty(nk, dtype=torch.int32, device=dev)
    n1 = torch.empty(nk, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().bt_index_seeds(
            words[0].data_ptr(), words[1].data_ptr(), first.data_ptr(),
            base.data_ptr(), nruns[0], nruns[1], ns[0], n,
            params.index_interval, params.seed_size, keys[0].data_ptr(),
            vals[0].data_ptr(), counts.data_ptr(), n1.data_ptr(), nk,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bt_index_seeds failed: cudaError {err}")
    return keys, vals, counts, n1


def _sort_card(keys, vals, counts, params):
    """``_sort_plain`` by ``csrc/index_build.cu``'s ``bt_index_sort``."""
    from ..ops import _build
    lib = _build.load()
    dev = keys.device
    nk, n = params.total_kmers, keys.shape[1]
    end_bit = (nk - 1).bit_length()
    starts = torch.empty(nk, dtype=torch.int64, device=dev)
    nbytes = lib.bt_index_temp_bytes(n, nk, end_bit)
    if nbytes < 0:
        raise RuntimeError(f"bt_index_temp_bytes({n}, {nk}) failed")
    temp = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        sel = lib.bt_index_sort(
            keys[0].data_ptr(), keys[1].data_ptr(), vals[0].data_ptr(),
            vals[1].data_ptr(), n, end_bit, counts.data_ptr(),
            starts.data_ptr(), nk, temp.data_ptr(), nbytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if sel < 0:
        raise RuntimeError(f"bt_index_sort failed: cudaError {-sel}")
    return starts, vals[sel]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_build(ref: PackedReference, params: AlignParams,
                 device) -> SeedIndex:
    """``build_index``'s tables computed on ``device``: by the CUDA kernels
    on a card, by their plain torch version on the CPU."""
    device = torch.device(device)
    card = device.type == "cuda"
    nk = params.total_kmers
    with trace.span("index.device_build"):
        with trace.span("index.device_build.seeds"):
            words = torch.from_numpy(
                np.ascontiguousarray(ref.ref32).view(np.int32)).to(device)
            runs = _runs(ref, params, device)
            keys, vals, counts, n1 = (_seeds_card if card else _seeds_plain)(
                words, *runs, params)
            del words
            _sync(device)
        with trace.span("index.device_build.sort"):
            starts, locs = (_sort_card if card else _sort_plain)(
                keys, vals, counts, params)
            del keys, vals
            _sync(device)
        with trace.span("index.device_build.copy"):
            host = dict(starts=np.empty(nk, np.int64),
                        counts=np.empty(nk, np.int32),
                        n1=np.empty(nk, np.int32),
                        locs=np.empty(locs.numel(), np.uint32))
            for a in host.values():
                madvise_hugepage(a)
            torch.from_numpy(host["starts"]).copy_(starts)
            torch.from_numpy(host["counts"]).copy_(counts)
            torch.from_numpy(host["n1"]).copy_(n1)
            torch.from_numpy(host["locs"].view(np.int32)).copy_(locs)
            del starts, counts, n1, locs
            if card:
                torch.cuda.empty_cache()
    return SeedIndex(max_kmer_num=_kmer_cutoff_dense(params, host["counts"]),
                     **host)
