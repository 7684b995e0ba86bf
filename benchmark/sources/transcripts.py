"""Reads from transcripts over a genome's unique segments.

``spec['transcripts']`` transcripts, each a run of consecutive unique
segments of ``len_min``-``len_max`` bases, placed by the spec's own seed;
expression Zipf over ranks with exponent ``zipf``.  A read lies inside one
unique segment: the aligner is not a spliced one.  Keys of a mix of this
source: seed, transcripts, len_min, len_max, zipf.
"""

from __future__ import annotations

import numpy as np


def transcript_segments(seg: np.ndarray, spec: dict):
    """(segment index [m], transcript of each [m]), by transcript."""
    rng = np.random.default_rng(spec["seed"])
    t = int(spec["transcripts"])
    want = rng.integers(spec["len_min"], spec["len_max"] + 1, t)
    first = rng.integers(0, len(seg), t)
    slen = seg[:, 1] - seg[:, 0]
    cum = np.concatenate([[0], np.cumsum(slen)])
    # segments first .. last where the run first reaches its length
    last = np.searchsorted(cum, cum[first] + want, side="left")
    last = np.minimum(np.maximum(last, first + 1), len(seg))
    nseg = last - first
    tid = np.repeat(np.arange(t), nseg)
    sidx = np.repeat(first, nseg) + (np.arange(int(nseg.sum()))
                                     - np.repeat(np.cumsum(nseg) - nseg, nseg))
    return sidx, tid


def zipf_weights(mix: dict, t: int, usable: np.ndarray) -> np.ndarray:
    """Expression of t transcripts: Zipf over ranks drawn from the mix's
    seed; a transcript without a usable read start draws nothing."""
    rank = np.random.default_rng([mix["seed"], 1]).permutation(t) + 1
    w = 1.0 / rank.astype(np.float64) ** float(mix["zipf"])
    w[usable == 0] = 0
    return w / w.sum()


def starts(rng, ref, mix: dict, n: int, span: int) -> np.ndarray:
    """Window start of each of n reads in ``ref.chars``: a transcript by
    expression, then a start uniformly over its usable positions."""
    seg = ref.unique
    sidx, tid = transcript_segments(seg, mix)
    su = np.maximum(seg[sidx, 1] - seg[sidx, 0] - span + 1, 0)
    t = int(mix["transcripts"])
    t_usable = np.bincount(tid, weights=su, minlength=t)
    weight = zipf_weights(mix, t, t_usable)
    t_of = rng.choice(t, size=n, p=weight)
    cum = np.cumsum(su)
    t_base = np.concatenate([[0], np.cumsum(t_usable)])[:-1]
    u = t_base[t_of] + np.floor(rng.random(n) * t_usable[t_of])
    s = np.searchsorted(cum, u, side="right")
    return seg[sidx, 0][s] + (u - (cum[s] - su[s])).astype(np.int64)
