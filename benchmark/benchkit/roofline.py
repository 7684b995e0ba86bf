"""The least time a wave of candidate extensions allows on an H100, counted
from the work as the algorithm defines it, whatever implements it.

Inputs are the arrays the host aligner hands to the device context,
``extend_async(enc, loc, plane, row)``: each candidate's alignment start on
a reference strand plane and its read row, and each row's read length.

Bytes:
- each candidate's location, 4 B;
- each distinct read row's 2-bit packed bases once, 4 B per 16 bases;
- each distinct reference word (16 bases, 4 B) that the bases the
  candidates compare touch, once: [loc, loc + L);
- the output at the width of the original kernel (``basal_tpu``'s
  ``_counts_core``): a u8 count.

Operations: ``OPS_PER_WORD`` per 16-base word of each alignment, frozen
from ``chip_smoke.py:119-123`` at commit 6c33d98 (funnel shift, rule,
masks, lane bits and popcount per word).

The gap kernel (``gap_wave_work``) does the same for 1 + 2 gap alignments
of each candidate (at loc and at loc +- 1 .. gap), reads the reference over
[loc - gap, loc + L + gap), and writes the outputs of ``basal_tpu``'s
``_gap_core``: a u8 count, 14 i16 positions of the alignment at loc and 14
of each shifted one.

Peaks: an H100 SXM's published HBM rate and 32-bit lane rate at 700 W.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
OPS_PER_WORD = 16
WORD = 16        # bases per 32-bit word


def distinct_words(loc, plane, length) -> int:
    """Reference words covered by the union of the candidates' windows."""
    loc = np.asarray(loc, np.int64)
    if loc.size == 0:
        return 0
    first = loc >> 4
    last = (loc + np.asarray(length, np.int64) - 1) >> 4
    off = np.asarray(plane, np.int64) << 40          # planes never meet
    s = first + off
    e = last + 1 + off
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run = np.maximum.accumulate(e)
    prev = np.concatenate([[np.iinfo(np.int64).min], run[:-1]])
    return int(np.maximum(0, run - np.maximum(s, prev)).sum())


def wave_work(loc, plane, row, row_len):
    """(bytes, operations) of one call of the count kernel.  ``row_len``
    is the read length of each candidate's row."""
    loc = np.asarray(loc)
    C = loc.size
    if C == 0:
        return 0, 0
    row = np.asarray(row)
    row_len = np.asarray(row_len, np.int64)
    words = -(-row_len // WORD)
    # rows are the candidates' read rows; each distinct row once
    _, first = np.unique(row, return_index=True)
    nbytes = 4 * C + 4 * int(words[first].sum())
    nbytes += 4 * distinct_words(loc, plane, row_len)
    nbytes += C
    ops = int(words.sum()) * OPS_PER_WORD
    return nbytes, ops


POS_BYTES = 2 * 14     # K_POS int16 positions of one alignment


def gap_wave_work(loc, plane, row, row_len, gap: int):
    """(bytes, operations) of one call of the gap kernel with ``gap``: the
    count kernel's bytes with each candidate's reference words over [loc -
    gap, loc + L + gap), its outputs at their original widths (1 B + 2 x
    14 B + 2 gap x 2 x 14 B per candidate), and OPS_PER_WORD per word of
    each of the 1 + 2 gap alignments.  Choosing the first 14 mismatch
    positions of each alignment is left out of the operations, so the time
    this allows is a lower bound."""
    loc = np.asarray(loc, np.int64)
    C = loc.size
    if C == 0:
        return 0, 0
    row = np.asarray(row)
    row_len = np.asarray(row_len, np.int64)
    words = -(-row_len // WORD)
    _, first = np.unique(row, return_index=True)
    nbytes = 4 * C + 4 * int(words[first].sum())
    nbytes += 4 * distinct_words(loc - gap, plane, row_len + 2 * gap)
    nbytes += C * (1 + POS_BYTES + 2 * gap * POS_BYTES)
    ops = (1 + 2 * gap) * int(words.sum()) * OPS_PER_WORD
    return nbytes, ops


def _count_work(loc, plane, row, row_len, gap: int):
    return wave_work(loc, plane, row, row_len)


#: a configuration's ``kernel`` -> its work, (loc, plane, row, row_len,
#: gap) -> (bytes, operations)
WORK = {"count_blob_kernel": _count_work, "gap_blob_kernel": gap_wave_work}


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S)
