"""The roofline's bytes and operations on hand-made waves."""

import numpy as np

from benchkit import roofline as rf


def test_distinct_words_union():
    # windows [16, 116) and [20, 120) on plane 0 share words 1..7;
    # plane 1's same window counts apart
    assert rf.distinct_words([16], [0], [100]) == 7     # words 1..7
    assert rf.distinct_words([16, 20], [0, 0], [100, 100]) == 7
    assert rf.distinct_words([16, 20], [0, 1], [100, 100]) == 14
    assert rf.distinct_words([16, 1000], [0, 0], [100, 100]) == 14
    assert rf.distinct_words([15], [0], [100]) == 8     # words 0..7


def test_count_wave_work():
    loc = np.array([16, 20, 5000])
    plane = np.array([0, 0, 1])
    row = np.array([0, 0, 3])
    lens = np.array([100, 100, 64])
    nbytes, ops = rf.wave_work(loc, plane, row, lens)
    words = 7 + 4                      # rows 0 and 3 once each
    refw = 7 + 5                       # plane 0 words 1..7, plane 1 312..316
    assert nbytes == 4 * 3 + 4 * words + 4 * refw + 3
    assert ops == (7 + 7 + 4) * rf.OPS_PER_WORD


def test_least_seconds_takes_the_larger_bound():
    assert rf.least_seconds(3.35e12, 0) == 1.0
    assert rf.least_seconds(0, 134e12) == 2.0


def test_gap_wave_work():
    loc = np.array([16, 20, 5000])
    plane = np.array([0, 0, 1])
    row = np.array([0, 0, 3])
    lens = np.array([100, 100, 64])
    nbytes, ops = rf.gap_wave_work(loc, plane, row, lens, 3)
    words = 7 + 4                      # rows 0 and 3 once each
    # [loc - 3, loc + L + 3): plane 0 words 0..7, plane 1 312..316
    refw = 8 + 5
    out = 1 + 2 * 14 + 2 * 3 * 2 * 14  # count, pos0, pos1 per candidate
    assert nbytes == 4 * 3 + 4 * words + 4 * refw + 3 * out
    assert ops == (1 + 2 * 3) * (7 + 7 + 4) * rf.OPS_PER_WORD
    assert rf.gap_wave_work([], [], [], [], 3) == (0, 0)


def test_work_by_kernel():
    args = (np.array([16, 20, 5000]), np.array([0, 0, 1]),
            np.array([0, 0, 3]), np.array([100, 100, 64]))
    assert rf.WORK["count_blob_kernel"](*args, 0) == rf.wave_work(*args)
    assert rf.WORK["gap_blob_kernel"](*args, 3) == rf.gap_wave_work(*args,
                                                                     3)
