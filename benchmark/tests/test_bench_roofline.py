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
