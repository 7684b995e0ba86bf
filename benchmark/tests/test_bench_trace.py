"""The device's busy time: the union of intervals over streams."""

from benchkit.trace import DeviceEvents, gaps, union


def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 1.5),       # two streams overlap
          (2.0, 3.0), (2.2, 2.4),       # one inside another
          (4.0, 5.0)]
    busy, merged = union(iv, 0.0, 10.0)
    assert busy == 1.5 + 1.0 + 1.0
    assert merged == [(0.0, 1.5), (2.0, 3.0), (4.0, 5.0)]
    assert busy <= 10.0


def test_union_clips_to_window():
    busy, merged = union([(-1.0, 1.0), (9.5, 12.0)], 0.0, 10.0)
    assert busy == 1.5 and merged == [(0.0, 1.0), (9.5, 10.0)]


def test_gaps_between_busy():
    _, merged = union([(1.0, 2.0), (3.0, 4.0)], 0.0, 5.0)
    assert gaps(merged, 0.0, 5.0) == [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]


def test_events_by_name_in_window():
    ev = DeviceEvents([("k", 0.0, 1.0), ("k", 2.0, 3.0), ("copy", 0.5, 4.5)])
    assert ev.kernels("k") == [1.0, 1.0]
    assert ev.by_name(0.5, 2.5) == [("copy", 2.0), ("k", 1.0)]
