"""reads_per_s's window on a fake sink."""

import pytest

from benchkit.window import Reader, Sink, Write, window


def test_window_counts_whole_batches():
    ws = [Write(t, 100) for t in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)]
    w = window(ws, warmup=2, seconds=3.5)     # opens at 2.0, ends by 5.5
    assert (w.t_open, w.t_last, w.reads, w.writes) == (2.0, 5.0, 300, 3)
    assert w.reads_per_s == 100.0


def test_window_needs_a_write_after_the_warmup():
    with pytest.raises(RuntimeError):
        window([Write(1.0, 5)], warmup=1, seconds=1.0)
    with pytest.raises(RuntimeError):
        window([Write(1.0, 5), Write(9.0, 5)], warmup=1, seconds=1.0)


def test_sink_skips_the_header_and_opens():
    opened = []
    s = Sink(warmup=2, on_open=opened.append)
    s.write(b"@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:9\n")
    s.write(b"r1\t4\n" * 3)
    assert s.t_open is None
    s.write(b"r2\t4\n" * 2)
    assert opened == [s.t_open] and [w.records for w in s.writes] == [3, 2]


def test_reader_stops_after_the_window():
    s = Sink(warmup=1, header=False)
    r = Reader(seconds=0.0, sink=s)

    class Batch(list):
        index0 = 0

    nb = r.wrap(lambda this: Batch([1, 2]))
    assert len(nb(None)) == 2 and not r.dry
    s.write(b"x\n")                            # the window opens
    assert nb(None) == [] and not r.dry
    dry = Reader(seconds=10.0, sink=Sink(warmup=1))
    assert dry.wrap(lambda this: [])(None) == [] and dry.dry
