"""The measured window: a SAM sink that counts and timestamps each write,
and the arithmetic of ``reads_per_s`` on its writes.

The program writes the SAM header once, then one write per batch, in batch
order (``run_single_end``, also under ``-p N``).  The window opens at the
write that ends the warm-up; the reader gives no more reads once
``seconds`` have passed since then, and the run drains.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Write:
    t: float          # host clock (perf_counter) when the write arrived
    records: int      # SAM records in it


@dataclass
class Sink:
    """A binary file object for ``run_single_end``'s ``out_fh``.

    ``warmup`` batch writes end the warm-up; ``on_open`` is called at that
    write, ``on_write`` at every batch write after it.  ``keep(data, k)``
    may keep a sample of batch write k's records (k counts batch writes
    from 0)."""
    warmup: int
    header: bool = True
    on_open: Optional[Callable[[float], None]] = None
    on_write: Optional[Callable[[int, float], None]] = None
    keep: Optional[Callable[[bytes, int], None]] = None
    writes: List[Write] = field(default_factory=list)
    t_open: Optional[float] = None
    _header_seen: bool = False

    def write(self, data) -> int:
        t = time.perf_counter()
        data = bytes(data)
        if self.header and not self._header_seen:
            self._header_seen = True
            return len(data)
        k = len(self.writes)
        self.writes.append(Write(t, data.count(b"\n")))
        if self.keep is not None:
            self.keep(data, k)
        if k + 1 == self.warmup:
            self.t_open = t
            if self.on_open is not None:
                self.on_open(t)
        elif self.t_open is not None and self.on_write is not None:
            self.on_write(k, t)
        return len(data)


@dataclass
class Reader:
    """Wraps the reader's ``next_batch``: records each batch's size and
    the time it was handed over, and hands over nothing once the window's
    end has passed."""
    seconds: float
    sink: Sink
    batches: List[tuple] = field(default_factory=list)  # (t, n, index0)
    dry: bool = False   # the read pool ran out before the window's end

    def wrap(self, next_batch):
        def wrapped(this, *a, **kw):
            t = time.perf_counter()
            if (self.sink.t_open is not None
                    and t >= self.sink.t_open + self.seconds):
                return []
            batch = next_batch(this, *a, **kw)
            n = len(batch) if batch else 0
            if n:
                self.batches.append((t, n, int(getattr(batch, "index0", 0))))
            elif self.sink.t_open is None or t < self.sink.t_open + self.seconds:
                self.dry = True
            return batch
        return wrapped


@dataclass
class Window:
    t_open: float
    t_last: float      # the last write at or before the window's end
    reads: int         # records written after t_open, up to t_last
    writes: int        # batch writes counted
    first: int         # index of the first counted batch write

    @property
    def seconds(self) -> float:
        return self.t_last - self.t_open

    @property
    def reads_per_s(self) -> float:
        return self.reads / self.seconds


def window(writes: List[Write], warmup: int, seconds: float) -> Window:
    """reads_per_s's window: the batch writes after the warm-up's last,
    up to the last at or before ``seconds`` past it.  Whole batches only,
    so the count does not depend on where the window cut a batch."""
    if len(writes) <= warmup:
        raise RuntimeError(f"{len(writes)} batch writes, the warm-up alone "
                           f"takes {warmup}: give the run more reads")
    t_open = writes[warmup - 1].t
    ts = np.array([w.t for w in writes[warmup:]])
    n = int(np.searchsorted(ts, t_open + seconds, side="right"))
    if n == 0:
        raise RuntimeError(f"no batch write within {seconds} s of the "
                           "window's opening: lengthen the window")
    counted = writes[warmup:warmup + n]
    return Window(t_open, counted[-1].t, sum(w.records for w in counted),
                  n, warmup)
