"""Spans and counters taken from the benchmark's own files: wrappers around
the calls into each layer of the program, installed on its classes for one
run.  Nothing in the program changes.

A span is (name, thread id, start, end) on the host's perf_counter clock.
Under ``-p N`` the spans of N aligners overlap, so readers sum thread time.
A wrapper whose method is gone is reported in ``missing`` and its metric
reads nothing.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Spans:
    on: bool = False                      # record only inside the window
    spans: Dict[str, List[Tuple[int, float, float]]] = field(
        default_factory=lambda: defaultdict(list))
    missing: List[str] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def wrap(self, name: str, fn):
        spans = self

        def wrapped(*a, **kw):
            if not spans.on:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                with spans._lock:
                    spans.spans[name].append((threading.get_ident(), t0, t1))
        return wrapped

    def thread_seconds(self, name: str, t0: float, t1: float):
        """Summed seconds of the ``name`` spans that start in [t0, t1], or
        None where that span was never installed."""
        if name in self.missing:
            return None
        return sum(b - a for _, a, b in self.spans.get(name, ())
                   if t0 <= a <= t1)


def patch(obj, attr: str, make, undo: list, missing: list, name: str):
    """Replace ``obj.attr`` by ``make(original)``; remember how to undo."""
    if not hasattr(obj, attr):
        missing.append(name)
        return
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    undo.append((obj, attr, orig))


def unpatch(undo: list) -> None:
    for obj, attr, orig in reversed(undo):
        setattr(obj, attr, orig)
    undo.clear()


#: span name -> (role, method): the program's class of each role is the
#: entry's (``benchmark/entries/<entry>.py``, ``classes()``)
SPANS = {
    "reader.next_batch": ("reader", "next_batch"),
    "aligner.submit_batch": ("aligner", "submit_batch"),
    "aligner.finish_batch": ("aligner", "finish_batch"),
    "sam.emit": ("aligner", "_emit_native"),
    "devctx.extend_async": ("devctx", "extend_async"),
    "devctx.fetch": ("devctx", "fetch"),
}
