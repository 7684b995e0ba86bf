"""Spans of the port's own host work, on the clock of its device trace.

A span is one stretch of work on one thread: its name, the batch it belongs
to (the batch's first read number, ``index0``, shared by every span of that
batch), its parent (the span open around it on the same thread), the
OS thread (``threading.get_native_id()``, as a profiler's CPU rows),
its start and end on ``time.perf_counter()`` and ``time.thread_time()`` at
both ends (the thread's CPU seconds).  A span's self time is its wall time
less what its children cover.

The recorder is off by default.  Off, ``span()`` is one flag test that
returns a shared object doing nothing: it reads no clock and allocates
nothing.  ``enable()`` starts a fresh recording, ``disable()`` stops it,
and ``snapshot()`` hands out the records, which stay in memory until then;
``BASAL_TPU_PROFILE=<dir>`` turns the recorder on for a run and writes its
spans into the run's Chrome trace (``add_to_chrome_trace``).  Counters are
the aligners' ``stage`` dicts, not kept here.

    with trace.span("aligner.submit", of=reads):   # of: a batch, or its
        ...                                        # encoding, or index0
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
import warnings
from typing import List, NamedTuple, Optional

#: name of the profiler event that ties perf_counter to the profiler's clock
MARK = "basal_tpu_torch.trace_open"


class Span(NamedTuple):
    name: str
    batch: Optional[int]        # index0 of the batch, None outside one
    id: int
    parent: Optional[int]       # id of the enclosing span on the thread
    thread: int                 # threading.get_native_id()
    t0: float                   # time.perf_counter()
    t1: float
    c0: Optional[float]         # time.thread_time(); None for a span
    c1: Optional[float]         # recorded across threads or still open
    open: bool = False          # still running when the snapshot was taken


_on = False
_records: List[Span] = []       # list.append is atomic under the GIL
_ids = itertools.count(1)
_stacks: dict = {}              # thread id -> its open spans, innermost last


class _Off:
    """The shared span of a recorder that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def batch_of(of) -> Optional[int]:
    """The batch id of a read batch (its ``index0``, or its first read's
    index), of an encoded batch (its ``reads``), or an int itself."""
    if of is None or isinstance(of, int):
        return of
    of = getattr(of, "reads", of)
    i0 = getattr(of, "index0", None)
    if i0 is not None:
        return int(i0)
    try:
        return int(of[0].index)
    except (IndexError, TypeError, AttributeError):
        return None


class _Open:
    """A span being timed; recorded when it ends if the recorder is on."""
    __slots__ = ("name", "of", "batch", "id", "parent", "thread", "t0", "c0")

    def __init__(self, name: str, of=None):
        self.name = name
        self.of = of

    def __enter__(self):
        tid = threading.get_native_id()
        stack = _stacks.setdefault(tid, [])
        up = stack[-1] if stack else None
        self.batch = (batch_of(self.of) if self.of is not None
                      else up.batch if up is not None else None)
        self.parent = up.id if up is not None else None
        self.id = next(_ids)
        self.thread = tid
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        stack.append(self)      # whole before snapshot() can see it
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        c1 = time.thread_time()
        _stacks[self.thread].pop()
        if _on:
            _records.append(Span(self.name, self.batch, self.id, self.parent,
                                 self.thread, self.t0, t1, self.c0, c1))
        return False


def span(name: str, of=None):
    """A span around the block when the recorder is on, else ``OFF``.
    ``of`` names the batch; without it the span takes its parent's."""
    if not _on:
        return OFF
    return _Open(name, of)


def now() -> Optional[float]:
    """perf_counter() when the recorder is on, else None."""
    return time.perf_counter() if _on else None


def record(name: str, t0: Optional[float], t1: float, of=None) -> None:
    """Record a span that began on another thread at ``t0`` (``now()``
    there) and ends at ``t1`` on this one; it has no parent and no CPU
    time.  Nothing happens when ``t0`` is None or the recorder is off."""
    if t0 is None or not _on:
        return
    _records.append(Span(name, batch_of(of), next(_ids), None,
                         threading.get_native_id(), t0, t1, None, None))


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start a fresh recording: earlier records are dropped."""
    global _on
    _records.clear()
    _on = True


def disable() -> None:
    global _on
    _on = False


def snapshot() -> List[Span]:
    """The spans recorded since ``enable()``, then those still open on any
    thread (``open`` set, ending now)."""
    out = list(_records)
    t = time.perf_counter()
    for stack in list(_stacks.values()):
        for s in list(stack):
            out.append(Span(s.name, s.batch, s.id, s.parent, s.thread, s.t0,
                            t, None, None, True))
    return out


def _event(s: Span, pid, base: float) -> dict:
    args = {"batch": s.batch, "id": s.id, "parent": s.parent}
    if s.c0 is not None and s.c1 is not None:
        args["cpu_us"] = round((s.c1 - s.c0) * 1e6, 3)
    return {"ph": "X", "cat": "basal_tpu_torch", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": round(base + s.t0 * 1e6, 3),
            "dur": round((s.t1 - s.t0) * 1e6, 3), "args": args}


_EVENTS = re.compile(r'"traceEvents":\s*\[')
_CHUNK = 1 << 20


def _field(text: str, key: str) -> Optional[str]:
    m = re.search(r'"%s":\s*("[^"]*"|[-0-9.eE+]+)' % key, text)
    return m.group(1) if m else None


def _mark_in(text: str):
    """(pid, end in the trace's microseconds) of the host event of MARK
    in ``text``, a piece of a Chrome trace, or None."""
    name = json.dumps(MARK)
    i = text.find(name)
    while i >= 0:
        a = text.rfind("{", 0, i)
        ends = [j for j in (text.find("{", i), text.find("}", i)) if j >= 0]
        if a < 0 or not ends:
            return None         # cut at the piece's end; the next has it
        e = text[a:min(ends)]   # the event up to its "args"
        cat, ts, dur = (_field(e, k) for k in ("cat", "ts", "dur"))
        if (_field(e, "name") == name and ts is not None and dur is not None
                and not (cat or "").startswith('"gpu')):
            pid = _field(e, "pid")
            return json.loads(pid) if pid else 0, float(ts) + float(dur)
        i = text.find(name, i + 1)
    return None


def _scan(path: str):
    """(offset just past ``"traceEvents": [``, MARK's pid and end), read
    in pieces; None for what is missing."""
    at = mark = None
    done = 0                    # characters before ``buf``
    buf = ""
    with open(path, encoding="utf-8") as f:
        while at is None or mark is None:
            piece = f.read(_CHUNK)
            if not piece:
                break
            buf += piece
            if at is None:
                m = _EVENTS.search(buf)
                if m:
                    at = done + m.end()
            if mark is None:
                mark = _mark_in(buf)
            keep = min(len(buf), 1 << 14)     # an event header spans less
            done += len(buf) - keep
            buf = buf[len(buf) - keep:]
    return at, mark


def add_to_chrome_trace(path: str, spans: List[Span], t_mark: float) -> str:
    """Write ``spans`` into the Chrome trace at ``path`` on the profiler's
    timeline and return the path written.  ``t_mark`` is the perf_counter
    reading taken last inside the profiler's ``MARK`` event, whose end
    gives the offset (its start can lie milliseconds earlier, before the
    profiler's first event is set up).  The trace is copied in pieces with
    the spans put first in its ``traceEvents``, never read whole.  When it
    holds no ``MARK`` event the spans go, on perf_counter's clock, to
    ``<path less .json>.spans.json`` instead, with a warning."""
    at, mark = _scan(path)
    if at is None or mark is None:
        alone = path[:-5] if path.endswith(".json") else path
        alone += ".spans.json"
        warnings.warn(f"{path}: no {MARK} event to put the program's spans "
                      f"on the profiler's clock; they are in {alone}")
        with open(alone, "w") as f:
            json.dump({"traceEvents": [_event(s, os.getpid(), 0.0)
                                       for s in spans]}, f)
        return alone
    pid, end = mark
    base = end - t_mark * 1e6
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(path, encoding="utf-8") as src, \
            open(tmp, "w", encoding="utf-8") as dst:
        dst.write(src.read(at))
        for s in spans:
            dst.write("\n" + json.dumps(_event(s, pid, base)) + ",")
        shutil.copyfileobj(src, dst, _CHUNK)
    os.replace(tmp, path)
    return path
