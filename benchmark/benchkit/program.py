"""The arithmetic of the program's own spans (``basal_tpu_torch.trace``)
over a run's window: self time, thread CPU, union, and the numbers built
from them.

A run's ``program`` is the recorder's snapshot, a list of spans with
``name``, ``batch`` (the batch's first read number), ``id``, ``parent``,
``thread``, ``t0``/``t1`` (perf_counter, the window's clock) and
``c0``/``c1`` (thread CPU seconds, None for a span recorded across
threads or still open).  Every function reads None when the run has no
snapshot (``program`` missing or None) or no span of the kind asked for.

As the benchmark's own spans do, a per-read figure sums thread time over
the aligners and counts the spans that start inside [t_open, t_last].
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

#: the spans that run on one thread alone, with no native pool under them:
#: their wall time less their CPU time is time lost to the interpreter
#: lock or the scheduler (``aligner.encode`` runs C++ on several threads)
SINGLE = ("aligner.dedup", "aligner.ladder", "devctx.blob", "sam.python")
PARENTS = ("aligner.submit", "aligner.finish")


def union(intervals) -> float:
    """Seconds covered by ``intervals``, overlaps counted once."""
    tot, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                tot += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        tot += cur[1] - cur[0]
    return tot


class Program:
    """The spans of one run, indexed, with its window."""

    def __init__(self, spans, t_open: float, t_last: float, reads: int):
        self.spans = list(spans)
        self.a, self.b, self.reads = t_open, t_last, reads
        self.kids: Dict[int, list] = defaultdict(list)
        for s in self.spans:
            if s.parent is not None:
                self.kids[s.parent].append(s)

    def named(self, *names) -> list:
        return [s for s in self.spans if s.name in names]

    def in_window(self, *names) -> list:
        return [s for s in self.named(*names) if self.a <= s.t0 <= self.b]

    def self_wall(self, s) -> float:
        return (s.t1 - s.t0) - union(
            (max(k.t0, s.t0), min(k.t1, s.t1)) for k in self.kids[s.id]
            if k.t1 > s.t0 and k.t0 < s.t1)

    def self_cpu(self, s) -> Optional[float]:
        if s.c0 is None or s.c1 is None:
            return None
        return (s.c1 - s.c0) - sum(k.c1 - k.c0 for k in self.kids[s.id]
                                   if k.c0 is not None and k.c1 is not None)

    def us_per_read(self, name: str, own: bool = True) -> Optional[float]:
        """Thread-µs per read of the ``name`` spans in the window: their
        self time, or their wall time with ``own`` False."""
        ss = self.in_window(name)
        if not ss or not self.reads:
            return None
        f = self.self_wall if own else (lambda s: s.t1 - s.t0)
        return sum(f(s) for s in ss) * 1e6 / self.reads

    def offcpu_pct(self, names=SINGLE) -> Optional[float]:
        """100 x (1 - CPU / wall) of the self time of ``names`` in the
        window."""
        ss = [s for s in self.in_window(*names)
              if self.self_cpu(s) is not None]
        wall = sum(self.self_wall(s) for s in ss)
        if not wall:
            return None
        return 100.0 * (1.0 - sum(self.self_cpu(s) for s in ss) / wall)

    def batch_sizes(self) -> Dict[int, int]:
        """Reads of each batch but the last, from consecutive batch ids."""
        ids = sorted({s.batch for s in self.named("aligner.submit")
                      if s.batch is not None})
        return {x: y - x for x, y in zip(ids, ids[1:])}

    def waves_per_batch(self) -> Optional[float]:
        """Device launches per batch whose ``aligner.submit`` starts in
        the window (each wave is one ``devctx.launch``)."""
        batches = {s.batch for s in self.in_window("aligner.submit")}
        if not batches:
            return None
        n = sum(1 for s in self.named("devctx.launch") if s.batch in batches)
        return n / len(batches)

    def python_reads_pct(self) -> Optional[float]:
        """Share of the reads in the window's batches of known size that
        the Python emitter wrote, against the native formatter."""
        size = self.batch_sizes()
        n = {k: sum(size.get(s.batch, 0) for s in self.in_window(k))
             for k in ("sam.python", "sam.native")}
        tot = n["sam.python"] + n["sam.native"]
        return 100.0 * n["sam.python"] / tot if tot else None

    def queue_ms(self) -> Optional[float]:
        """Mean ``runner.queue`` span in the window, ms per batch."""
        q = self.in_window("runner.queue")
        return sum(s.t1 - s.t0 for s in q) / len(q) * 1e3 if q else None

    def window_seconds(self, name: str) -> Optional[float]:
        """Thread-seconds of the ``name`` spans inside the window."""
        ss = self.named(name)
        if not ss:
            return None
        return sum(max(0.0, min(s.t1, self.b) - max(s.t0, self.a))
                   for s in ss)

    def warmup_s(self) -> Optional[float]:
        """From the end of the index build to the window's opening."""
        ib = self.named("index.build")
        return self.a - max(s.t1 for s in ib) if ib else None

    def device_setup_s(self) -> Optional[float]:
        """Wall time of the device contexts' creation and the kernel
        library's load, overlaps counted once."""
        ss = self.named("devctx.init", "kernels.load")
        return union((s.t0, s.t1) for s in ss) if ss else None

    def self_share(self, name: str, cpu: bool = False) -> Optional[float]:
        """The part of the ``name`` spans' time in the window that no child
        covers: wall, or with ``cpu`` thread CPU."""
        ss = self.in_window(name)
        if cpu:
            ss = [s for s in ss if s.c0 is not None]
            tot = sum(s.c1 - s.c0 for s in ss)
            return (sum(self.self_cpu(s) for s in ss) / tot) if tot else None
        tot = sum(s.t1 - s.t0 for s in ss)
        return sum(self.self_wall(s) for s in ss) / tot if tot else None

    def slots(self) -> List[dict]:
        """Per aligner thread: batches, the sizes it got, and the share of
        the window its submit and finish spans cover."""
        size = self.batch_sizes()
        by_thread = defaultdict(list)
        for s in self.named(*PARENTS):
            by_thread[s.thread].append(s)
        out = []
        for tid, ss in sorted(by_thread.items(),
                              key=lambda kv: min(s.t0 for s in kv[1])):
            batches = sorted({s.batch for s in ss
                              if s.name == "aligner.submit"})
            busy = union((max(s.t0, self.a), min(s.t1, self.b)) for s in ss
                         if s.t1 > self.a and s.t0 < self.b)
            cpu = sum(s.c1 - s.c0 for s in ss if s.c0 is not None
                      and self.a <= s.t0 <= self.b)
            span = self.b - self.a
            out.append(dict(
                thread=tid, batches=len(batches),
                sizes=Counter(size.get(x) for x in batches).most_common(3),
                busy_pct=100.0 * busy / span if span else None,
                cpu_pct=100.0 * cpu / span if span else None))
        return out

    def collapses(self) -> List[dict]:
        """Each ``index.thp_collapse``: its start after the window's
        opening, its length, whether it was still open, and how many
        batches had been submitted before it began."""
        subs = sorted(s.t0 for s in self.named("aligner.submit"))
        return [dict(start_s=s.t0 - self.a, seconds=s.t1 - s.t0,
                     open=bool(getattr(s, "open", False)),
                     after_batches=sum(1 for t in subs if t < s.t0))
                for s in self.named("index.thp_collapse")]

    def leaves_over(self, intervals, top: int = 4):
        """For each interval, the leaf spans (work on a thread without
        children: not ``runner.queue``, a batch's wait) that cover it
        most, with the seconds each covers, summed over threads."""
        leaves = [s for s in self.spans
                  if not self.kids[s.id] and s.c0 is not None]
        out = []
        for g0, g1 in intervals:
            cov = Counter()
            for s in leaves:
                o = min(s.t1, g1) - max(s.t0, g0)
                if o > 0:
                    cov[s.name] += o
            out.append((g1 - g0, cov.most_common(top)))
        return out

    def uncovered(self, name: str, top: int = 6) -> List[Tuple[str, float]]:
        """Where inside the ``name`` spans in the window no child runs,
        by the children on either side ("start", "end" at the ends), in
        thread-µs per read."""
        g = Counter()
        for s in self.in_window(name):
            t, prev = s.t0, "start"
            for k in sorted(self.kids[s.id], key=lambda k: k.t0):
                g[f"{prev}->{k.name}"] += max(0.0, k.t0 - t)
                t, prev = max(t, k.t1), k.name
            g[f"{prev}->end"] += max(0.0, s.t1 - t)
        return [(k, v * 1e6 / self.reads) for k, v in g.most_common(top)]

    def table(self) -> Dict[str, dict]:
        """Per span name: count in the window, wall and self µs per read,
        self CPU µs per read and the off-CPU share of the self time."""
        out = {}
        for name in sorted({s.name for s in self.spans}):
            ss = self.in_window(name)
            cpus = [self.self_cpu(s) for s in ss]
            wall = sum(self.self_wall(s) for s in ss)
            cpu = sum(c for c in cpus if c is not None)
            known = ss and all(c is not None for c in cpus)
            out[name] = dict(
                n=len(ss),
                wall_us_per_read=self.us_per_read(name, own=False),
                self_us_per_read=self.us_per_read(name),
                self_cpu_us_per_read=(cpu * 1e6 / self.reads
                                      if known else None),
                offcpu_pct=(100.0 * (1.0 - cpu / wall)
                            if known and wall else None))
        return out


def of(run) -> Optional[Program]:
    """The run's spans over its window, or None without a snapshot."""
    spans = getattr(run, "program", None)
    if spans is None:
        return None
    return Program(spans, run.win.t_open, run.win.t_last, run.win.reads)


#: per-layer metric -> how it reads a Program (the readers of a benchmark
#: that stores the snapshot on ``Run.program``)
METRICS = {
    "aligner.encode_us_per_read": lambda p: p.us_per_read("aligner.encode"),
    "aligner.groups_us_per_read": lambda p: p.us_per_read("aligner.groups"),
    "aligner.fill_us_per_read": lambda p: p.us_per_read("aligner.fill"),
    "aligner.dedup_us_per_read": lambda p: p.us_per_read("aligner.dedup"),
    "aligner.replay_us_per_read": lambda p: p.us_per_read("aligner.replay"),
    "aligner.ladder_self_us_per_read":
        lambda p: p.us_per_read("aligner.ladder"),
    "aligner.waves_per_batch": Program.waves_per_batch,
    "aligner.offcpu_pct": Program.offcpu_pct,
    "sam.python_reads_pct": Program.python_reads_pct,
    "devctx.blob_us_per_read": lambda p: p.us_per_read("devctx.blob"),
    "devctx.pinned_us_per_read": lambda p: p.us_per_read("devctx.pinned"),
    "devctx.wait_us_per_read": lambda p: p.us_per_read("devctx.wait"),
    "runner.queue_ms": Program.queue_ms,
    "index.thp_window_s": lambda p: p.window_seconds("index.thp_collapse"),
    "setup.warmup_s": Program.warmup_s,
    "setup.device_s": Program.device_setup_s,
}


def metric(run, name: str) -> Optional[float]:
    """Per-layer metric ``name`` of ``METRICS`` for the run."""
    p = of(run)
    return None if p is None else METRICS[name](p)


def report(run, idle=None) -> dict:
    """Everything above for one run, as PERF.md's breakdown gives it;
    ``idle`` is the device's idle gaps, (start, end) on the same clock."""
    p = of(run)
    if p is None:
        return {}
    out = {"metrics": {k: f(p) for k, f in METRICS.items()},
           "spans": p.table(), "slots": p.slots(),
           "collapses": p.collapses()}
    for name in PARENTS:
        out[name] = dict(wall_us_per_read=p.us_per_read(name, own=False),
                         self_share=p.self_share(name),
                         self_cpu_share=p.self_share(name, cpu=True),
                         uncovered=p.uncovered(name))
    if idle:
        longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
        out["idle_gaps_by_leaf"] = p.leaves_over(longest)
    return out
