"""One run of one cell: make the inputs, drive the program's own entry over
a measured window, read the metrics, and decide ``correct``.

The entry the window drives is the configuration's ``entry``,
``benchmark/entries/<entry>.py``: for ``single_end``, ``basal_tpu_torch.
align.pipeline.run_single_end`` with the cell's recipe flags (``-p N`` runs
its ``TorchThreadedRunner``).  The benchmark's wrappers, installed on the
program's classes that the entry names, for the run and removed after it,
record spans and counters, keep a sample of each device wave's inputs and
outputs and of the SAM records, and stop the reader once the window has
passed.  A ``--trace 1`` run also turns on the program's own span recorder
(``basal_tpu_torch.trace``) for the run and keeps its spans on
``Run.program``.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from . import checks, data, manifest, roofline
from .spans import SPANS, Spans, patch, unpatch
from .window import Reader, Sink, Window, window

class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Run:
    """What one run measured; the metric readers read it."""
    cell: manifest.Cell
    seconds: float
    setup_s: float
    rss_gib: float
    timings: dict
    win: Window
    spans: Spans
    counters: dict                 # name -> (at opening, at last write)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    roofline: dict = field(default_factory=dict)  # kernel -> (least, took)
    breakdown: Optional[dict] = None
    program: Optional[list] = None  # traced: the program's own spans

    def delta(self, name: str) -> float:
        a, b = self.counters[name]
        return b - a

    def us_per_read(self, span: str):
        s = self.spans.thread_seconds(span, self.win.t_open, self.win.t_last)
        return None if s is None else s * 1e6 / self.win.reads


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def make_data(root: Path, cell: manifest.Cell, seed: int, n: int) -> dict:
    """The genome and the reads, made in a child process so that their
    arrays stay out of this process's peak and their time out of set-up."""
    spec = dict(cache=str(root / "benchmark" / ".cache"),
                genome=genome_spec(cell.config), mix=cell.mix,
                chem=cell.config["reads"], n=n, seed=seed)
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(data.__file__)), json.dumps(spec)],
        check=True, stdout=subprocess.PIPE, text=True, cwd=root)
    paths = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"data: {n} reads of {cell.mix['source']} traffic, seed {seed}, "
        f"{time.perf_counter() - t:.1f} s (not set-up)")
    return paths


def genome_spec(config: dict) -> dict:
    return dict(config["genome"], length=int(config["genome_bp"]))


def _cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "benchmark" / ".cache" / "kernels"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def _read_ids(enc, row: np.ndarray) -> np.ndarray:
    """Global read numbers of candidate rows (row = 2 * read + chain)."""
    reads = enc.reads
    if hasattr(reads, "index0"):
        return int(reads.index0) + (row >> 1).astype(np.int64)
    return np.array([r.index for r in reads], np.int64)[row >> 1]


class Recorder:
    """The wrappers' state for one run."""

    def __init__(self, seed: int, per_call: int, per_write: int,
                 traced: bool):
        self.seed = seed % (1 << 63)
        self.per_call = per_call
        self.per_write = per_write
        self.traced = traced
        self.open = False
        self.contexts = {}          # id -> TorchDeviceContext
        self.aligners = {}          # id -> aligner
        self.pending = {}           # id(waves) -> sampled candidates
        self.sampled = []           # sampled candidates with outputs
        # traced: (t, loc, plane, row, len, waves, gap) of each call
        self.calls = []
        self.lines = []             # (batch write k, SAM record line)
        self._lock = threading.Lock()

    def counters(self, launches) -> dict:
        """The device contexts' counters and every numeric key of the
        aligners' ``stage`` dicts, each summed over them."""
        ctx = list(self.contexts.values())
        al = list(self.aligners.values())
        out = dict(
            down_bytes=sum(c.down_bytes for c in ctx),
            up_waves=sum(c.up_waves for c in ctx),
            stalls=sum(c.stalls for c in ctx),
            cand_device=sum(a.stage["cand_device"] for a in al),
            cand_host=sum(a.stage["cand_host"] for a in al),
            cand_visit=sum(a.stage["cand_visit"] for a in al),
            launches=launches())
        keys = {k for a in al for k, v in a.stage.items()
                if isinstance(v, (int, float))}
        for k in sorted(keys - set(out)):
            out[k] = sum(a.stage.get(k, 0) for a in al)
        return out

    def extend_async(self, orig):
        rec = self

        def extend_async(self, enc, loc, plane, row):
            rec.contexts[id(self)] = self
            t = time.perf_counter()
            waves = orig(self, enc, loc, plane, row)
            if rec.open and loc.size:
                rec._sample(enc, loc, plane, row, waves)
                if rec.traced:
                    rows = np.asarray(row)
                    with rec._lock:
                        rec.calls.append((t, np.array(loc, np.int32),
                                          np.array(plane, np.uint8),
                                          np.array(rows, np.int32),
                                          np.array(enc.map_len, np.int32),
                                          len(waves), self.params.gap))
            return waves
        return extend_async

    def _sample(self, enc, loc, plane, row, waves) -> None:
        C = loc.size
        rng = np.random.default_rng([self.seed, C, int(loc[0])])
        idx = np.unique(rng.integers(0, C, min(C, self.per_call)))
        row = np.asarray(row)[idx].astype(np.int64)
        self.pending[id(waves)] = dict(
            idx=idx, read=_read_ids(enc, row), chain=row & 1,
            loc=np.asarray(loc)[idx].astype(np.int64),
            plane=np.asarray(plane)[idx].astype(np.int64), keep=waves)

    def fetch(self, orig):
        rec = self

        def fetch(self, waves):
            out = orig(self, waves)
            s = rec.pending.pop(id(waves), None)
            if s is not None:
                del s["keep"]
                s["out"] = [None if a is None else np.array(a[s["idx"]])
                            for a in out]
                with rec._lock:
                    rec.sampled.append(s)
            return out
        return fetch

    def submit_batch(self, orig):
        rec = self

        def submit_batch(self, *a, **kw):
            rec.aligners[id(self)] = self
            return orig(self, *a, **kw)
        return submit_batch

    def keep(self, reader: Reader):
        """Sink callback: a sample of the records of batch writes whose
        batch was handed over inside the window."""
        def keep(data: bytes, k: int) -> None:
            if (not self.open or k >= len(reader.batches)
                    or not data or reader.batches[k][0] < reader.sink.t_open):
                return
            rng = np.random.default_rng([self.seed, k, 1])
            seen = set()
            for off in rng.integers(0, len(data), self.per_write).tolist():
                a = data.rfind(b"\n", 0, off) + 1
                if a in seen:
                    continue
                seen.add(a)
                self.lines.append((k, data[a:data.find(b"\n", a) + 1]))
        return keep


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", sizes: Optional[dict] = None,
             control=None) -> dict:
    """One run of cell ``name``.  A cell's ``batch_reads`` sets the
    program's batch size (BASAL's 50,000 reads without it).  ``sizes``
    overrides configuration keys (``config``), the cell's parameters
    (``cell``) and the program's parameters (``params``), for tests at a
    size a CPU holds;
    ``control(root, cell, paths, seed, params)`` may put something in the
    program's place for the run and returns how to take it out.  Raises
    NoDevice without the cards.  Returns the result line's object."""
    root = Path(root)
    cell = manifest.cell(root, name)
    cfg, prm = cell.config, dict(cell.params)
    if sizes:
        cfg = dict(cfg, **sizes.get("config", {}))
        prm.update(sizes.get("cell", {}))
        cell = manifest.Cell(cell.name, cell.chips, cfg, cell.mix, prm,
                             cell.end_to_end, cell.per_layer)
    paths = make_data(root, cell, seed, int(prm["reads"]))
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)
    os.environ["BASAL_TPU_TORCH_DEVICE"] = device
    _cache_env(root)

    t_setup = time.perf_counter()
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"the cell needs {cell.chips} CUDA card(s); torch "
                       f"finds {torch.cuda.device_count()}")
    from basal_tpu_torch import cli
    from basal_tpu_torch.ops import extend_cuda
    entry = manifest.entry(root, cfg["entry"])

    argv = list(cfg["flags"]) + ["-a", paths["reads"], "-d", paths["fasta"]]
    opts, flags = cli.parse_args(argv)
    params = cli.params_from_args(argv, opts, flags)
    if "batch_reads" in prm:
        params.batch_reads = int(prm["batch_reads"])
    for k, v in (sizes or {}).get("params", {}).items():
        setattr(params, k, v)
    undo_control = (control(root, cell, paths, seed, params)
                    if control is not None else None)

    def launches():
        return (extend_cuda.extend_counts_blob.launches
                + extend_cuda.extend_gap_blob.launches)

    rec = Recorder(seed, int(prm.get("sample_per_wave", 4096)),
                   int(prm.get("sample_per_write", 256)), trace)
    spans = Spans()
    session = None
    if trace:
        from .trace import Session
        session = Session()
        session.start()      # the first session pays CUPTI's start-up
        session.stop()
        session = Session()
    sink = Sink(warmup=int(prm["warmup_writes"]), header=params.sam_header)
    reader = Reader(seconds, sink)
    counters = {}

    def on_open(t):
        rec.open = spans.on = True
        counters["open"] = rec.counters(launches)
        counters["close"] = counters["open"]
        if session is not None:
            session.start()

    def on_write(k, t):
        if t <= sink.t_open + seconds:
            counters["close"] = rec.counters(launches)

    sink.on_open, sink.on_write, sink.keep = on_open, on_write, rec.keep(
        reader)
    classes = entry.classes()
    undo = []
    if trace:
        for sname, (cls, meth) in SPANS.items():
            patch(classes[cls], meth, lambda f, s=sname: spans.wrap(s, f),
                  undo, spans.missing, sname)
    patch(classes["devctx"], "extend_async", rec.extend_async,
          undo, spans.missing, "extend_async")
    patch(classes["devctx"], "fetch", rec.fetch, undo,
          spans.missing, "fetch")
    patch(classes["aligner"], "submit_batch", rec.submit_batch,
          undo, spans.missing, "submit_batch")
    patch(classes["reader"], "next_batch", reader.wrap, undo,
          spans.missing, "next_batch")
    timings = {}
    program = None
    if trace:                 # the program's own span recorder, for the run
        from basal_tpu_torch import trace as recorder
        recorder.enable()
    try:
        entry.run(params, paths["fasta"], paths["reads"], sink, timings,
                  device)
        events = session.stop() if session is not None else None
        if trace:
            program = recorder.snapshot()
    finally:
        if trace:
            recorder.disable()
        unpatch(undo)
        if undo_control is not None:
            undo_control()
    log("batch writes (s after set-up began: records): " + ", ".join(
        f"{w.t - t_setup:.1f}: {w.records}" for w in sink.writes))
    log("timings: " + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()
                                if k != "t_align_start"))
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    if sink.t_open is None:
        raise RuntimeError(f"{len(sink.writes)} batch writes: the warm-up "
                           f"takes {sink.warmup}; give the cell more reads")
    win = window(sink.writes, sink.warmup, seconds)
    run = Run(cell, seconds, sink.t_open - t_setup, rss_gib, timings, win,
              spans, {k: (counters["open"][k], counters["close"][k])
                      for k in counters["open"]}, program=program)
    if events is not None:
        _device_metrics(run, events, rec, cfg["kernel"])
    end = rec.counters(launches)
    log("counters at the end: " + ", ".join(f"{k} {v}"
                                             for k, v in end.items()))

    # the checks of every run
    attempted = failed = 0
    for k, (t, n, _) in enumerate(reader.batches):
        if t >= sink.t_open:
            attempted += n
            got = sink.writes[k].records if k < len(sink.writes) else 0
            failed += max(0, n - got)
    device_checks = {
        "stalls": (end["stalls"], 0),
        "host_or_visit_candidates": (end["cand_host"] + end["cand_visit"],
                                     0),
        "read_pool_ran_dry": (int(reader.dry), 0),
        "reads_without_record": (failed, 0),
    }
    if device == "cuda":
        device_checks["launches_minus_waves"] = (
            abs(end["launches"] - end["up_waves"]), 0)
    if reader.dry:
        log("the read pool ran dry before the window's end: give the cell "
            "more reads")

    # the program's state goes before the reference runs
    del rec.contexts, rec.aligners
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    wrong_k, checked_k, why = compare(paths, cell, params, seed, rec,
                                      reader, device)
    checked_s = sum(why.values())
    log(f"reference: {checked_k} wave outputs and {checked_s} records in "
        f"{time.perf_counter() - t_ref:.1f} s; records by verdict: "
        + ", ".join(f"{k} {v}" for k, v in sorted(why.items())))
    numbers = dict(device_checks)
    numbers["kernel_outputs_wrong"] = (wrong_k, 0)
    numbers.update(record_numbers(why, prm["limits"]))
    correct = (all(v <= lim for v, lim in numbers.values())
               and checked_k > 0 and checked_s > 0)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips if device == "cuda" else 1,
           "memory_peak_bytes": int(mem_peak)}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.breakdown is not None:
        out["breakdown"] = run.breakdown
    checks_out = {k: {"value": v, "limit": lim}
                  for k, (v, lim) in numbers.items()}
    checks_out["kernel_outputs_checked"] = {"value": checked_k, "floor": 1}
    checks_out["sam_records_checked"] = {"value": checked_s, "floor": 1}
    out["checks"] = checks_out
    if spans.missing:
        log(f"wrappers that found no method: {', '.join(spans.missing)}")
    found = checks.forbidden_modules()
    if found:
        raise RuntimeError(f"modules of jax or basal_tpu are loaded: "
                           f"{', '.join(found)}")
    return out


def _device_metrics(run: Run, events, rec: Recorder, kname: str) -> None:
    """Busy and idle time, the roofline share of the configuration's
    kernel ``kname`` and the breakdown, over [opening, last counted
    write]."""
    from .trace import gaps, union
    a, b = run.win.t_open, run.win.t_last
    busy, merged = union([(s, e) for _, s, e in events.events], a, b)
    run.busy_s, run.window_s = busy, b - a
    durs = events.kernels(kname)
    calls = [c for c in rec.calls if a <= c[0] <= b]
    launched = sum(c[5] for c in calls)
    work = roofline.WORK.get(kname)
    if durs and launched and work is not None:
        least = 0.0
        for _, loc, plane, row, map_len, _n, gap in calls:
            nb, ops = work(loc, plane, row, map_len[row >> 1], gap)
            least += roofline.least_seconds(nb, ops)
        took = sum(durs) / len(durs) * launched
        run.roofline[kname] = (least, took)
    idle = sorted(gaps(merged, a, b), key=lambda g: g[0] - g[1])[:10]
    run.breakdown = {
        "device_ops": [[n, s] for n, s in events.by_name(a, b)[:10]],
        "idle_gaps": [[_busiest_span(run.spans, s, e), e - s]
                      for s, e in idle]}


def _busiest_span(spans: Spans, a: float, b: float) -> str:
    """The host span that overlaps [a, b] the most, summed over threads."""
    best, name = 0.0, "no span"
    for sname, items in spans.spans.items():
        cover = sum(max(0.0, min(e, b) - max(s, a)) for _, s, e in items)
        if cover > best:
            best, name = cover, sname
    return name


#: verdicts of ``reference.check_record`` read against the origin, and
#: the number each counts into, as a share of the records checked
ORIGIN = {"unmapped within the limit": "unmapped_within_limit_pct",
          "worse than its origin": "off_origin_pct",
          "not at its origin": "off_origin_pct"}


def record_numbers(why: dict, limits: dict) -> dict:
    """The numbers compared for the sampled SAM records: those wrong
    against themselves (limit 0), and the shares wrong against their
    origin (limits of the cell's ``limits``)."""
    total = max(sum(why.values()), 1)
    wrong = 0
    shares = dict.fromkeys(sorted(set(ORIGIN.values())), 0)
    for verdict, n in why.items():
        if verdict in ORIGIN:
            shares[ORIGIN[verdict]] += n
        elif verdict != "right":
            wrong += n
    nums = {"sam_records_wrong": (wrong, 0)}
    for k, n in shares.items():
        nums[k] = (100.0 * n / total, float(limits[k]))
    return nums


def _named_read(line: bytes) -> Optional[int]:
    """The read number in a SAM record's name ``r<number>``, or None."""
    name = line.split(b"\t", 1)[0]
    return int(name[1:]) if name[:1] == b"r" and name[1:].isdigit() else None


def compare(paths, cell, params, seed, rec: Recorder, reader: Reader,
            device: str):
    """(wrong, checked) of the sampled wave outputs against the plain
    reference, every output of a gapped wave (counts and both position
    lists) entry by entry, and the sampled SAM records counted by verdict.
    The reads are made again only in the blocks that the samples name."""
    import torch

    from . import reference as ref
    refd = data.load_ref(Path(paths["ref_dir"]))
    n_pool = int(cell.params["reads"])
    named = [s["read"] for s in rec.sampled] + [np.array(
        [i for i in map(_named_read, (ln for _, ln in rec.lines))
         if i is not None and 0 <= i < n_pool], np.int64)]
    chunks = set((np.unique(np.concatenate(named)) // data.CHUNK).tolist())
    rd = data.make_reads(refd, cell.mix, cell.config["reads"], n_pool, seed,
                         chunks=chunks)
    reads, lens, spans = rd.chars, rd.lens, rd.span
    rule = ref.Rule(params.conversion, nt3=params.nt3)
    genome = ref.Genome(refd.chars, refd.seqs, torch.device(device))
    wrong_k = checked_k = 0
    block = 1 << 16
    for s in rec.sampled:
        for a in range(0, s["idx"].size, block):
            sl = slice(a, a + block)
            r = s["read"][sl]
            args = (rule, genome, torch.from_numpy(s["loc"][sl]),
                    torch.from_numpy(s["plane"][sl]),
                    torch.from_numpy(ref.chains(reads[r], lens[r],
                                                s["chain"][sl])),
                    torch.from_numpy(lens[r]))
            got = (ref.extend_gap(*args, params.gap, n_mis=params.n_mis)
                   if params.gap else
                   (ref.extend(*args, n_mis=params.n_mis),))
            for want, out in zip(got, s["out"]):
                ok = want.cpu().numpy() == out[sl]
                wrong_k += int((~ok).sum())
                checked_k += int(ok.size)
    L = reads.shape[1]
    limit = ref.mismatch_limit(params.max_snp_num, L)
    seg = refd.unique

    def origin(i: int) -> ref.Origin:
        x, span = int(rd.start[i]), int(spans[i])
        k = int(np.searchsorted(seg[:, 0], x, side="right")) - 1
        unique = k >= 0 and x + span <= seg[k, 1]
        pieces = (0,)
        if rd.dels is not None:          # deleted bases in forward order
            gone = [int(v) for d, v in rd.dels[i] if d >= 0]
            pieces = tuple(np.cumsum([0] + (gone[::-1] if rd.minus[i]
                                             else gone)).tolist())
        return ref.Origin(x, bool(rd.minus[i]), bool(unique), span, pieces)

    why = {}
    shown = 0
    for k, line in rec.lines:
        _, n, index0 = reader.batches[k]
        v = ref.check_record(line, rule, refd, reads, origin, limit,
                             params.out_ref, params.n_mis, params.gap,
                             params.gap_edge,
                             (params.seed_size, params.index_interval))
        if v is None:
            i = int(line.split(b"\t", 1)[0][1:])
            if not index0 <= i < index0 + n:
                v = "record of another batch"
        if v is not None and shown < 5:
            shown += 1
            log(f"record wrong ({v}): {line[:200]!r}")
        v = v or "right"
        v = "NM" if v.startswith("NM ") else v.split(" (", 1)[0]
        why[v] = why.get(v, 0) + 1
    return wrong_k, checked_k, why
