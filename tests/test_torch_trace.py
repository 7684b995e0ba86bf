"""The port's span recorder (``basal_tpu_torch.trace``).

- Off, ``span()`` is the shared no-op object, reads no clock, and nothing
  is recorded.
- On, a hand-built tree of spans gets its parents, batch ids and self
  times right; thread CPU is at most wall; two threads keep separate
  stacks; a span still open shows in the snapshot.
- The spans go into a Chrome trace at the end of its MARK event, the
  trace read in pieces; without a MARK they go to a file of their own.
- ``run_single_end`` at ``-p 2``, every batch on the strata ladder and
  every wave through the device context, writes the same SAM with the
  recorder on and off, emits each span the CPU path reaches, and its child
  spans cover the work of ``aligner.submit`` and ``aligner.finish``;
  ``stage_report`` (``-V 2``) prints the SAM emitters' read counts.
"""

import collections
import io
import json
import random
import threading
import time
import types

import pytest

from conftest import make_fastq, make_ref

from basal_tpu_torch import trace


@pytest.fixture
def recorder():
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.enable()          # drop the records of the test
        trace.disable()


class FakeClock:
    """perf_counter and thread_time that advance by one per reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t

    def thread_time(self):
        return self.t / 2


def _self(spans):
    """Self time by span id: wall less the children's wall."""
    kids = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += s.t1 - s.t0
    return {s.id: s.t1 - s.t0 - kids[s.id] for s in spans}


def test_off_is_one_shared_object_and_reads_no_clock(monkeypatch):
    trace.enable()              # a fresh recording, then off
    trace.disable()

    def no_clock():
        raise AssertionError("the recorder read a clock while off")
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter=no_clock, thread_time=no_clock))
    assert trace.span("x") is trace.OFF
    assert trace.span("y", of=7) is trace.span("z")
    with trace.span("x") as s:
        assert s is trace.OFF
    assert trace.now() is None
    trace.record("q", None, 1.0)
    trace.record("q", 0.5, 1.0)
    monkeypatch.undo()
    assert trace.snapshot() == []


def test_tree_parent_batch_and_self_time(recorder, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(trace, "time", clock)

    class Batch(list):
        index0 = 500

    with trace.span("root", of=Batch([1])):          # t0 1
        with trace.span("a"):                        # t0 2
            with trace.span("a1"):                   # 3 .. 4
                pass
        # a ends at 5
        with trace.span("b", of=9):                  # 6 .. 7
            pass
    # root ends at 8
    with trace.span("loose"):                        # 9 .. 10
        pass
    monkeypatch.undo()
    spans = {s.name: s for s in trace.snapshot()}
    assert set(spans) == {"root", "a", "a1", "b", "loose"}
    root, a, a1, b = spans["root"], spans["a"], spans["a1"], spans["b"]
    assert root.parent is None and spans["loose"].parent is None
    assert a.parent == root.id and b.parent == root.id and a1.parent == a.id
    assert (root.batch, a.batch, a1.batch, b.batch) == (500, 500, 500, 9)
    assert spans["loose"].batch is None
    assert (root.t0, root.t1, a.t0, a.t1, a1.t0, a1.t1, b.t0, b.t1) == (
        1, 8, 2, 5, 3, 4, 6, 7)
    own = _self(list(spans.values()))
    assert own[root.id] == 7 - 3 - 1 and own[a.id] == 3 - 1
    assert own[a1.id] == 1 and own[b.id] == 1
    assert len({s.thread for s in spans.values()}) == 1
    assert not any(s.open for s in spans.values())


def test_thread_cpu_is_at_most_wall(recorder):
    with trace.span("busy"):
        x = 0
        for i in range(200_000):
            x += i
    with trace.span("sleep"):
        time.sleep(0.05)
    got = {s.name: s for s in trace.snapshot()}
    for s in got.values():
        assert 0 <= s.c1 - s.c0 <= s.t1 - s.t0 + 1e-3
    assert got["sleep"].c1 - got["sleep"].c0 < 0.02
    assert got["sleep"].t1 - got["sleep"].t0 >= 0.05


def test_two_threads_keep_separate_stacks(recorder):
    both = threading.Barrier(2, timeout=10)

    def work(k):
        with trace.span(f"outer{k}", of=k):
            both.wait()                 # both outers are open now
            with trace.span(f"inner{k}"):
                both.wait()             # both inners are open now
    ts = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    got = {s.name: s for s in trace.snapshot()}
    for k in (1, 2):
        outer, inner = got[f"outer{k}"], got[f"inner{k}"]
        assert inner.parent == outer.id and inner.thread == outer.thread
        assert inner.batch == k and outer.parent is None
    assert got["outer1"].thread != got["outer2"].thread


def test_open_span_and_record(recorder):
    with trace.span("t"):
        snap = trace.snapshot()
    (still,) = [s for s in snap if s.name == "t"]
    assert still.open and still.c1 is None and still.t1 >= still.t0
    t0 = trace.now()
    trace.record("q", t0, t0 + 0.5, of=42)
    got = {s.name: s for s in trace.snapshot()}
    assert not got["t"].open
    assert got["q"].batch == 42 and got["q"].parent is None
    assert got["q"].t1 - got["q"].t0 == pytest.approx(0.5)
    assert got["q"].c0 is None
    trace.disable()
    with trace.span("off"):
        pass
    assert "off" not in {s.name for s in trace.snapshot()}


def _chrome_trace(path, gpu_first=True):
    """A Chrome trace laid out as torch.profiler writes it, with a device
    copy of the MARK annotation before the host one."""
    mark = [] if gpu_first is None else [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK,
         "pid": 77, "tid": 78, "ts": 5000.5, "dur": 20.25,
         "args": {"External id": 1}}]
    if gpu_first:
        mark.insert(0, {"ph": "X", "cat": "gpu_user_annotation",
                        "name": trace.MARK, "pid": 0, "tid": 7,
                        "ts": 9000.0, "dur": 1.0, "args": {}})
    events = ([{"ph": "M", "name": "process_name", "pid": 77, "tid": 0,
                "ts": 1.0, "args": {"name": "python"}}]
              + [{"ph": "X", "cat": "cpu_op", "name": f"aten::op{k}",
                  "pid": 77, "tid": 78, "ts": 4000.0 + k, "dur": 0.5,
                  "args": {"Ev Idx": k}} for k in range(40)]
              + mark)
    text = ('{\n  "schemaVersion": 1,\n  "deviceProperties": [],\n'
            '  "traceEvents": [\n'
            + ",\n".join(json.dumps(e, indent=2) for e in events)
            + '\n  ],"traceName": "t" }')
    path.write_text(text)


@pytest.mark.parametrize("chunk", [5, 1 << 20])
def test_chrome_trace_spans_at_the_mark(tmp_path, monkeypatch, chunk):
    monkeypatch.setattr(trace, "_CHUNK", chunk)   # read in tiny pieces too
    path = tmp_path / "t.json"
    _chrome_trace(path)
    before = json.loads(path.read_text())["traceEvents"]
    spans = [trace.Span("aligner.submit", 64, 1, None, 78, 10.0, 10.5,
                        1.0, 1.25),
             trace.Span("runner.queue", 64, 2, None, 79, 9.0, 10.0, None,
                        None)]
    assert trace.add_to_chrome_trace(str(path), spans, 10.25) == str(path)
    doc = json.loads(path.read_text())
    assert doc["traceName"] == "t"
    ev = doc["traceEvents"]
    ours = {e["name"]: e for e in ev if e.get("cat") == "basal_tpu_torch"}
    assert [e for e in ev if e.get("cat") != "basal_tpu_torch"] == before
    base = 5000.5 + 20.25 - 10.25e6       # the host MARK's end at 10.25 s
    sub, q = ours["aligner.submit"], ours["runner.queue"]
    assert sub["ts"] == pytest.approx(base + 10.0e6)
    assert sub["dur"] == pytest.approx(0.5e6)
    assert sub["ts"] + 0.25e6 == pytest.approx(5000.5 + 20.25)
    assert (sub["pid"], sub["tid"], q["tid"]) == (77, 78, 79)
    assert sub["args"] == {"batch": 64, "id": 1, "parent": None,
                           "cpu_us": 250000.0}
    assert "cpu_us" not in q["args"]


def test_chrome_trace_without_mark(tmp_path):
    path = tmp_path / "t.json"
    _chrome_trace(path, gpu_first=None)
    text = path.read_text()
    span = trace.Span("aligner.finish", 0, 3, None, 78, 2.0, 3.0, 0.5, 1.0)
    with pytest.warns(UserWarning, match="no basal_tpu_torch.trace_open"):
        got = trace.add_to_chrome_trace(str(path), [span], 2.5)
    assert got == str(tmp_path / "t.spans.json")
    assert path.read_text() == text               # the trace as it was
    (e,) = json.loads((tmp_path / "t.spans.json").read_text())["traceEvents"]
    assert (e["name"], e["ts"], e["dur"]) == ("aligner.finish", 2.0e6, 1.0e6)


def repeat_genome(rng, n=40, unit=200):
    """Diverged copies of three units: every read has thousands of
    candidates across strata."""
    units = ["".join(rng.choice("ACGT") for _ in range(unit))
             for _ in range(3)]
    parts = []
    for _ in range(n):
        u = list(rng.choice(units))
        for j in range(len(u)):
            if rng.random() < 0.03:
                u[j] = rng.choice("ACGT")
        parts.append("".join(u))
    return "".join(parts)


#: the spans a CPU run reaches: all but kernels.load and devctx.pinned (no
#: card) and index.thp_collapse (after 150,000 reads)
CPU_SPANS = {"aligner.submit", "aligner.finish", "aligner.encode",
             "aligner.groups", "aligner.fill", "aligner.dedup",
             "aligner.replay", "aligner.ladder", "sam.python", "sam.native",
             "devctx.blob", "devctx.launch", "devctx.wait", "devctx.init",
             "runner.queue", "index.reference_load", "index.build"}


def test_run_single_end_spans(tmp_path, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner, stage_report
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.config import AlignParams
    rng = random.Random(4242)
    g = repeat_genome(rng)
    unique = "".join(rng.choice("ACGT") for _ in range(20_000))
    make_ref(tmp_path / "ref.fa", [("chrT", g), ("chrU", unique)])
    # nine batches of 64 from the repeats, with substitutions: each takes
    # several ladder waves and the Python emitter; one last batch of exact
    # reads from the unique chromosome: one wave and the native formatter
    reads = []
    for k in range(640):
        src, sub = (g, 0.04) if k < 576 else (unique, 0.0)
        pos = rng.randrange(0, len(src) - 80)
        s = list(src[pos:pos + 80])
        for j, c in enumerate(s):
            if c == "A" and rng.random() < 0.5:
                s[j] = "G"
            elif rng.random() < sub:
                s[j] = rng.choice("ACGT".replace(c, ""))
        reads.append((f"t{k}", "".join(s)))
    make_fastq(tmp_path / "reads.fq", reads)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    monkeypatch.setattr(SingleEndAligner, "EAGER_MAX_CANDS", 1)
    outs, stages = [], []
    try:
        for on in (False, True):
            if on:
                trace.enable()
            p = AlignParams(conversion="A:G", randseed=9, out_unmap=True,
                            num_threads=2, batch_reads=64)
            buf = io.BytesIO()
            al = run_single_end(p, str(tmp_path / "ref.fa"),
                                str(tmp_path / "reads.fq"), out_fh=buf,
                                device="cpu")
            outs.append(buf.getvalue())
            stages.append({k: sum(a.stage[k] for a in al.peers)
                           for k in al.stage})
        spans = trace.snapshot()
    finally:
        trace.disable()
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 640
    assert stages[0] == stages[1]
    st = stages[1]
    assert st["ladder_batches"] == 10 and st["eager_batches"] == 0
    assert st["ladder_waves"] > st["ladder_batches"]   # later waves ran
    assert st["emit_python_reads"] == 576 and st["emit_native_reads"] == 64
    assert stage_report(al.peers).endswith("| SAM reads: native 64 python 576")
    names = collections.Counter(s.name for s in spans)
    assert set(names) == CPU_SPANS, set(names) ^ CPU_SPANS
    assert names["aligner.submit"] == names["aligner.finish"] == 10
    assert names["runner.queue"] == 10
    assert names["aligner.replay"] == st["ladder_waves"]
    assert names["devctx.wait"] == st["waves_device"]
    assert names["sam.python"] == 9 and names["sam.native"] == 1
    assert not any(s.open for s in spans)
    batches = {s.batch for s in spans if s.name == "aligner.submit"}
    assert batches == set(range(0, 640, 64))
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith(("aligner.", "devctx.", "sam.")) and \
                s.name not in ("aligner.submit", "aligner.finish",
                               "devctx.init"):
            up = by_id[s.parent]
            assert up.thread == s.thread and up.batch == s.batch
            assert up.t0 <= s.t0 <= s.t1 <= up.t1
    # the children cover the work: the parents' own thread CPU is at most
    # a tenth of theirs (wall self time also counts the -p 2 threads'
    # waits for the interpreter lock in the lines between child spans)
    kids = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None and s.c0 is not None:
            kids[s.parent] += s.c1 - s.c0
    for name in ("aligner.submit", "aligner.finish"):
        cpu = sum(s.c1 - s.c0 for s in spans if s.name == name)
        own = sum(s.c1 - s.c0 - kids[s.id] for s in spans if s.name == name)
        assert 0 <= own <= 0.1 * cpu, (name, own, cpu)
