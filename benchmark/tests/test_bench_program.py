"""The arithmetic of the program's spans (``benchkit.program``) on a
hand-built snapshot, and ``program_report.py`` on a whole CPU run.

Each metric of ``program.METRICS`` reads its known value on the snapshot
below and None on a run without one."""

import types

import pytest

from basal_tpu_torch.trace import Span
from benchkit import core, program

A, B, READS = 10.0, 20.0, 1000


def sp(name, batch, id, parent, thread, t0, t1, c0=None, c1=None,
       open=False):
    return Span(name, batch, id, parent, thread, t0, t1, c0, c1, open)


#: three batches in the window (100 and 300 on thread 1, 200 on thread 2),
#: one before it; set-up spans before the window, a collapse across its end
SNAPSHOT = [
    sp("index.build", None, 30, None, 1, 2.0, 5.0, 0.0, 3.0),
    sp("devctx.init", None, 31, None, 1, 6.0, 7.0, 3.0, 3.5),
    sp("kernels.load", None, 32, 31, 1, 6.5, 7.5, 3.1, 3.2),
    sp("aligner.submit", 0, 40, None, 1, 9.0, 9.5, 4.0, 4.5),
    sp("devctx.launch", 0, 41, 40, 1, 9.1, 9.2, 4.1, 4.2),
    sp("runner.queue", 100, 50, None, 1, 10.0, 10.2),
    sp("runner.queue", 200, 51, None, 2, 12.0, 12.4),
    sp("aligner.submit", 100, 1, None, 1, 10.2, 11.2, 0.0, 0.8),
    sp("aligner.encode", 100, 2, 1, 1, 10.3, 10.5, 0.1, 0.3),
    sp("aligner.dedup", 100, 3, 1, 1, 10.6, 11.0, 0.3, 0.5),
    sp("devctx.blob", 100, 4, 1, 1, 11.0, 11.1, 0.5, 0.6),
    sp("devctx.launch", 100, 5, 1, 1, 11.1, 11.15, 0.6, 0.65),
    sp("aligner.finish", 100, 6, None, 1, 11.2, 12.2, 1.0, 1.9),
    sp("aligner.ladder", 100, 7, 6, 1, 11.3, 12.1, 1.05, 1.85),
    sp("aligner.replay", 100, 8, 7, 1, 11.4, 11.6, 1.1, 1.3),
    sp("devctx.launch", 100, 9, 7, 1, 11.7, 11.75, 1.35, 1.4),
    sp("sam.python", 100, 10, 6, 1, 12.1, 12.2, 1.85, 1.9),
    sp("aligner.submit", 200, 11, None, 2, 12.4, 12.6, 0.0, 0.2),
    sp("aligner.groups", 200, 15, 11, 2, 12.45, 12.5, 0.05, 0.1),
    sp("aligner.fill", 200, 16, 11, 2, 12.5, 12.55, 0.1, 0.15),
    sp("aligner.finish", 200, 13, None, 2, 12.6, 13.0, 0.2, 0.6),
    sp("devctx.wait", 200, 14, 13, 2, 12.7, 12.8, 0.3, 0.3),
    sp("sam.native", 200, 12, 13, 2, 12.9, 13.0, 0.5, 0.6),
    sp("aligner.submit", 300, 17, None, 1, 13.0, 13.1, 2.0, 2.1),
    sp("index.thp_collapse", None, 60, None, 3, 19.0, 21.0, open=True),
]

#: the value of each metric on SNAPSHOT
EXPECTED = {
    "aligner.encode_us_per_read": 200.0,
    "aligner.groups_us_per_read": 50.0,
    "aligner.fill_us_per_read": 50.0,
    "aligner.dedup_us_per_read": 400.0,
    "aligner.replay_us_per_read": 200.0,
    # 0.8 s less the replay (0.2) and the launch (0.05) under it
    "aligner.ladder_self_us_per_read": 550.0,
    "aligner.waves_per_batch": 2 / 3,      # batch 0's launch is outside
    # self time of dedup, ladder, blob, sam.python: 1.15 s wall, 0.9 CPU
    "aligner.offcpu_pct": 100 * (1 - 0.9 / 1.15),
    "sam.python_reads_pct": 50.0,          # batches of 100 and 100 reads
    "devctx.blob_us_per_read": 100.0,
    "devctx.pinned_us_per_read": None,     # no span: no card
    "devctx.wait_us_per_read": 100.0,
    "runner.queue_ms": 300.0,
    "index.thp_window_s": 1.0,
    "setup.warmup_s": 5.0,
    "setup.device_s": 1.5,
}


def a_run(spans):
    return types.SimpleNamespace(program=spans, win=types.SimpleNamespace(
        t_open=A, t_last=B, reads=READS))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_on_a_hand_built_snapshot(name):
    assert set(EXPECTED) == set(program.METRICS)
    got = program.metric(a_run(SNAPSHOT), name)
    if EXPECTED[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(EXPECTED[name], rel=1e-9)
    assert program.metric(a_run(None), name) is None
    bare = types.SimpleNamespace(win=a_run(None).win)   # no field at all
    assert program.metric(bare, name) is None


def test_self_time_slots_and_collapses():
    p = program.of(a_run(SNAPSHOT))
    # batch 100: 1.0 s less 0.75 under children, 200: 0.2 less 0.1, 300
    assert p.self_share("aligner.submit") == pytest.approx(
        (0.25 + 0.1 + 0.1) / (1.0 + 0.2 + 0.1))
    # CPU: 0.8 less 0.2 + 0.2 + 0.1 + 0.05 on batch 100, 0.2 less 0.1 on
    # 200, 0.1 on 300
    assert p.self_share("aligner.submit", cpu=True) == pytest.approx(
        (0.25 + 0.1 + 0.1) / 1.1)
    slots = p.slots()
    assert [s["thread"] for s in slots] == [1, 2]
    assert [s["batches"] for s in slots] == [3, 1]     # 0 and 100 and 300
    assert slots[0]["busy_pct"] == pytest.approx(100 * 2.1 / 10)
    assert slots[1]["busy_pct"] == pytest.approx(100 * 0.6 / 10)
    (c,) = p.collapses()
    assert c == dict(start_s=9.0, seconds=2.0, open=True, after_batches=4)
    gaps = dict(p.uncovered("aligner.finish"))
    for k in ("start->aligner.ladder", "start->devctx.wait",
              "devctx.wait->sam.native"):
        assert gaps[k] == pytest.approx(100.0)          # 0.1 s per 1000
    (gap,) = p.leaves_over([(11.35, 11.8)])
    assert gap[0] == pytest.approx(0.45)
    assert [n for n, _ in gap[1]] == ["aligner.replay", "devctx.launch"]
    (gap,) = p.leaves_over([(12.0, 12.45)])     # runner.queue is no work
    assert gap[1] == [("sam.python", pytest.approx(0.1))]
    tab = p.table()
    assert tab["aligner.dedup"]["offcpu_pct"] == pytest.approx(50.0)
    assert tab["runner.queue"]["offcpu_pct"] is None
    assert tab["aligner.submit"]["n"] == 3
    assert program.report(a_run(None)) == {}
    rep = program.report(a_run(SNAPSHOT), idle=[(11.35, 11.8), (14, 19)])
    assert len(rep["idle_gaps_by_leaf"]) == 2
    assert rep["metrics"]["runner.queue_ms"] == pytest.approx(300.0)


def test_union():
    assert program.union([]) == 0.0
    assert program.union([(0, 2), (1, 3), (5, 6)]) == pytest.approx(4.0)


SIZES = dict(config=dict(genome_bp=1_000_000),
             cell=dict(reads=250_000, warmup_writes=4, sample_per_wave=256,
                       sample_per_write=64),
             params=dict(batch_reads=1000))


def test_program_report_on_a_cpu_run(bench_root, monkeypatch):
    import program_report
    from basal_tpu_torch import trace
    from basal_tpu_torch.align.aligner import SingleEndAligner
    make_run = core.Run
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    # every batch on the strata ladder, as on the card at full size
    monkeypatch.setattr(SingleEndAligner, "EAGER_MAX_CANDS", 1)
    rep = program_report.run(bench_root, "glori_se100.mrna", 2 ** 31 + 5,
                             1.0, True, device="cpu", sizes=SIZES)
    assert core.Run is make_run and not trace.enabled()
    assert rep["result"]["correct"] and rep["n_spans"] > 0
    m = rep["metrics"]
    for name in ("aligner.encode_us_per_read", "aligner.replay_us_per_read",
                 "aligner.ladder_self_us_per_read", "devctx.blob_us_per_read",
                 "devctx.wait_us_per_read", "runner.queue_ms",
                 "setup.warmup_s", "setup.device_s"):
        assert m[name] is not None and m[name] >= 0, name
    assert m["devctx.pinned_us_per_read"] is None        # no card
    # the program's parents against the harness's wrappers around the
    # same calls, in the same run
    for name in ("aligner.submit", "aligner.finish"):
        ours = rep[name]["wall_us_per_read"]
        theirs = rep["wrappers"][name + "_batch"]
        assert ours == pytest.approx(theirs, rel=0.05)
    assert "idle_gaps_by_leaf" in rep


def test_run_keeps_the_programs_spans_only_when_traced(bench_root,
                                                      monkeypatch):
    from basal_tpu_torch import trace
    from basal_tpu_torch.align.aligner import SingleEndAligner
    runs, make_run = [], core.Run

    def catch_run(*a, **k):
        runs.append(make_run(*a, **k))
        return runs[-1]
    monkeypatch.setattr(core, "Run", catch_run)
    monkeypatch.setattr(SingleEndAligner, "EAGER_MAX_CANDS", 1)
    outs = [core.run_cell(bench_root, "glori_se100.mrna", 2 ** 31 + 21, 1.0,
                          traced, device="cpu", sizes=SIZES)
            for traced in (False, True)]
    untraced, traced = runs
    assert untraced.program is None and not trace.enabled()
    assert traced.program and {s.name for s in traced.program} >= {
        "aligner.submit", "runner.queue", "devctx.blob", "aligner.ladder"}
    # every numeric stage key of the aligners is a counter
    for run in runs:
        assert run.delta("emit_python_reads") + run.delta(
            "emit_native_reads") == run.win.reads
        assert run.delta("ladder_batches") > 0
    assert all(o["correct"] for o in outs)
    m = outs[1]["metrics"]
    for name in ("sam.python_reads_pct", "aligner.ladder_self_us_per_read",
                 "devctx.blob_us_per_read", "runner.queue_ms"):
        assert m[name]["value"] >= 0, name
    assert m["sam.python_reads_pct"]["value"] == 100.0
    assert "runner.queue_ms" not in outs[0]["metrics"]
