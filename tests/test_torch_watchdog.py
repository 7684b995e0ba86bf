"""The fetch watchdog of the port's device context (align.pipeline).

The port keeps basal_tpu's knobs (``BASAL_TPU_WATCHDOG``,
``BASAL_TPU_WATCHDOG_MIN``, ``WATCHDOG_FACTOR``), its timeout and its
exemption of the first fetch, but answers a stall differently: basal_tpu
evaluates the wave on the host and carries on, the port counts the stall and
raises.  A CPU wave has no event, so these tests hand the waves of a CPU
context a stub event whose ``query()`` turns true after a set number of polls
(or never), and arm the watchdog as a measured run would.
"""

import io

import numpy as np
import pytest
import torch

from conftest import (convert_reads, make_fastq, make_ref, norm_sam,
                      random_genome)

CPU = torch.device("cpu")


class StubEvent:
    """query() is true from poll ``ready_after + 1`` on (never when None);
    synchronize() stands for a wait that ends."""

    def __init__(self, ready_after=None):
        self.ready_after = ready_after
        self.polls = 0
        self.syncs = 0

    def query(self):
        self.polls += 1
        return self.ready_after is not None and self.polls > self.ready_after

    def synchronize(self):
        self.syncs += 1


def _case(tmp_path, gap=0, n_reads=60):
    """(params, reference, encoded batch, candidate table) of a small SE
    case, built with the port's own classes from a numpy seed."""
    from basal_tpu_torch.align.aligner import SingleEndAligner
    from basal_tpu_torch.align.candidates import build_candidates
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.index.seedindex import build_index
    from basal_tpu_torch.reads.encode import encode_batch
    from basal_tpu_torch.reads.io import open_reads

    rng = np.random.default_rng(61)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000)
    (tmp_path / "ref.fa").write_bytes(b">w1\n" + g.tobytes() + b"\n")
    pos = rng.integers(0, len(g) - 100, n_reads)
    reads = g[pos[:, None] + np.arange(90)[None, :]].copy()
    reads[(reads == ord("C")) & (rng.random(reads.shape) < 0.5)] = ord("T")
    with open(tmp_path / "reads.fq", "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * len(r)))
    p = AlignParams(conversion="C:T", randseed=3, gap=gap)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    index = build_index(ref, p)
    al = SingleEndAligner(p, ref, index, use_native=False)
    rd = open_reads(str(tmp_path / "reads.fq"), p)
    enc = encode_batch(p, rd.next_batch())
    rd.close()
    table = build_candidates(p, index, enc, al.sched)
    assert table.loc.size > n_reads
    return p, ref, enc, table


def _arm(ctx, cost=1e-12):
    """As after a measured fetch: the first fetch is past and the cost per
    candidate is known."""
    ctx._meas_skip = 0
    ctx.meas_t, ctx.meas_n = cost, 1
    return ctx


def _waves(ctx, enc, table, **stub):
    waves = ctx.extend_async(enc, table.loc, table.plane, table.row)
    assert waves and all(w.event is None for w in waves)   # CPU: no event
    return [w._replace(event=StubEvent(**stub)) for w in waves]


@pytest.fixture
def no_host_eval(monkeypatch):
    """Fail the test if the host evaluator is reached."""
    from basal_tpu_torch import native

    def refuse(*a, **k):
        raise AssertionError("a stalled wave went to the host evaluator")

    for name in ("host_eval_candidates", "host_eval_candidates_gap"):
        monkeypatch.setattr(native, name, refuse)


@pytest.mark.parametrize("gap", [0, 3])
def test_stall_raises_and_counts(tmp_path, monkeypatch, no_host_eval, gap):
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "0.02")
    monkeypatch.delenv("BASAL_TPU_WATCHDOG", raising=False)
    p, ref, enc, table = _case(tmp_path, gap)
    ctx = _arm(TorchDeviceContext(ref, p, CPU))
    waves = _waves(ctx, enc, table)
    with pytest.raises(RuntimeError, match="stalled") as e:
        ctx.fetch(waves)
    assert ctx.stalls == 1
    w = waves[0]
    msg = str(e.value)
    for part in (f"C={w.C} ", f"U={w.U} ", f"E={w.E} ", f"gap={gap} ",
                 "0.02 s", "1e-12", "stall #1"):
        assert part in msg, (part, msg)
    assert w.event.polls > 1 and w.event.syncs == 0
    # the context stays usable: a healthy fetch after the stall
    want = TorchDeviceContext(ref, p, CPU).extend(enc, table.loc,
                                                  table.plane, table.row)
    got = ctx.fetch(_waves(ctx, enc, table, ready_after=0))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ctx.stalls == 1


@pytest.mark.parametrize("gap", [0, 2])
def test_healthy_wave_returns_the_unguarded_arrays(tmp_path, monkeypatch, gap):
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "5")
    p, ref, enc, table = _case(tmp_path, gap)
    want = TorchDeviceContext(ref, p, CPU).extend(enc, table.loc,
                                                  table.plane, table.row)
    ctx = _arm(TorchDeviceContext(ref, p, CPU))
    waves = _waves(ctx, enc, table, ready_after=4)
    got = ctx.fetch(waves)
    assert ctx.stalls == 0
    assert all(w.event.polls == 5 and w.event.syncs == 0 for w in waves)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32


def test_done_wave_takes_one_query(tmp_path, monkeypatch):
    """The fast path: a wave already done costs one query() and nothing
    else, armed or not."""
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    p, ref, enc, table = _case(tmp_path)
    for ctx in (TorchDeviceContext(ref, p, CPU),
                _arm(TorchDeviceContext(ref, p, CPU))):
        waves = _waves(ctx, enc, table, ready_after=0)
        ctx.fetch(waves)
        assert all(w.event.polls == 1 and w.event.syncs == 0 for w in waves)


@pytest.mark.parametrize("value", ["0", ""])
def test_disabled_watchdog_waits(tmp_path, monkeypatch, no_host_eval, value):
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    monkeypatch.setenv("BASAL_TPU_WATCHDOG", value)
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "0")
    p, ref, enc, table = _case(tmp_path)
    ctx = _arm(TorchDeviceContext(ref, p, CPU))
    assert ctx.watchdog_timeout(1 << 20) is None
    waves = _waves(ctx, enc, table)          # never done by query()
    ctx.fetch(waves)
    assert ctx.stalls == 0
    assert all(w.event.polls == 1 and w.event.syncs == 1 for w in waves)


def test_first_fetch_is_exempt(tmp_path, monkeypatch, no_host_eval):
    """Unmeasured, or measured with the first fetch still to come, the
    watchdog is unarmed and fetch waits."""
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "0")
    p, ref, enc, table = _case(tmp_path)
    fresh = TorchDeviceContext(ref, p, CPU)
    assert fresh._meas_skip == 1 and fresh.cost_per_cand is None
    skip = _arm(TorchDeviceContext(ref, p, CPU))
    skip._meas_skip = 1
    unmeasured = TorchDeviceContext(ref, p, CPU)
    unmeasured._meas_skip = 0
    for ctx in (fresh, skip, unmeasured):
        assert ctx.watchdog_timeout(1000) is None
        waves = _waves(ctx, enc, table)
        ctx.fetch(waves)
        assert ctx.stalls == 0
        assert all(w.event.syncs == 1 for w in waves)


@pytest.mark.parametrize("floor,cost,C,want", [
    (None, 1e-9, 1 << 20, 3.0),                  # default floor of 3 s
    ("", 1e-9, 1 << 20, 3.0),                    # empty: the default
    (None, 1e-6, 1 << 20, 8 * 1e-6 * (1 << 20)),  # the cost above the floor
    ("0", 1e-6, 1000, 8e-3),
    ("0", 1e-6, 0, 8e-6),                        # max(C, 1)
    ("0.5", 1e-7, 1000, 0.5),
])
def test_timeout_formula(tmp_path, monkeypatch, floor, cost, C, want):
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    monkeypatch.delenv("BASAL_TPU_WATCHDOG", raising=False)
    if floor is None:
        monkeypatch.delenv("BASAL_TPU_WATCHDOG_MIN", raising=False)
    else:
        monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", floor)
    p, ref, _, _ = _case(tmp_path, n_reads=10)
    ctx = _arm(TorchDeviceContext(ref, p, CPU), cost)
    assert TorchDeviceContext.WATCHDOG_FACTOR == 8.0
    assert ctx.watchdog_timeout(C) == pytest.approx(want, rel=1e-12)


def test_sharded_context_is_guarded(tmp_path, monkeypatch, no_host_eval):
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.parallel.mesh import (ShardedTorchDeviceContext,
                                               make_mesh)
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "0.02")
    p, ref, enc, table = _case(tmp_path, gap=1)
    ctx = _arm(ShardedTorchDeviceContext(ref, p, make_mesh(2, 2, [CPU] * 4)))
    waves = _waves(ctx, enc, table)
    assert len(waves) >= 2                       # one per dp slice at least
    with pytest.raises(RuntimeError, match="stalled"):
        ctx.fetch(waves)
    assert ctx.stalls == 1
    want = TorchDeviceContext(ref, p, CPU).extend(enc, table.loc,
                                                  table.plane, table.row)
    got = ctx.fetch(_waves(ctx, enc, table, ready_after=2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_armed_pipeline_writes_basal_tpus_sam(tmp_path, rng, monkeypatch):
    """The port's run_single_end with a healthy watchdog armed on every
    wave (each wave's event done after three polls) writes the SAM of
    basal_tpu's run_single_end on the same reads."""
    from basal_tpu.align.pipeline import run_single_end as jax_run
    from basal_tpu.config import AlignParams as JaxParams
    from basal_tpu_torch.align import pipeline as P
    from basal_tpu_torch.config import AlignParams

    g = random_genome(rng, 8000)
    make_ref(tmp_path / "ref.fa", [("chrW", g)])
    make_fastq(tmp_path / "reads.fq",
               convert_reads(rng, g, 120, 90, "A:G", rate=0.5,
                             sub_rate=0.01, revcomp_frac=0.3))
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    monkeypatch.setenv("BASAL_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BASAL_TPU_WATCHDOG_MIN", "30")
    monkeypatch.delenv("BASAL_TPU_WATCHDOG", raising=False)
    events, ctxs = [], []
    download, init = P.download, P.TorchDeviceContext.__init__

    def stub_download(*a, **k):
        events.append(StubEvent(ready_after=3))
        return download(*a, **k)._replace(event=events[-1])

    def armed_init(self, *a, **k):
        init(self, *a, **k)
        ctxs.append(_arm(self, 1e-9))

    monkeypatch.setattr(P, "download", stub_download)
    monkeypatch.setattr(P.TorchDeviceContext, "__init__", armed_init)
    kw = dict(conversion="A:G", randseed=29, out_unmap=True)
    out = io.BytesIO()
    P.run_single_end(AlignParams(**kw), str(tmp_path / "ref.fa"),
                     str(tmp_path / "reads.fq"), out_fh=out)
    want = io.BytesIO()
    jax_run(JaxParams(**kw), str(tmp_path / "ref.fa"),
            str(tmp_path / "reads.fq"), out_fh=want)
    assert ctxs and all(c.stalls == 0 for c in ctxs)
    assert events and all(e.polls == 4 and e.syncs == 0 for e in events)
    got = norm_sam(out.getvalue().decode("latin1"))
    assert got == norm_sam(want.getvalue().decode("latin1"))
    assert sum(not ln.startswith("@") for ln in got) >= 100
