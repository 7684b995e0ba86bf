"""The port's entry points (entry, dryrun_multichip) and its profiler hook.

``basal_tpu_torch.entry.entry()`` must give ``__graft_entry__.entry()``'s
counts (XLA) on the same tiny problem, and ``dryrun_multichip(n)`` must
pass over CPU devices; the module runs as a program without jax.
``BASAL_TPU_PROFILE=<dir>`` must leave a Chrome trace of a run there.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import convert_reads, make_fastq, make_ref, random_genome

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_entry_counts_equal_basal_tpu():
    import __graft_entry__
    from basal_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    got = fn(*args)
    assert got.dtype == torch.uint8 and got.device == CPU
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs))
    assert got.numel() > 100 and want.size >= got.numel()
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  want[:got.numel()].astype(np.int32))
    assert int((got == 0).sum()) > 0


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_dryrun_multichip_on_cpu_devices(n):
    from basal_tpu_torch.entry import dryrun_multichip
    report = dryrun_multichip(n, devices=[CPU] * n)
    n_rs = 2 if n % 2 == 0 and n >= 4 else 1
    assert report["mesh"] == [n // n_rs, n_rs]
    assert report["counts"]["candidates"] > 100
    assert report["gap"]["candidates"] > 0
    assert report["counts"]["waves"] >= n // n_rs


def test_dryrun_multichip_needs_its_devices():
    from basal_tpu_torch.entry import dryrun_multichip
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(4, devices=[CPU] * 3)


def test_entry_module_runs_without_jax():
    r = subprocess.run([sys.executable, "-m", "basal_tpu_torch.entry", "4"],
                       cwd=ROOT, capture_output=True, text=True, timeout=180,
                       env={**os.environ, "PYTHONPATH": str(ROOT),
                            "BASAL_TPU_TORCH_DEVICE": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip(4): ok" in r.stdout
    assert "entry: " in r.stdout


def test_profile_hook_writes_chrome_trace(tmp_path, rng, monkeypatch):
    """BASAL_TPU_PROFILE=<dir>: torch.profiler around run_single_end; the
    trace holds the run's device waves (the plain count core on the
    CPU) and the program's spans on the same timeline, and the SAM is the
    unprofiled run's."""
    from basal_tpu_torch import trace
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.config import AlignParams
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("chrT", g)])
    make_fastq(tmp_path / "reads.fq",
               convert_reads(rng, g, 60, 90, "A:G", sub_rate=0.01))
    p = AlignParams(conversion="A:G", randseed=3, out_unmap=True)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = []
    for prof in (None, tmp_path / "prof"):
        if prof is not None:
            monkeypatch.setenv("BASAL_TPU_PROFILE", str(prof))
        buf = io.BytesIO()
        run_single_end(p, str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq"),
                       out_fh=buf, device="cpu")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 60
    traces = list((tmp_path / "prof").glob("basal_tpu_torch_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any(n.startswith("aten::") for n in names)
    # the program's spans, on the profiler's timeline: the aten:: events
    # of the plain count core lie inside an aligner.submit or
    # aligner.finish span of their thread
    ours = [e for e in events if e.get("cat") == "basal_tpu_torch"]
    got = {e["name"] for e in ours}
    assert {"aligner.submit", "aligner.finish", "devctx.launch",
            "index.build"} <= got
    parents = [e for e in ours
               if e["name"] in ("aligner.submit", "aligner.finish")]
    launches = [e for e in ours if e["name"] == "devctx.launch"]

    def inside(e, spans):
        return any(p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   for p in spans)
    core = [e for e in events if e.get("name", "").startswith("aten::")
            and e.get("ph") == "X" and inside(e, launches)]
    assert core and all(inside(e, parents) for e in core)
    assert not trace.enabled()


def test_profile_hook_survives_a_lost_mark(tmp_path, rng, monkeypatch):
    """A profiler that drops the MARK event costs the run nothing: it
    returns, its SAM is whole, the Chrome trace is written and the spans go
    to a file of their own, with a warning.  An error of the block itself
    is the one raised, also when adding the spans fails too."""
    import contextlib

    import torch.profiler
    from basal_tpu_torch import trace
    from basal_tpu_torch.align import pipeline
    from basal_tpu_torch.config import AlignParams
    g = random_genome(rng, 4000)
    make_ref(tmp_path / "ref.fa", [("chrT", g)])
    make_fastq(tmp_path / "reads.fq",
               convert_reads(rng, g, 30, 90, "A:G", sub_rate=0.01))
    p = AlignParams(conversion="A:G", randseed=3, out_unmap=True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setenv("BASAL_TPU_PROFILE", str(tmp_path / "prof"))
    buf = io.BytesIO()
    with pytest.warns(UserWarning, match="no basal_tpu_torch.trace_open"):
        al = pipeline.run_single_end(p, str(tmp_path / "ref.fa"),
                                     str(tmp_path / "reads.fq"), out_fh=buf,
                                     device="cpu")
    assert al is not None and buf.getvalue().count(b"\n") > 30
    (path,) = (tmp_path / "prof").glob("basal_tpu_torch_*[0-9].json")
    assert json.loads(path.read_text())["traceEvents"]
    spans = json.loads(path.with_suffix(".spans.json").read_text())
    assert "aligner.submit" in {e["name"] for e in spans["traceEvents"]}
    assert not trace.enabled()

    def broken(*a):
        raise OSError("no room")
    monkeypatch.setattr(trace, "add_to_chrome_trace", broken)
    with pytest.raises(ValueError, match="the block's"):
        with pipeline.profile_run(str(tmp_path / "prof2"), CPU):
            raise ValueError("the block's")
    with pytest.raises(OSError, match="no room"):
        with pipeline.profile_run(str(tmp_path / "prof3"), CPU):
            pass
    assert not trace.enabled()
