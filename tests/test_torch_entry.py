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
    CPU), and the SAM is the unprofiled run's."""
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
