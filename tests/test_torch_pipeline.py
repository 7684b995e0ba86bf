"""The slice as a whole: the port's CLI writes the same SAM as basal_tpu's.

The port runs in a subprocess with ``BASAL_TPU_TORCH_DEVICE=cpu
BASAL_TPU_HOST_EVAL=0``, so that every wave goes through
TorchDeviceContext and the count core's plain version; the subprocess also
asserts that jax was never imported (this test process imports jax through
conftest).  basal_tpu runs in this process, jax pinned to the CPU, with
``BASAL_TPU_HOST_EVAL=0`` (its XLA device kernel).  SAM bodies, @PG aside,
must be byte-identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import convert_reads, make_fastq, make_ref, norm_sam, random_genome
from test_differential_gap import deletion_reads, insertion_reads
from test_differential_se import run_ours

ROOT = Path(__file__).resolve().parents[1]

PORT_RUN = """
import sys
from basal_tpu_torch import cli
cli.main(sys.argv[1:])
assert "jax" not in sys.modules, "basal_tpu_torch imported jax"
assert "basal_tpu" not in sys.modules, "basal_tpu_torch imported basal_tpu"
"""


def run_port(argv, cwd, **env):
    full = {**os.environ, "PYTHONPATH": str(ROOT),
            "BASAL_TPU_TORCH_DEVICE": "cpu", "BASAL_TPU_HOST_EVAL": "0",
            **env}
    return subprocess.run([sys.executable, "-c", PORT_RUN, *argv], cwd=cwd,
                          env=full, capture_output=True, text=True,
                          timeout=300)


def _data(tmp_path, rng, rule, n_reads=100, gap=0):
    """Converted reads, some with Ns and shorter; with ``gap`` half of them
    carry a planted deletion of the convert-from base and a third an
    insertion, of up to ``gap`` bases."""
    g = random_genome(rng, 8000)
    make_ref(tmp_path / "ref.fa", [("chrT", g)])
    frm = rule.split(":")[0]
    reads = convert_reads(rng, g, n_reads, rng.choice([90, 100]), rule,
                          rate=0.5, sub_rate=0.01, revcomp_frac=0.3)
    if gap:
        reads = (deletion_reads(rng, g, n_reads // 2, 100, frm=frm,
                                max_del=gap)
                 + insertion_reads(rng, g, n_reads // 3, 100, max_ins=gap)
                 + reads[:n_reads - n_reads // 2 - n_reads // 3])
    reads_out = []
    for i, (name, seq) in enumerate(reads):
        if i % 6 == 0:  # reads with Ns: exception rows in the blob
            j = rng.randrange(20, len(seq))
            seq = seq[:j] + "N" + seq[j + 1:]
        if i % 5 == 0:  # mixed read lengths
            seq = seq[:64 + i % 20]
        reads_out.append((name, seq))
    make_fastq(tmp_path / "reads.fq", reads_out)


SAM_CASES = {
    "C:T": ["-M", "C:T"],
    "A:G": ["-M", "A:G"],
    "A:CGT": ["-M", "A:CGT", "-n", "1"],
    "C:T-3": ["-M", "C:T", "-3"],
    "C:T-N": ["-M", "C:T", "-N"],
    # gapped: every wave through the gap core (pos0 / pos1 lists)
    "T:- g3": ["-M", "T:-", "-g", "3"],
    "C:T g1": ["-M", "C:T", "-g", "1"],
    "A:CGT g2": ["-M", "A:CGT", "-g", "2"],
}


@pytest.mark.parametrize("case", list(SAM_CASES))
def test_port_sam_equals_basal_tpu(tmp_path, rng, monkeypatch, case):
    flags = SAM_CASES[case]
    gap = int(flags[flags.index("-g") + 1]) if "-g" in flags else 0
    _data(tmp_path, rng, flags[1], gap=gap)
    argv = ["-a", "reads.fq", "-d", "ref.fa", *flags, "-S", "17", "-u",
            "-V", "2"]
    r = run_port(argv + ["-o", "port.sam"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    # every candidate went through the port's device context
    assert "host 0 visit-time 0" in r.stderr, r.stderr[-1000:]
    assert "eval: device 0 " not in r.stderr
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    want = run_ours(argv, tmp_path)
    got = (tmp_path / "port.sam").read_text()
    assert len(norm_sam(got)) > 100
    assert norm_sam(got) == norm_sam(want)


def test_port_bam_equals_basal_tpu(tmp_path, rng, monkeypatch):
    from basal_tpu import cli
    from basal_tpu.toolkit.bamio import decode_bam_to_sam
    _data(tmp_path, rng, "A:G")
    argv = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G", "-S", "5", "-u",
            "-V", "0"]
    r = run_port(argv + ["-o", "port.bam"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    monkeypatch.chdir(tmp_path)
    cli.main(argv + ["-o", "jax.bam"])
    got = decode_bam_to_sam(str(tmp_path / "port.bam"))
    want = decode_bam_to_sam(str(tmp_path / "jax.bam"))
    assert len(norm_sam(got)) > 100
    assert norm_sam(got) == norm_sam(want)


def test_threaded_runner_equals_single(tmp_path, rng, monkeypatch):
    """-p 2 over several batches (the port's TorchThreadedRunner) writes the
    same bytes as one aligner."""
    import io

    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.config import AlignParams
    _data(tmp_path, rng, "C:T", n_reads=120)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = []
    for threads in (1, 2):
        p = AlignParams(conversion="C:T", randseed=9, num_threads=threads,
                        batch_reads=25, out_unmap=True)
        buf = io.BytesIO()
        al = run_single_end(p, str(tmp_path / "ref.fa"),
                            str(tmp_path / "reads.fq"), out_fh=buf,
                            device="cpu")
        assert al._dev is not None and al._dev.up_waves > 0
        outs.append(buf.getvalue())
    assert outs[0].count(b"\n") > 120
    assert outs[0] == outs[1]


def test_auto_placement_on_cpu_takes_host_path(tmp_path, rng, monkeypatch):
    """On a CPU device, auto placement routes to the host evaluator, as
    basal_tpu does with jax pinned to the CPU; the SAM is the same."""
    import io

    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.config import AlignParams
    _data(tmp_path, rng, "A:G")
    outs = []
    for mode in ("auto", "0"):
        monkeypatch.setenv("BASAL_TPU_HOST_EVAL", mode)
        p = AlignParams(conversion="A:G", randseed=3, out_unmap=True)
        buf = io.BytesIO()
        al = run_single_end(p, str(tmp_path / "ref.fa"),
                            str(tmp_path / "reads.fq"), out_fh=buf,
                            device="cpu")
        if mode == "auto":
            assert al._dev is None and al.stage["cand_device"] == 0
        else:
            assert al.stage["cand_device"] > 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
