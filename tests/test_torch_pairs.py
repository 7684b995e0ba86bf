"""Paired-end alignment: the port's CLI writes the same SAM as basal_tpu's.

The port runs in a subprocess with ``BASAL_TPU_TORCH_DEVICE=cpu`` (no jax:
the subprocess asserts it), by default with ``BASAL_TPU_HOST_EVAL=0`` so
that both mates' waves go through TorchDeviceContext and the plain count or
gap core.  basal_tpu runs in this process, jax pinned to the CPU, with
``BASAL_TPU_HOST_EVAL=0`` (its XLA device kernels).  SAM bodies, @PG aside,
must be byte-identical.  Data: an 8-9 kbp random genome and 40-60 pairs
(test_differential_pe's fragment simulator).
"""

import io

import pytest

from conftest import make_fastq, make_ref, norm_sam, random_genome
from test_differential_pe import pe_reads
from test_differential_rrbs import rrbs_genome
from test_differential_se import run_ours
from test_torch_pipeline import run_port

PE_ARGS = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-V", "2"]


def _pe_data(tmp_path, rng, rule, n=50, readlen=90, gap=0, genome=None,
             **kw):
    """Mate files of simulated fragments; with ``gap`` every other read 1
    loses up to ``gap`` bases inside (a planted deletion)."""
    g = genome or random_genome(rng, 8500)
    make_ref(tmp_path / "ref.fa", [("chrP", g)])
    r1, r2 = pe_reads(rng, g, n, readlen, rule=rule, **kw)
    if gap:
        for i in range(0, len(r1), 2):
            name, s = r1[i]
            j = rng.randrange(15, len(s) - 15)
            r1[i] = (name, s[:j] + s[j + rng.randrange(1, gap + 1):])
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)


def _equal_to_basal_tpu(tmp_path, monkeypatch, argv, env_port=None,
                        device_forced=True):
    r = run_port(argv + ["-o", "port.sam"], tmp_path, **(env_port or {}))
    assert r.returncode == 0, r.stderr[-3000:]
    if device_forced:  # both mates' waves went through the port's context
        assert "host 0 visit-time/lazy 0" in r.stderr, r.stderr[-1000:]
        assert "eval: device 0 " not in r.stderr
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    want = norm_sam(run_ours(argv, tmp_path))
    got = norm_sam((tmp_path / "port.sam").read_text())
    assert sum(not ln.startswith("@") for ln in got) >= 80
    assert got == want
    return r


PE_CASES = {
    "C:T": (["-M", "C:T", "-S", "1", "-u"], {}),
    "A:G": (["-M", "A:G", "-S", "5", "-v", "0.08", "-u"], {}),
    "A:CGT -n 1": (["-M", "A:CGT", "-S", "2", "-n", "1", "-u"],
                   {"rate": 0.35}),
    "C:T -g 2": (["-M", "C:T", "-S", "6", "-g", "2", "-u"], {"gap": 2}),
}


@pytest.mark.parametrize("case", list(PE_CASES))
def test_port_pe_sam_equals_basal_tpu(tmp_path, rng, monkeypatch, case):
    flags, kw = PE_CASES[case]
    _pe_data(tmp_path, rng, flags[1], **kw)
    _equal_to_basal_tpu(tmp_path, monkeypatch, PE_ARGS + flags)


@pytest.mark.parametrize("mode", ["1", "auto"])
def test_port_pe_host_eval_modes(tmp_path, rng, monkeypatch, mode):
    """BASAL_TPU_HOST_EVAL=1 and auto (the lockstep visit-time path on a
    CPU device) write what the device-forced run of basal_tpu writes."""
    _pe_data(tmp_path, rng, "C:T", gap=2)
    r = _equal_to_basal_tpu(
        tmp_path, monkeypatch,
        PE_ARGS + ["-M", "C:T", "-S", "6", "-g", "2", "-u"],
        env_port={"BASAL_TPU_HOST_EVAL": mode}, device_forced=False)
    assert "eval: device 0 " in r.stderr and "lockstep-lazy 1" in r.stderr


def test_port_pe_rrbs(tmp_path, rng, monkeypatch):
    """PE-RRBS (test_differential_rrbs.test_rrbs_pe's fragments): the
    fragment index, host evaluation and ZP/ZL pair tags."""
    g = rrbs_genome(rng, n_frags=50, frag_lo=120, frag_hi=300)
    make_ref(tmp_path / "ref.fa", [("chrR", g)])
    comp = str.maketrans("ACGT", "TGCA")
    sites = []
    i = g.find("CCGG")
    while i >= 0:
        sites.append(i + 1)
        i = g.find("CCGG", i + 1)
    r1s, r2s = [], []
    for a, b in zip(sites, sites[1:]):
        frag = g[a:b + 1]
        if len(frag) < 80:
            continue
        conv = "".join("T" if (c == "C" and rng.random() < 0.6) else c
                       for c in frag)
        L = min(60, len(conv))
        r1s.append((f"p{len(r1s)}/1", conv[:L]))
        r2s.append((f"p{len(r2s)}/2", conv[-L:].translate(comp)[::-1]))
        if len(r1s) >= 35:
            break
    make_fastq(tmp_path / "r1.fq", r1s)
    make_fastq(tmp_path / "r2.fq", r2s)
    argv = PE_ARGS + ["-M", "C:T", "-S", "3", "-D", "C-CGG", "-u", "-m",
                      "28", "-x", "600"]
    r = run_port(argv + ["-o", "port.sam"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    want = norm_sam(run_ours(argv, tmp_path))
    got = norm_sam((tmp_path / "port.sam").read_text())
    assert sum("ZP:i:" in ln for ln in got) >= 30
    assert got == want


def test_port_pe_bam_equals_basal_tpu(tmp_path, rng, monkeypatch):
    from basal_tpu import cli
    from basal_tpu.toolkit.bamio import decode_bam_to_sam
    _pe_data(tmp_path, rng, "C:T", gap=1)
    argv = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T", "-S",
            "4", "-g", "1", "-u", "-V", "0"]
    r = run_port(argv + ["-o", "port.bam"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    monkeypatch.chdir(tmp_path)
    cli.main(argv + ["-o", "jax.bam"])
    got = norm_sam(decode_bam_to_sam(str(tmp_path / "port.bam")))
    want = norm_sam(decode_bam_to_sam(str(tmp_path / "jax.bam")))
    assert len(got) > 80
    assert got == want


def test_pe_threaded_runner_equals_single(tmp_path, rng, monkeypatch):
    """-p 2 over several batches (TorchPairThreadedRunner) writes the same
    bytes as one aligner, gapped waves on the device context."""
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.pairs.pipeline import run_pair_end
    _pe_data(tmp_path, rng, "C:T", n=60, gap=2)
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    outs = []
    for threads in (1, 2):
        p = AlignParams(conversion="C:T", randseed=9, gap=2, pairend=True,
                        num_threads=threads, batch_reads=15, out_unmap=True)
        buf = io.BytesIO()
        al = run_pair_end(p, str(tmp_path / "ref.fa"),
                          str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
                          out_fh=buf, device="cpu")
        assert al._dev is not None and al._dev.up_waves > 0
        assert al.stage["cand_device"] > 0 and al.stage["cand_host"] == 0
        outs.append(buf.getvalue())
    assert outs[0].count(b"\n") > 120
    assert outs[0] == outs[1]


def test_port_pe_volume_split(tmp_path, rng, monkeypatch):
    """A batch over the candidate-volume cap (BASAL_TPU_PE_SPLIT_CANDS) is
    split with the scheduler state restored, as in basal_tpu
    (tests/test_pe_split.py); the SAM is the same."""
    from basal_tpu.pairs import pipeline as pp
    core = random_genome(rng, 700)
    _pe_data(tmp_path, rng, "C:T", n=530, readlen=80,
             genome=core * 5 + random_genome(rng, 4000))
    monkeypatch.setattr(pp.PairEndAligner, "MAX_BATCH_CANDS", 2000)
    r = _equal_to_basal_tpu(
        tmp_path, monkeypatch, PE_ARGS + ["-M", "C:T", "-S", "11"],
        env_port={"BASAL_TPU_PE_SPLIT_CANDS": "2000"})
    assert "volume-split 0" not in r.stderr and "volume-split" in r.stderr
