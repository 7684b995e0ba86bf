"""Multi-process runs of the port (torch.distributed, gloo) against
basal_tpu.

Each worker (``python -m basal_tpu_torch.parallel.worker``) holds only its
k-mer range of the seed index (TorchRoutedSeedIndex), aligns its own read
window on the CPU device with every wave forced through the port's device
context (``BASAL_TPU_HOST_EVAL=0``: the plain count core), and serves its
peers' routing rounds; the concatenated SAM must equal the single-process
port and basal_tpu byte for byte.  Reads have one length, as in
tests/test_multihost.py, so no read meets the stale-scheduler quirk that
would make the windowed run differ from the single one.  The workers fail
if they import jax.
"""

import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from conftest import convert_reads, make_fastq, make_ref, random_genome

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(nprocs, workdir, cfg, **env):
    """Run the workers; every one must exit 0 within TIMEOUT."""
    cfg = {"backend": "gloo", "device": "cpu", "mesh_check": False, **cfg}
    (workdir / "mh_cfg.json").write_text(json.dumps(cfg))
    full = {**os.environ, "PYTHONPATH": str(ROOT),
            "BASAL_TPU_HOST_EVAL": "0", **env}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "basal_tpu_torch.parallel.worker", str(pid),
         str(nprocs), str(port), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full,
        cwd=ROOT) for pid in range(nprocs)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{out}\n{err}"
    merged = b"".join((workdir / f"out_p{i}.sam").read_bytes()
                      for i in range(nprocs))
    stats = [json.loads((workdir / f"stats_p{i}.json").read_text())
             for i in range(nprocs)]
    return merged, stats


def _se_fixture(tmp_path, rng, n_reads, genome_bp):
    head = random_genome(rng, genome_bp // 2)
    rep = random_genome(rng, 271) * 10
    tail = random_genome(rng, genome_bp // 2)
    ref_txt = head + rep + tail
    make_ref(tmp_path / "ref.fa", [("chr1", ref_txt)])
    make_fastq(tmp_path / "reads.fq",
               convert_reads(rng, ref_txt, n_reads, 100, rule="A:G",
                             revcomp_frac=0.5, sub_rate=0.01))


def _single_runs(tmp_path, params_kw, monkeypatch, pairs=False):
    """(the port's single-process SAM, device-forced on the CPU;
    basal_tpu's SAM)."""
    from basal_tpu.align.pipeline import run_single_end as jax_se
    from basal_tpu.config import AlignParams as JaxParams
    from basal_tpu.pairs.pipeline import run_pair_end as jax_pe
    from basal_tpu_torch.align.pipeline import run_single_end
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.pairs.pipeline import run_pair_end

    params = AlignParams(**params_kw)
    files = ([str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")] if pairs
             else [str(tmp_path / "reads.fq")])
    ref = str(tmp_path / "ref.fa")
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    port = io.BytesIO()
    (run_pair_end if pairs else run_single_end)(
        params, ref, *files, out_fh=port, command_line="basal-tpu",
        device="cpu")
    monkeypatch.delenv("BASAL_TPU_HOST_EVAL")
    jax = io.BytesIO()
    (jax_pe if pairs else jax_se)(JaxParams(**params_kw), ref, *files,
                                  out_fh=jax, command_line="basal-tpu")
    return port.getvalue(), jax.getvalue()


def test_two_process_se_equals_single(tmp_path, rng, monkeypatch):
    """2 processes, uneven windows (1350 / 1349 reads, batches of 700) so
    that process 1 finishes first and serves process 0's last rounds
    through the drain protocol; then the cross-process mesh check."""
    n_reads = 2699
    _se_fixture(tmp_path, rng, n_reads, 120_000)
    params_kw = dict(conversion="A:G", randseed=7, batch_reads=700,
                     out_unmap=True, verbose_level=0)
    merged, st = _spawn(2, tmp_path, {
        "params": params_kw, "ref": str(tmp_path / "ref.fa"),
        "reads": str(tmp_path / "reads.fq"), "n_reads": n_reads,
        "mesh_check": True, "local_devices": 2})
    port, jax = _single_runs(tmp_path, params_kw, monkeypatch)
    assert merged.count(b"\n") > n_reads
    assert merged == port
    assert merged == jax
    total_k = st[0]["local_shard_kmers"] + st[1]["local_shard_kmers"]
    assert 0 < st[0]["local_shard_kmers"] < total_k
    assert [s["reads"] for s in st] == [1350, 1349]
    for s in st:
        assert s["exchanged_queries"] > 0 and s["exchanged_locs"] > 0
        assert s["cand_device"] > 0 and s["device_waves"] > 0
        m = s["mesh"]
        assert m["ok"] and m["rs_span_processes"] == 2 and m["dp"] == 2
        assert m["candidates"] > 1000
        assert m["waves"] >= 2


def test_three_process_se_equals_single(tmp_path, rng, monkeypatch):
    """3 processes: three k-mer ranges, uneven windows 900 / 900 / 899,
    queries that hit two foreign shards, two peers draining before the
    last."""
    n_reads = 2699
    _se_fixture(tmp_path, rng, n_reads, 90_000)
    params_kw = dict(conversion="A:G", randseed=11, batch_reads=450,
                     out_unmap=True, verbose_level=0)
    merged, st = _spawn(3, tmp_path, {
        "params": params_kw, "ref": str(tmp_path / "ref.fa"),
        "reads": str(tmp_path / "reads.fq"), "n_reads": n_reads})
    port, jax = _single_runs(tmp_path, params_kw, monkeypatch)
    assert merged == port
    assert merged == jax
    assert [s["reads"] for s in st] == [900, 900, 899]
    assert sum(s["exchanged_queries"] for s in st) > 0
    total_k = sum(s["local_shard_kmers"] for s in st)
    assert all(0 < s["local_shard_kmers"] < total_k for s in st)


def test_two_process_pe_equals_single(tmp_path, rng, monkeypatch):
    """PE over 2 processes with batches of 751 pairs: over 512, so mate a
    takes the volume guard of align_batch, which must fetch mate a's
    k-mers before it builds its groups (without that fetch the groups are
    built from k-mers that never arrived and the SAM differs)."""
    n_pairs = 1501
    genome = random_genome(rng, 100_000)
    make_ref(tmp_path / "ref.fa", [("chr1", genome)])
    comp = str.maketrans("ACGT", "TGCA")
    ra, rb = [], []
    for i in range(n_pairs):
        pos = rng.randrange(0, len(genome) - 400)
        ins = rng.randrange(150, 380)
        a = list(genome[pos:pos + 100])
        b = list(genome[pos + ins - 100:pos + ins].translate(comp)[::-1])
        for s in (a, b):
            for j, c in enumerate(s):
                if c == "A" and rng.random() < 0.5:
                    s[j] = "G"
        ra.append((f"p{i}/1", "".join(a)))
        rb.append((f"p{i}/2", "".join(b)))
    make_fastq(tmp_path / "r1.fq", ra)
    make_fastq(tmp_path / "r2.fq", rb)
    params_kw = dict(conversion="A:G", randseed=5, batch_reads=751,
                     out_unmap=True, verbose_level=0, pairend=True)
    merged, st = _spawn(2, tmp_path, {
        "params": params_kw, "ref": str(tmp_path / "ref.fa"),
        "reads": str(tmp_path / "r1.fq"), "reads_b": str(tmp_path / "r2.fq"),
        "n_reads": n_pairs})
    port, jax = _single_runs(tmp_path, params_kw, monkeypatch, pairs=True)
    assert merged.count(b"\n") > 2 * n_pairs
    assert merged == port
    assert merged == jax
    assert [s["reads"] for s in st] == [751, 750]
    assert st[0]["exchanged_queries"] > 0 and st[0]["exchanged_locs"] > 0


def test_routed_index_matches_dense_single_process(tmp_path, rng):
    """TorchRoutedSeedIndex with one shard fills, for every queried k-mer,
    basal_tpu's dense index's entries (no process group needed)."""
    from basal_tpu.config import AlignParams as JaxParams
    from basal_tpu.index.reference import load_reference as jax_ref
    from basal_tpu.index.seedindex import build_index
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    from basal_tpu_torch.parallel.multihost import TorchRoutedSeedIndex
    from basal_tpu_torch.reads.encode import encode_batch
    from basal_tpu_torch.reads.io import open_reads

    _se_fixture(tmp_path, rng, 400, 60_000)
    kw = dict(conversion="A:G", randseed=7)
    p = AlignParams(**kw)
    jp = JaxParams(**kw)
    dense = build_index(jax_ref(str(tmp_path / "ref.fa"), jp), jp)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    routed = TorchRoutedSeedIndex(ref, p, num_shards=1, shard_id=0)
    assert routed.max_kmer_num == dense.max_kmer_num
    rd = open_reads(str(tmp_path / "reads.fq"), p)
    enc = encode_batch(p, rd.next_batch())
    rd.close()
    routed.ensure_batch(enc)
    q = enc.seedval.reshape(-1)
    q = np.unique(q[q < p.total_kmers])
    np.testing.assert_array_equal(routed.counts[q], dense.counts[q])
    np.testing.assert_array_equal(routed.n1[q], dense.n1[q])
    for k in q[dense.counts[q] > 0][:500]:
        ds = dense.locs[dense.starts[k]:dense.starts[k] + dense.counts[k]]
        rs = routed.locs[routed.starts[k]:routed.starts[k] + routed.counts[k]]
        np.testing.assert_array_equal(rs, ds, err_msg=f"kmer {k}")


def test_read_window_equals_basal_tpu(monkeypatch):
    """The same -B/-E windows as basal_tpu's read_window for every rank."""
    import jax

    from basal_tpu.config import AlignParams as JaxParams
    from basal_tpu.parallel import multihost as jmh
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.parallel import multihost as tmh
    for nproc in (1, 2, 3, 5):
        for pid in range(nproc):
            for kw, total in ((dict(), 2699), (dict(read_start=11), 100),
                              (dict(read_start=3, read_end=50), 1000)):
                monkeypatch.setattr(jax, "process_count", lambda: nproc)
                monkeypatch.setattr(jax, "process_index", lambda: pid)
                monkeypatch.setattr(tmh, "process_count", lambda: nproc)
                monkeypatch.setattr(tmh, "process_index", lambda: pid)
                want = jmh.read_window(JaxParams(**kw), total)
                got = tmh.read_window(AlignParams(**kw), total)
                assert (got.read_start, got.read_end) == \
                    (want.read_start, want.read_end)


def test_scale_out_modules_never_import_jax():
    code = ("import sys\n"
            "import basal_tpu_torch.parallel.worker, "
            "basal_tpu_torch.parallel.multihost, "
            "basal_tpu_torch.parallel.mesh, basal_tpu_torch.entry\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'basal_tpu' not in sys.modules, 'basal_tpu imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_routed_fills_are_serialised():
    """The service thread's fill and the caller's own-range fill may run at
    once; each must land whole.  A reply whose locs block while they are
    copied holds one fill inside ``_fill`` while another starts: unlocked,
    the second wrote its locs where the first was about to and the first
    then set ``_locs_n`` back."""
    import threading
    from basal_tpu_torch.parallel.routed import RoutedSeedIndex

    idx = object.__new__(RoutedSeedIndex)
    nk = 16
    idx.starts = np.zeros(nk, np.int64)
    idx.counts = np.zeros(nk, np.int32)
    idx.n1 = np.zeros(nk, np.int32)
    idx._have = np.zeros(nk, bool)
    idx._locs = np.zeros(4, np.uint32)
    idx._locs_n = 0
    idx._fill_lock = threading.Lock()   # TorchRoutedSeedIndex.__init__'s
    idx.t_phase = {"f_locs": 0.0, "f_scatter": 0.0, "f_have": 0.0}
    entered, release = threading.Event(), threading.Event()

    class BlockingLocs:
        def __init__(self, a):
            self.a = a

        def __array__(self, dtype=None, copy=None):
            entered.set()
            assert release.wait(10)
            return self.a

    first = threading.Thread(target=idx._fill, args=(
        np.array([1, 2]), np.array([0, 1]), np.array([2, 1]),
        np.array([0, 0]), BlockingLocs(np.array([10, 11, 12], np.uint32))))
    first.start()
    assert entered.wait(10)
    second = threading.Thread(target=idx._fill, args=(
        np.array([5]), np.array([0]), np.array([2]), np.array([1]),
        np.array([50, 51], np.uint32)))
    second.start()
    second.join(0.5)          # it waits for the first, or races it
    release.set()
    first.join(10)
    second.join(10)
    assert not first.is_alive() and not second.is_alive()
    assert idx._locs_n == 5
    for k, want in ((1, [10, 11]), (2, [12]), (5, [50, 51])):
        s, c = int(idx.starts[k]), int(idx.counts[k])
        assert idx._locs[s:s + c].tolist() == want, k
    assert idx._have[[1, 2, 5]].all() and idx.n1[5] == 1
