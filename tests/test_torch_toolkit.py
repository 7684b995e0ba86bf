"""The port's toolkit (basal_tpu_torch.toolkit) against basal_tpu's.

The inputs are the port's own output: a small reference and reads made from
a numpy seed, aligned by the port's CLI on the CPU with every wave forced
through its device context (``BASAL_TPU_TORCH_DEVICE=cpu
BASAL_TPU_HOST_EVAL=0``), to SAM and BAM, under ``C:T``, ``A:G`` and
``T:- -n 1 -g 3 -R``.  Each case runs one toolkit subcommand through both
packages on the same files, each in a directory of its own, and every file
either writes must be byte-identical (a gzip file's content, since its header
holds a timestamp).  Under ``-M T:-`` basal_tpu's avgmod is run through its
per-read pileup (``AvgMod._add_file_slow``): its batched one drops deletion
sites, which the port's counts (see the port's ``toolkit/avgmod.py``).

Also: the eTAM/GLORI recipe (examples/pipeline-eTAM-GLORI.sh) through both
packages on test_pipeline_e2e's data, and the port's toolkit CLIs in a
subprocess, which must end with neither basal_tpu nor jax imported.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import make_ref, random_genome

ROOT = Path(__file__).resolve().parents[1]
PORT_ENV = {"PYTHONPATH": str(ROOT), "BASAL_TPU_TORCH_DEVICE": "cpu",
            "BASAL_TPU_HOST_EVAL": "0"}

ALIGN_RUN = """
import json, sys
from basal_tpu_torch import cli
for argv in json.loads(sys.argv[1]):
    cli.main(argv)
bad = sorted(m for m in sys.modules if m in ("basal_tpu", "jax")
             or m.startswith(("basal_tpu.", "jax.")))
assert not bad, bad
"""

ALIGNMENTS = {
    "ct": ["-M", "C:T"],
    "ag": ["-M", "A:G"],
    "bid": ["-M", "T:-", "-n", "1", "-g", "3", "-R"],
}

COMP = np.zeros(256, np.uint8)
COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _reads(rng, g, n, frm, to, ln=90):
    """n reads of ln bases from g, half of their ``frm`` bases turned into
    ``to`` (``-``: a deletion of one ``frm`` base in a third of the reads);
    a third are reverse complemented."""
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(g) - ln - 4))
        r = g[p:p + ln + 3].copy()
        if to == "-":
            hit = np.flatnonzero(r[20:ln - 20] == ord(frm))
            if i % 3 == 0 and hit.size:
                r = np.delete(r, 20 + hit[int(rng.integers(hit.size))])
        else:
            r[(r == ord(frm)) & (rng.random(r.size) < 0.5)] = ord(to)
        r = r[:ln]
        if i % 3 == 1:
            r = COMP[r][::-1]
        out.append(r.tobytes())
    return out


def _write_fastq(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 6 kbp chr1 with T runs planted, three read sets aligned by the
    port to SAM and BAM, a CRAM of the C:T SAM, a sorted and indexed C:T
    BAM, two AvgMod tables, a BED and test_toolkit's mergeBAM inputs."""
    d = tmp_path_factory.mktemp("kit")
    rng = np.random.default_rng(606)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000)
    for p in rng.integers(50, 5900, 60):          # homopolymer T runs
        g[p:p + int(rng.integers(2, 5))] = ord("T")
    (d / "ref.fa").write_bytes(b">chr1\n" + g.tobytes() + b"\n")
    rules = {"ct": ("C", "T"), "ag": ("A", "G"), "bid": ("T", "-")}
    runs = []
    for name, (frm, to) in rules.items():
        _write_fastq(d / f"{name}.fq", _reads(rng, g, 150, frm, to))
        for ext in ("sam", "bam"):
            runs.append(["-a", f"{name}.fq", "-d", "ref.fa", *ALIGNMENTS[name],
                         "-S", "1", "-u", "-V", "0", "-o", f"{name}.{ext}"])
    r = subprocess.run([sys.executable, "-c", ALIGN_RUN, json.dumps(runs)],
                       cwd=d, env={**os.environ, **PORT_ENV},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]

    from basal_tpu.toolkit import avgmod, bamutil, cram
    from basal_tpu.toolkit.bamio import BamWriter
    for name in rules:
        body = [ln for ln in (d / f"{name}.sam").read_text().splitlines()
                if not ln.startswith("@")]
        assert sum(ln.split("\t")[2] == "chr1" for ln in body) > 100, name
    ref = avgmod.load_reference(str(d / "ref.fa"), set())
    cram.write_cram(str(d / "ct.cram"),
                    (d / "ct.sam").read_text().splitlines(True), ref=ref)
    bamutil.sort(str(d / "ct.bam"), str(d / "ct.sorted.bam"))
    bamutil.index(str(d / "ct.sorted.bam"))

    cwd = os.getcwd()
    os.chdir(d)
    try:
        from basal_tpu.toolkit.cli import main
        main(["avgmod", "ct.sam", "ref.fa", "-M", "C:T", "-m", "1",
              "-o", "treat"])
    finally:
        os.chdir(cwd)
    rows = (d / "treat_AvgMod.tsv").read_text().splitlines()
    assert len(rows) > 50
    ctrl = [rows[0]]
    for ln in rows[1:]:
        f = ln.split("\t")
        tot = int(f[7])
        mod = int(rng.binomial(tot, 0.1))
        f[4], f[6] = f"{mod / tot:.3f}", str(mod)
        ctrl.append("\t".join(f))
    (d / "ctrl_AvgMod.tsv").write_text("\n".join(ctrl) + "\n")
    starts = np.sort(rng.integers(1, 5800, 12))
    (d / "r.bed").write_text("".join(
        f"chr1\t{s}\t{s + int(rng.integers(20, 400))}\tr{i}\t0\t"
        f"{'+-'[i % 2]}\n" for i, s in enumerate(starts)))

    # test_toolkit.py::test_mergebam_lift's GTF and transcriptome BAM; the
    # genome BAM is the port's sorted C:T alignment
    (d / "ann.gtf").write_text(
        'chr1\tx\texon\t101\t150\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t201\t250\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t301\t350\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
        'chr1\tx\texon\t401\t450\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n')
    with BamWriter(str(d / "t.bam")) as bw:
        bw.write("@HD\tVN:1.0\n@SQ\tSN:t1\tLN:100\n@SQ\tSN:t2\tLN:100\n"
                 "tr1\t0\tt1\t41\t255\t20M\t*\t0\t0\t" + "C" * 20 + "\t"
                 + "I" * 20 + "\tZS:Z:++\n"
                 "tr2\t0\tt2\t1\t255\t10M\t*\t0\t0\t" + "ACGTACGTAC" + "\t"
                 + "I" * 10 + "\tZS:Z:++\n")
    return d


# case -> (tool, argv with {d} for the data directory); outputs go to the cwd
CASES = {
    "avgmod-sam": ("cli", ["avgmod", "{d}/ct.sam", "{d}/ref.fa", "-M", "C:T",
                           "-m", "1", "-o", "o"]),
    "avgmod-bam": ("cli", ["avgmod", "{d}/ct.bam", "{d}/ref.fa", "-M", "C:T",
                           "-m", "1", "-o", "o"]),
    "avgmod-cram": ("cli", ["avgmod", "{d}/ct.cram", "{d}/ref.fa", "-M",
                            "C:T", "-m", "1", "-o", "o"]),
    "avgmod-CG-combine": ("cli", ["avgmod", "{d}/ct.sam", "{d}/ref.fa", "-M",
                                  "C:T", "-m", "1", "-x", "CG", "-g",
                                  "-o", "o"]),
    "avgmod-AG-RNA-wig": ("cli", ["avgmod", "{d}/ag.bam", "{d}/ref.fa", "-M",
                                  "A:G", "-T", "RNA", "-m", "1", "-w", "w",
                                  "-o", "o"]),
    "avgmod-D-M": ("cli", ["avgmod", "{d}/bid.bam", "{d}/ref.fa", "-M", "T:-",
                           "-D", "M", "-T", "RNA", "-y", "7", "-m", "1",
                           "-o", "o"]),
    "avgmod-D-U-snp": ("cli", ["avgmod", "{d}/bid.sam", "{d}/ref.fa", "-M",
                               "T:-", "-i", "correct", "-m", "1", "-o", "o"]),
    "shiftD": ("cli", ["shiftD", "{d}/bid.bam", "-o", "shifted"]),
    "shiftD-sam": ("cli", ["shiftD", "{d}/bid.sam", "-o", "shifted"]),
    "mergeBAM": ("cli", ["mergeBAM", "{d}/t.bam", "{d}/ct.sorted.bam",
                         "{d}/ann.gtf", "-o", "m"]),
    "mergeBAM-unlift": ("cli", ["mergeBAM", "{d}/t.bam", "{d}/ct.sorted.bam",
                                "{d}/ann.gtf", "-u", "-o", "m"]),
    "regmod": ("cli", ["regmod", "{d}/r.bed", "{d}/treat_AvgMod.tsv",
                       "-o", "reg.tsv"]),
    "regmod-strand": ("cli", ["regmod", "{d}/r.bed", "{d}/treat_AvgMod.tsv",
                              "-s", "-o", "reg.tsv"]),
    "view-F": ("bamutil", ["view", "{d}/ct.bam", "-F", "0xE04",
                           "-o", "v.bam"]),
    "view-include": ("bamutil", ["view", "{d}/ct.bam", "--include-flags",
                                 "4", "-o", "v.bam"]),
    "view-sam": ("bamutil", ["view", "{d}/bid.bam", "-F", "0x10",
                             "-o", "v.sam"]),
    "view-region": ("bamutil", ["view", "{d}/ct.sorted.bam", "chr1:1500-3500",
                                "-F", "0x4", "-o", "v.bam"]),
    "sort": ("bamutil", ["sort", "{d}/bid.bam", "-o", "s.bam"]),
    "sort-spill": ("bamutil", ["sort", "{d}/ag.sam", "-m", "40",
                               "-o", "s.sam"]),
    "index": ("bamutil", ["index", "{d}/ct.sorted.bam", "-o", "i.bai"]),
    "fastq": ("bamutil", ["fastq", "{d}/ct.bam", "-o", "f.fq"]),
    "fastq-gz": ("bamutil", ["fastq", "{d}/bid.bam", "-o", "f.fq.gz"]),
}
for _m in ("binomial", "poisson", "fisher"):
    CASES[f"fdr-{_m}"] = ("cli", ["fdr", "{d}/treat_AvgMod.tsv", "-d", _m,
                                  "-m", "1", "-o", "f"])
    CASES[f"fdr-{_m}-ctrl"] = ("cli", ["fdr", "{d}/treat_AvgMod.tsv", "-c",
                                       "{d}/ctrl_AvgMod.tsv", "-d", _m,
                                       "-m", "1", "-o", "f"])


def _run_tool(pkg, tool, argv, cwd):
    import importlib
    mod = importlib.import_module(
        f"{pkg}.toolkit.{'cli' if tool == 'cli' else 'bamutil'}")
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert mod.main(argv) in (0, None)
    finally:
        os.chdir(old)


def _contents(d: Path) -> dict:
    out = {}
    for f in sorted(d.rglob("*")):
        if f.is_file():
            raw = f.read_bytes()
            out[str(f.relative_to(d))] = (gzip.decompress(raw)
                                          if f.suffix == ".gz" else raw)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_port_toolkit_output_equals_basal_tpus(data, tmp_path, monkeypatch,
                                               case):
    tool, argv = CASES[case]
    argv = [a.format(d=data) for a in argv]
    if "T:-" in argv:
        from basal_tpu.toolkit.avgmod import AvgMod
        monkeypatch.setattr(AvgMod, "add_file", AvgMod._add_file_slow)
    got = {}
    for pkg in ("basal_tpu", "basal_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        _run_tool(pkg, tool, argv, out)
        got[pkg] = _contents(out)
    want = got["basal_tpu"]
    assert want and all(want.values()), want.keys()
    assert got["basal_tpu_torch"].keys() == want.keys()
    for name, body in want.items():
        assert got["basal_tpu_torch"][name] == body, name


@pytest.mark.parametrize("mode", ["M", "U"])
def test_avgmod_counts_deletion_sites(data, mode):
    """Under -M T:- a read's deletion at a T site is that site's
    conversion.  The port's batched pileup counts it as basal_tpu's
    per-read path does, array for array; basal_tpu's batched pileup leaves
    it out (under -D M it finds no modified site)."""
    from basal_tpu.toolkit.avgmod import AvgMod as JaxAvgMod
    from basal_tpu_torch.toolkit.avgmod import AvgMod, load_reference
    ref = load_reference(str(data / "ref.fa"), set())
    bam = str(data / "bid.bam")
    port = AvgMod(ref, "T", ["-"], conversion_mode=mode, molecule_type="RNA")
    port.add_file(bam)
    slow = JaxAvgMod(ref, "T", ["-"], conversion_mode=mode,
                     molecule_type="RNA")
    slow._add_file_slow(bam)
    for cr in ref:
        np.testing.assert_array_equal(port.depth[cr], slow.depth[cr])
        np.testing.assert_array_equal(port.meth[cr], slow.meth[cr])
    n_del = sum("D" in ln.split("\t")[5]
                for ln in (data / "bid.sam").read_text().splitlines()
                if not ln.startswith("@"))
    deleted = sum(int(v.sum()) for v in port.meth.values()) if mode == "M" \
        else sum(int(port.depth[c].sum() - port.meth[c].sum()) for c in ref)
    assert n_del > 20 and deleted >= n_del


def test_port_writes_basal_tpus_cram(data, tmp_path):
    from basal_tpu.toolkit import cram as jcram
    from basal_tpu_torch.toolkit import avgmod, cram
    lines = (data / "ct.sam").read_text().splitlines(True)
    ref = avgmod.load_reference(str(data / "ref.fa"), set())
    cram.write_cram(str(tmp_path / "port.cram"), lines, ref=ref)
    jcram.write_cram(str(tmp_path / "jax.cram"), lines, ref=ref)
    assert (tmp_path / "port.cram").read_bytes() == \
        (tmp_path / "jax.cram").read_bytes() == (data / "ct.cram").read_bytes()
    body = [ln.rstrip("\n") for ln in lines if not ln.startswith("@")]
    back = cram.read_cram_to_sam(str(tmp_path / "port.cram"), ref)
    assert [ln for ln in back.splitlines() if not ln.startswith("@")] == body


def _e2e_data(tmp_path, rng):
    """test_pipeline_e2e's genome, transcriptome, GTF and reads, drawn in
    the same order from the same seed."""
    tmp_path.mkdir()
    genome = random_genome(rng, 12000)
    make_ref(tmp_path / "genome.fa", [("chr1", genome)])
    e1, e2 = (2001, 2400), (3001, 3400)
    tx = genome[e1[0] - 1:e1[1]] + genome[e2[0] - 1:e2[1]]
    make_ref(tmp_path / "tx.fa", [("t1", tx)])
    with open(tmp_path / "ann.gtf", "w") as f:
        for a, b in (e1, e2):
            f.write(f'chr1\tx\texon\t{a}\t{b}\t.\t+\t.\tgene_id "g1"; '
                    f'transcript_id "t1"; exon_number "1";\n')
    reads = []
    for i in range(60):
        pos = rng.randrange(0, len(genome) - 80)
        s = "".join("G" if (c == "A" and rng.random() < 0.5) else c
                    for c in genome[pos:pos + 80])
        reads.append((f"g{i}", s))
    for i in range(40):
        pos = rng.randrange(320, 420)
        s = "".join("G" if (c == "A" and rng.random() < 0.5) else c
                    for c in tx[pos:pos + 80])
        reads.append((f"t{i}", s))
    with gzip.open(tmp_path / "reads.fq.gz", "wt") as f:
        for n, s in reads:
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")


def test_etam_recipe_through_both_packages(tmp_path, rng):
    """examples/pipeline-eTAM-GLORI.sh as it is, and a copy that calls
    basal_tpu_torch (-p 2: TorchThreadedRunner, every wave through the
    device context on the CPU): the merged BAM (@PG aside), the AvgMod table
    and the FDR table are equal."""
    from basal_tpu_torch.toolkit.bamio import decode_bam_to_sam
    script = ROOT / "examples" / "pipeline-eTAM-GLORI.sh"
    port_script = tmp_path / "pipeline-port.sh"
    port_script.write_text(script.read_text().replace("basal_tpu.",
                                                      "basal_tpu_torch."))
    assert port_script.read_text().count("basal_tpu_torch.") == 9
    runs = {"jax": (script, {"JAX_PLATFORMS": "cpu"}),
            "port": (port_script, PORT_ENV)}
    _e2e_data(tmp_path / "jax", rng)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    for name, (sh, env) in runs.items():
        d = tmp_path / name
        r = subprocess.run(
            ["bash", str(sh), "reads.fq.gz", "genome.fa", "tx.fa", "ann.gtf",
             "smp"], cwd=d, capture_output=True, text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": str(ROOT), "CORES": "2", **env})
        assert r.returncode == 0, (name, r.stderr[-3000:])
    jax, port = tmp_path / "jax", tmp_path / "port"

    def body(d):
        sam = decode_bam_to_sam(str(d / "smp.merge.sorted.bam"))
        return [ln for ln in sam.splitlines() if not ln.startswith("@PG")]

    want = body(jax)
    assert sum("N" in ln.split("\t")[5] for ln in want
               if not ln.startswith("@")) > 10     # lifted junction reads
    assert body(port) == want
    assert (port / "smp_AvgMod.tsv").read_bytes() == \
        (jax / "smp_AvgMod.tsv").read_bytes()
    assert len((jax / "smp_AvgMod.tsv").read_text().splitlines()) > 20
    assert gzip.decompress((port / "smp_FDR.tsv.gz").read_bytes()) == \
        gzip.decompress((jax / "smp_FDR.tsv.gz").read_bytes())


TOOL_RUN = """
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
bad = sorted(m for m in sys.modules if m in ("basal_tpu", "jax")
             or m.startswith(("basal_tpu.", "jax.")))
print("IMPORTED", bad)
"""


@pytest.mark.parametrize("module,argv,out", [
    ("basal_tpu_torch.toolkit.cli",
     ["avgmod", "{d}/ct.bam", "{d}/ref.fa", "-M", "C:T", "-m", "1", "-o", "o"],
     "o_AvgMod.tsv"),
    ("basal_tpu_torch.toolkit.bamutil",
     ["sort", "{d}/bid.bam", "-o", "s.bam"], "s.bam"),
], ids=["cli-avgmod", "bamutil-sort"])
def test_toolkit_cli_imports_neither_basal_tpu_nor_jax(data, tmp_path, module,
                                                      argv, out):
    r = subprocess.run(
        [sys.executable, "-c", TOOL_RUN, module,
         *[a.format(d=data) for a in argv]],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED []" in r.stdout, r.stdout[-2000:]
    assert (tmp_path / out).stat().st_size > 0
