"""Whole runs on the CPU of a gapped deletion chemistry: BID-seq's
``-M T:- -n 1 -g 3 -R -u`` on the gap kernel's path, from the test
fixtures under ``tests/fixtures/`` (a configuration and a cell file, not a
cell of the benchmark).  A sound run comes out correct; one altered
position list entry, or an altered NM on each gapped record, or the 4-bit
control, do not."""

import json
import re
import shutil

import pytest

from benchkit import control, core
from benchkit import reference as ref

from conftest import BENCH

CELL = "bidseq_trial.mrna"
SIZES = dict(config=dict(genome_bp=1_000_000))


@pytest.fixture(scope="session")
def gapped_root(bench_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("gapped")
    shutil.copytree(bench_root / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    fix = BENCH / "tests" / "fixtures"
    for kind in ("configs", "cells"):
        for f in (fix / kind).iterdir():
            shutil.copy(f, root / "benchmark" / kind / f.name)
    man = json.loads((bench_root / "BENCHMARK.json").read_text())
    cfg = json.loads((fix / "configs" / "bidseq_trial.json").read_text())
    man["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                               file="benchmark/configs/bidseq_trial.json",
                               reduced=cfg["reduced"], why="a test fixture"))
    man["workloads"].append(dict(name=CELL, config=cfg["name"],
                                 traffic="mrna", chips=1,
                                 why="a test fixture"))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run(root, seconds=4.0, **kw):
    return core.run_cell(root, CELL, 2 ** 31 + 17, seconds, False,
                         device="cpu", sizes=SIZES, **kw)


def values(out):
    return {k: v["value"] for k, v in out["checks"].items()}


def test_sound_gapped_run_is_correct(gapped_root, monkeypatch):
    cigars = []
    check = ref.check_record

    def seen(line, *a):
        cigars.append(line.split(b"\t")[5])
        return check(line, *a)
    monkeypatch.setattr(ref, "check_record", seen)
    out = run(gapped_root)
    v = values(out)
    assert out["correct"], v
    assert v["off_origin_pct"] == 0 and v["unmapped_within_limit_pct"] == 0
    # counts and both position lists of each sampled candidate
    assert v["kernel_outputs_checked"] > 80 * 512
    gapped = [c for c in cigars if re.fullmatch(rb"\d+M\d+[DI]\d+M", c)]
    assert len(gapped) > 0.1 * len(cigars) > 10


def test_one_position_list_entry_altered(gapped_root, monkeypatch):
    from basal_tpu_torch.align import pipeline
    gap_blob = pipeline.extend_gap_blob

    def altered(*a, **kw):
        counts, pos0, pos1 = gap_blob(*a, **kw)
        pos1[:, 0, 0] += 1          # one of each candidate's 6 x 14
        return counts, pos0, pos1
    monkeypatch.setattr(pipeline, "extend_gap_blob", altered)
    out = run(gapped_root)
    v = values(out)
    assert not out["correct"]
    assert v["kernel_outputs_wrong"] > 0


def test_nm_of_gapped_records_altered(gapped_root, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner
    emit = SingleEndAligner._emit_native

    def nm_up(self, enc, waves):
        out = []
        for line in emit(self, enc, waves).split(b"\n"):
            f = line.split(b"\t")
            if len(f) > 11 and re.fullmatch(rb"\d+M\d+[DI]\d+M", f[5]):
                f = [b"NM:i:%d" % (int(x[5:]) + 1) if x.startswith(b"NM:i:")
                     else x for x in f]
            out.append(b"\t".join(f))
        return b"\n".join(out)
    monkeypatch.setattr(SingleEndAligner, "_emit_native", nm_up)
    out = run(gapped_root)
    v = values(out)
    assert not out["correct"]
    assert v["sam_records_wrong"] > 0 and v["kernel_outputs_wrong"] == 0


def test_gapped_control_is_not_correct(gapped_root):
    out = run(gapped_root, seconds=8.0, control=control.install)
    v = values(out)
    assert not out["correct"]
    assert v["kernel_outputs_wrong"] > 0


def test_a_gapped_record_in_an_ungapped_run_is_wrong(gapped_root,
                                                     monkeypatch):
    """The same records, checked as if -g were 0: the gapped ones are
    wrong."""
    lines = []
    check = ref.check_record

    def keep(line, *a):
        lines.append((line, a))
        return check(line, *a)
    monkeypatch.setattr(ref, "check_record", keep)
    run(gapped_root)
    # compare passes (rule, ref, reads, origins, limit, out_ref, n_mis,
    # gap, gap_edge, seeding): the same with gap 0
    verdicts = [check(line, *a[:7], 0, *a[8:])
                for line, a in lines
                if re.fullmatch(rb"\d+M\d+[DI]\d+M", line.split(b"\t")[5])]
    assert len(verdicts) > 10 and set(verdicts) == {"CIGAR/POS"}
