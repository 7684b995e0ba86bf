"""BENCHMARK.json against the contract's shapes, and every file it names."""

import json
import re

import pytest

from benchkit import manifest

from conftest import BENCH, REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert (REPO / MAN["command"][1]).is_file()


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in MAN["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]


def test_metric_entries():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert {"reads_per_s", "setup_s", "host_peak_rss_gib"} <= e2e
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) == LAYER_KEYS
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_every_cell_loads_and_reports(w):
    cell = manifest.cell(REPO, w)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "reads_per_s"}
    assert cell.per_layer
    assert cell.params["warmup_writes"] >= 4     # one batch per aligner
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(REPO, m["name"]))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((REPO / c["file"]).read_text())
    assert c["file"].startswith("benchmark/configs/")
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for k in c["reduced"]:
        assert k in cfg and k in cfg["assumed"]
    assert "BASAL_TPU_HOST_EVAL" in cfg["env"]
    assert (BENCH / "entries" / f"{cfg['entry']}.py").is_file()
    assert cfg["kernel"].endswith("_kernel")


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_find_their_pieces(w):
    cell = manifest.cell(REPO, w["name"])
    assert (BENCH / "sources" / f"{cell.mix['source']}.py").is_file()
    entry = manifest.entry(REPO, cell.config["entry"])
    assert callable(entry.run) and callable(entry.classes)
    assert set(cell.params["limits"]) == {"unmapped_within_limit_pct",
                                          "off_origin_pct"}


def test_layers_are_named_in_perf_md():
    perf = (REPO / "PERF.md").read_text()
    for m in MAN["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_harness_imports_nothing_of_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|basal_tpu)\b"
                     r"(?!_torch)", re.M)
    for f in BENCH.rglob("*.py"):
        assert not pat.search(f.read_text()), f
