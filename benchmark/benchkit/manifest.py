"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its own parameters, and the readers of its metrics.  Every
piece is found by name, so a later cell, configuration, mix or metric is
added as files and entries alone.

Layout under ``benchmark/``:
  configs/<config>.json   deployment: entry, kernel, flags, environment,
                          genome, reads
  entries/<entry>.py      the program's entry the window drives, and the
                          classes the wrappers go around
  traffic/<mix>.json      where reads come from (one generator reads it)
  sources/<source>.py     where a mix of that ``source`` starts its reads
  cells/<cell>.json       the cell's read pool, warm-up and limits
  metrics/<metric>.py     ``read(run) -> float | None`` for one metric
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List


@dataclass
class Cell:
    name: str
    chips: int
    config: dict       # configs/<config>.json
    mix: dict          # traffic/<mix>.json
    params: dict       # cells/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(metric: dict, cell: str, e2e_here=None) -> bool:
    """Whether ``cell`` reports ``metric``: those its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_here is None or metric["moves"] in e2e_here


def cell(root: Path, name: str) -> Cell:
    man = load(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(work))})")
    w = work[name]
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / f"{w['config']}.json")
                        .read_text())
    mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    params = json.loads((bench / "cells" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"] if _reported(m, name)]
    here = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if _reported(m, name, here)]
    return Cell(name, int(w["chips"]), config, mix, params, e2e, layer)


def _module(root: Path, folder: str, name: str):
    path = root / "benchmark" / folder / f"{name}.py"
    mod = f"bench{folder}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod, path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def reader(root: Path, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return _module(root, "metrics", metric).read


def entry(root: Path, name: str):
    """The module ``benchmark/entries/<name>.py``: ``classes()`` and
    ``run(params, fasta, reads, sink, timings, device)``."""
    return _module(root, "entries", name)
