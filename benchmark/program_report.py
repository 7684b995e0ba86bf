"""One run of one cell with the program's span recorder on, and the
breakdown of where its host time goes (``benchkit.program.report``).

    python3 benchmark/program_report.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> --out <report.json>

Run from the root of a checkout, on the card the cell asks for.  The
report holds the result line's numbers, the per-layer metrics of
``benchkit.program.METRICS``, a table of every span (self and wall
thread-µs per read, off-CPU share), each aligner thread's batches and busy
share, the THP collapses, and what the parents' children leave uncovered.
With ``--trace 1`` the benchmark's profiler session runs too, and the ten
longest idle gaps of the card are given by the leaf spans that cover them.
With ``--trace 0`` the run's ``reads_per_s`` against an ordinary run's on
the same seed is what the recorder costs when on.

A ``--trace 1`` run of the harness keeps the program's spans on
``Run.program`` itself; a ``--trace 0`` run does not touch the recorder,
so this script turns it on around the run.  It catches the run's ``Run``
and the card's idle gaps as the harness makes them, in its own process
only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchkit import core, program  # noqa: E402
from benchkit import trace as btrace  # noqa: E402


def run(root, cell: str, seed: int, seconds: float, traced: bool,
        **kw) -> dict:
    """``core.run_cell`` with the recorder on; its result and the report
    of ``program.report``."""
    from basal_tpu_torch import trace
    runs, idle = [], []
    make_run, gaps = core.Run, btrace.gaps

    def catch_run(*a, **k):
        runs.append(make_run(*a, **k))
        return runs[-1]

    def catch_gaps(*a, **k):
        idle[:] = gaps(*a, **k)
        return idle

    core.Run, btrace.gaps = catch_run, catch_gaps
    trace.enable()
    try:
        res = core.run_cell(root, cell, seed, seconds, traced, **kw)
        if runs[-1].program is None:
            runs[-1].program = trace.snapshot()
    finally:
        trace.disable()
        core.Run, btrace.gaps = make_run, gaps
    r = runs[-1]
    return dict(result=res, reads_per_s=r.win.reads_per_s,
                setup_s=r.setup_s, rss_gib=r.rss_gib,
                window_s=r.win.seconds, reads=r.win.reads,
                timings=r.timings, n_spans=len(r.program),
                wrappers={k: r.us_per_read(k) for k in (
                    "aligner.submit_batch", "aligner.finish_batch")},
                **program.report(r, idle))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    rep = run(ROOT, a.workload, a.seed, a.seconds, bool(a.trace))
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(rep, indent=1, default=str))
    print(json.dumps({k: rep[k] for k in ("reads_per_s", "setup_s",
                                          "rss_gib")}
                     | {"correct": rep["result"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
