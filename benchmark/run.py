"""One run of one benchmark cell of basal_tpu_torch.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control int4]

Run from the root of a checkout.  Prints the result as one JSON object on
the last line of standard output, and each number compared for
``correct`` beside its limit as the last lines of standard error.  Exits
with another code than 0, and prints no result, without the CUDA cards the
cell asks for, or when jax or basal_tpu is loaded in this process.
``--control int4`` puts the plain reference, counting in 4 bits, in the
program's place (the control of the output check; its run must come out
not correct).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchkit import checks, core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int4",))
    a = ap.parse_args(argv)
    control = None
    if a.control:
        from benchkit.control import install
        control = install
    sys.path.insert(0, str(ROOT))
    try:
        out = core.run_cell(ROOT, a.workload, a.seed, a.seconds,
                            bool(a.trace), control=control)
    except core.NoDevice as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 3
    found = checks.forbidden_modules()
    if found:
        print(f"[bench] loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        bound = (f"limit {v['limit']}" if "limit" in v
                 else f"at least {v['floor']}")
        print(f"[check] {k} {v['value']} ({bound})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
