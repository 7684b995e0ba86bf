"""Checks that hold in every run, whatever the cell."""

from __future__ import annotations

import sys

#: top-level module names that may not be loaded in the process that
#: prints a result: jax and its kin, and the JAX package the port was
#: made from.  Compared whole: ``basal_tpu_torch`` is not ``basal_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "basal_tpu")


def forbidden_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose part before the first dot is one of
    FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
