"""Entry points of the port for a harness: a one-wave step and a mesh dry run.

``entry()``             -> (fn, example_args): one wave of the flagship
                           compute path, the count kernel
                           (``extend_counts_blob``), on the port's device.
``dryrun_multichip(n)`` -> one full sharded extension step over an
                           n-device (dp, rs) mesh, held element for element
                           against the single context, ungapped and gapped.

Both use ``_problem``, the port's copy of ``_tiny_problem`` of the root
``__graft_entry__`` (a 20 kbp genome, 64 reads, built through the port's
host pipeline).  The device is ``BASAL_TPU_TORCH_DEVICE`` (default
``cuda``):

    python -m basal_tpu_torch.entry [N]
    BASAL_TPU_TORCH_DEVICE=cpu python -m basal_tpu_torch.entry 4
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _problem(rule="A:G", gap=0, chains=0):
    """(params, ref, enc, table): a miniature but complete alignment problem
    built through the port's host layers, the same as ``_tiny_problem`` of
    ``__graft_entry__`` builds through basal_tpu's."""
    import os
    import random
    import tempfile

    from .align.candidates import SeedScheduler, build_candidates
    from .align.rng import MyRand
    from .config import AlignParams
    from .index.reference import load_reference
    from .index.seedindex import build_index
    from .reads.encode import encode_batch
    from .reads.io import ReadRec

    rng = random.Random(7)
    genome = "".join(rng.choice("ACGT") for _ in range(20000))
    fd, path = tempfile.mkstemp(suffix=".fa")
    with os.fdopen(fd, "w") as f:
        f.write(">chrE\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i:i + 60] + "\n")
    params = AlignParams(conversion=rule, randseed=1, gap=gap, chains=chains)
    ref = load_reference(path, params)
    os.unlink(path)
    index = build_index(ref, params)

    reads = []
    for i in range(64):
        pos = rng.randrange(0, len(genome) - 100)
        s = "".join("G" if (c == "A" and rng.random() < 0.5) else c
                    for c in genome[pos:pos + 100])
        reads.append(ReadRec(index=i, readset=0, name=f"r{i}", seq=s,
                             qual="I" * 100))
    enc = encode_batch(params, reads)
    sched = SeedScheduler(params, index, MyRand(1))
    table = build_candidates(params, index, enc, sched)
    return params, ref, enc, table


def entry(device=None):
    """(fn, example_args): ``fn(ref32, blob)`` returns the u8 mismatch
    counts of ``_tiny_problem()``'s candidates, one wave, through
    ``extend_counts_blob``; the args are its tensors on the device."""
    from .align.pipeline import TorchDeviceContext, blob_to_device
    from .ops.extend_cuda import extend_counts_blob

    params, ref, enc, table = _problem()
    ctx = TorchDeviceContext(ref, params, device)
    waves = list(ctx.wave_blobs(enc, table.loc, table.plane.astype(np.int32),
                                table.row))
    if len(waves) != 1:
        raise AssertionError(f"the tiny problem makes {len(waves)} waves")
    blob, C, U, E = waves[0]
    shape = dict(mode=ctx.mode, W=enc.W, nw=ctx.nw, C=C, U=U, E=E)

    def fwd(ref32, blob_):
        return extend_counts_blob(ref32, blob_, **shape)

    return fwd, (ctx.ref32, blob_to_device(blob, ctx.device)[0])


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Build an n-device mesh (2 rs shards when n is even and >= 4, the
    rest dp) over ``devices`` (default, on the port's device:
    ``[cuda:i % cards]``, or ``[cpu] * n``), run the tiny problem through
    it, and check counts, and the gapped ``T:- -g 3`` variant's (counts,
    pos0, pos1), against the single context on the first device.  Raises
    on any difference; returns what it ran."""
    from .align.pipeline import TorchDeviceContext, resolve_device
    from .parallel.mesh import ShardedTorchDeviceContext, make_mesh

    if devices is None:
        dev = resolve_device()
        k = torch.cuda.device_count() if dev.type == "cuda" else 0
        devices = [torch.device("cuda", i % k) if k else dev
                   for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    n_rs = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_dp = n_devices // n_rs
    mesh = make_mesh(n_dp, n_rs, devices)
    report = {"mesh": [n_dp, n_rs], "devices": [str(d) for d in devices]}
    for name, kw in (("counts", {}),
                     ("gap", dict(rule="T:-", gap=3, chains=1))):
        params, ref, enc, table = _problem(**kw)
        if table.loc.size == 0:
            raise AssertionError(f"{name}: the tiny problem has no candidates")
        args = (enc, table.loc, table.plane.astype(np.int32),
                table.row.astype(np.int32))
        ctx = ShardedTorchDeviceContext(ref, params, mesh)
        got = ctx.extend(*args)
        want = TorchDeviceContext(ref, params, devices[0]).extend(*args)
        if got[0].shape[0] != table.loc.size:
            raise AssertionError(f"{name}: {got[0].shape[0]} results for "
                                 f"{table.loc.size} candidates")
        if name == "counts" and not (got[0] == 0).any():
            raise AssertionError("expected some perfect hits")
        for part, a, b in zip(("counts", "pos0", "pos1"), got, want):
            if a is None and b is None:
                continue
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: mesh {part} differ from the "
                                     f"single context")
        report[name] = {"candidates": int(table.loc.size),
                        "waves": ctx.up_waves}
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    fn, args = entry()
    counts = fn(*args)
    print(f"entry: {counts.numel()} counts on {counts.device}, "
          f"{int((counts == 0).sum())} exact")
    print(f"dryrun_multichip({n}): ok {dryrun_multichip(n)}")
    for name in ("jax", "basal_tpu"):
        if name in sys.modules:
            raise AssertionError(f"basal_tpu_torch.entry imported {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
