"""One process of a multi-process alignment run of the port.

    python -m basal_tpu_torch.parallel.worker PID NPROCS PORT WORKDIR

Counterpart of ``tools/multihost_worker.py``.  Each of the NPROCS processes
(started with the same PORT and WORKDIR, PID 0 .. NPROCS-1):

 1. joins the run over torch.distributed (``init_multihost``, rendezvous
    at ``localhost:PORT``) with the backend the config names,
 2. builds only its k-mer range of the seed index
    (``TorchRoutedSeedIndex``),
 3. aligns its contiguous read window (``read_window``) through the port's
    SE or PE pipeline, fetching the index entries each batch probes from
    their owners,
 4. serves its peers' routing rounds until all are done (``drain``),
 5. with ``mesh_check`` and more than one process, checks collectively that
    an rs mesh spanning the processes gives the single context's results,
 6. writes ``out_p{PID}.sam`` and ``stats_p{PID}.json`` to WORKDIR.

Config, ``WORKDIR/mh_cfg.json``: {"params": {AlignParams keywords}, "ref":
path, "reads": path, "reads_b": path (paired-end), "n_reads": int,
"backend": "gloo" | "nccl", "device": "cpu" | "cuda", "local_devices":
dp rows of the mesh check (default 2), "cpus": per-PID core lists,
"mesh_check": bool, "cmdline": str, "debug": bool}.  With device "cuda"
each process takes card PID % (cards visible).  The process fails if it
imported jax or basal_tpu.
"""

import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pid, nprocs, port = int(argv[0]), int(argv[1]), int(argv[2])
    workdir = Path(argv[3])
    cfg = json.loads((workdir / "mh_cfg.json").read_text())
    if cfg.get("cpus"):
        os.sched_setaffinity(0, set(cfg["cpus"][pid]))

    import dataclasses

    import torch

    from ..config import AlignParams
    from ..ops.extend_cuda import extend_counts_blob, extend_gap_blob
    from .multihost import TorchRoutedSeedIndex, init_multihost, read_window

    device = torch.device(cfg["device"])
    t0 = time.time()
    if device.type == "cuda":
        # set-up, apart from the align wall: the card's context and the
        # kernel library (a single-process run has both from its first
        # wave on)
        from ..ops import _build
        if device.index is None:
            device = torch.device("cuda",
                                  pid % max(torch.cuda.device_count(), 1))
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        _build.load()
    t_device_init = time.time() - t0
    init_multihost(f"localhost:{port}", nprocs, pid, cfg["backend"])

    params = AlignParams(**cfg["params"])
    params = dataclasses.replace(params, sam_header=(pid == 0))
    wparams = read_window(params, cfg["n_reads"])

    holder = {}

    def factory(ref, p):
        holder["ref"] = ref
        holder["idx"] = TorchRoutedSeedIndex(ref, p)
        return holder["idx"]

    wrappers = {"count": extend_counts_blob, "gap": extend_gap_blob}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    timings = {}
    log = ((lambda m, *a: print(f"[p{pid}] {m}", file=sys.stderr,
                                flush=True))
           if cfg.get("debug") else (lambda *a: None))
    kw = dict(command_line=cfg.get("cmdline", "basal-tpu"), log=log,
              timings=timings, device=device, index_factory=factory)
    with open(workdir / f"out_p{pid}.sam", "wb") as fh:
        if cfg.get("reads_b"):
            from ..pairs.pipeline import run_pair_end
            aligner = run_pair_end(wparams, cfg["ref"], cfg["reads"],
                                   cfg["reads_b"], out_fh=fh, **kw)
        else:
            from ..align.pipeline import run_single_end
            aligner = run_single_end(wparams, cfg["ref"], cfg["reads"],
                                     out_fh=fh, **kw)
    idx = holder["idx"]
    idx.drain()
    t_total = time.time() - t0
    t_align = time.time() - timings["t_align_start"]

    stats = {
        "pid": pid,
        "nprocs": nprocs,
        "backend": cfg["backend"],
        "device": str(device),
        "t_device_init": t_device_init,
        "t_ref": timings["t_ref"],
        "t_index": timings["t_index"],
        "t_align": t_align,
        "t_total": t_total,
        "reads": getattr(aligner, "total_reads", 0),
        "candidates": getattr(aligner, "total_candidates", 0),
        "routing_rounds": idx.rounds,
        "t_exchange": idx.t_exchange,
        "t_wait": idx.t_wait,
        "t_phase": {k: round(v, 3) for k, v in idx.t_phase.items()},
        "exchanged_queries": idx.exchanged_queries,
        "exchanged_locs": idx.exchanged_locs,
        "local_shard_kmers": int(idx.bounds[pid + 1] - idx.bounds[pid]),
        "local_shard_positions": int(len(idx.shard.locs)),
        "host_eval_s": getattr(aligner, "_host_t", 0.0),
        "cand_device": aligner.stage.get("cand_device", 0),
        "launches": {k: w.launches for k, w in wrappers.items()},
    }
    dev = aligner._dev
    if dev is not None:
        stats["device_waves"] = dev.up_waves
        if dev.meas_n:
            stats["extend_s_per_cand"] = dev.meas_t / dev.meas_n
            stats["extend_cands_measured"] = dev.meas_n

    if cfg.get("mesh_check", True) and nprocs > 1:
        stats["mesh"] = _mesh_check(holder["ref"], params, cfg, device)

    import torch.distributed as dist
    dist.destroy_process_group()
    for name in ("jax", "basal_tpu"):
        if name in sys.modules:
            raise AssertionError(f"the port's worker imported {name}")
    (workdir / f"stats_p{pid}.json").write_text(json.dumps(stats))
    print(f"[p{pid}] done: {json.dumps(stats)}", flush=True)
    return 0


def _mesh_check(ref, params, cfg, device):
    """Collective: extension over an rs mesh spanning the processes must
    equal the single context on the same candidate table (every process
    builds it from the same first 256 reads and a dense index)."""
    import numpy as np

    from ..align.candidates import SeedScheduler, build_candidates
    from ..align.pipeline import TorchDeviceContext
    from ..align.rng import MyRand
    from ..index.seedindex import build_index
    from ..ops.extend_cuda import extend_counts_blob, extend_gap_blob
    from ..reads.encode import encode_batch
    from ..reads.io import open_reads
    from .mesh import ShardedTorchDeviceContext
    from .multihost import make_multihost_mesh

    index = build_index(ref, params)
    rd = open_reads(cfg["reads"], params)
    full = rd.next_batch()
    batch = [full[i] for i in range(min(256, len(full)))]
    rd.close()
    enc = encode_batch(params, batch)
    sched = SeedScheduler(params, index, MyRand(params.randseed))
    table = build_candidates(params, index, enc, sched)

    want = TorchDeviceContext(ref, params, device).extend(
        enc, table.loc, table.plane, table.row)
    mesh = make_multihost_mesh([device] * cfg.get("local_devices", 2))
    ctx = ShardedTorchDeviceContext(ref, params, mesh)
    before = extend_counts_blob.launches + extend_gap_blob.launches
    t0 = time.time()
    got = ctx.extend(enc, table.loc, table.plane, table.row)
    t_mesh = time.time() - t0
    ok = all(np.array_equal(a, b) for a, b in zip(want, got)
             if a is not None or b is not None)
    return {"ok": ok, "candidates": int(table.loc.size),
            "rs_span_processes": mesh.n_rs, "dp": mesh.n_dp,
            "waves": ctx.up_waves,
            "launches": extend_counts_blob.launches
            + extend_gap_blob.launches - before,
            "t_mesh_extend": t_mesh}


if __name__ == "__main__":
    sys.exit(main())
