"""Multi-device extension: the dp x rs mesh of the port.

PyTorch counterpart of ``basal_tpu.parallel.mesh``.  A mesh is a grid of
torch devices, ``n_dp`` rows by ``n_rs`` columns:

* **dp** splits the candidates of a call into ``n_dp`` contiguous slices,
  one per row.  Each slice goes through ``TorchDeviceContext.wave_blobs``
  (CHUNK, then ``split_waves``), so every wave carries its own row offsets
  and needs no rebasing.
* **rs** splits the packed reference into ``n_rs`` contiguous word ranges
  with a 64-word halo (``shard_reference``); column j of every row holds
  shard j.  Every shard sees every candidate of its row: candidates whose
  window lies in the shard get their loc rebased to it, the others loc
  12800, and the kernel (``extend_counts_blob`` / ``extend_gap_blob``) runs
  once per shard.  Results outside the shard are masked to ``BIG`` in
  int32 and the shards merge by elementwise minimum: ``torch.minimum``
  inside a process, ``all_reduce(MIN)`` across processes
  (``multihost.make_multihost_mesh``).

A device may appear more than once in a mesh: its shards then run one after
the other on that device, which is how one card runs a 2x2 mesh.  A mesh
holds devices of one type; a CUDA mesh never moves work to the CPU.

Every candidate of a real wave lies in at least one shard (the halo is
wider than any W+3-word window of a read of up to 480 bases), so the merge
equals the single-device result element for element.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..align.aligner import _mode_name
from ..align.pipeline import (TorchDeviceContext, _Wave, blob_to_device,
                              download, resolve_device)
from ..config import AlignParams
from ..index.reference import PackedReference
from ..ops.bitops import M32
from ..ops.extend_cuda import extend_counts_blob, extend_gap_blob

BIG = 1 << 30   # result of a candidate outside a shard (int32)
HALO = 64       # words; > W+3 for any read length <= 480


class TorchMesh:
    """A (n_dp, n_rs) grid of torch devices.  ``devices[i][j]`` runs dp
    slice i against reference shard j; ``None`` marks a shard that another
    process holds, and then ``group`` is the process group whose
    ``all_reduce(MIN)`` merges the rs axis."""

    def __init__(self, devices: Sequence[Sequence[Optional[torch.device]]],
                 group=None):
        self.devices = [list(row) for row in devices]
        self.n_dp = len(self.devices)
        self.n_rs = len(self.devices[0]) if self.devices else 0
        self.group = group
        self.local_rs = [j for j in range(self.n_rs)
                         if self.devices[0][j] is not None]
        if not self.local_rs:
            raise ValueError("a mesh needs at least one local device")
        types = set()
        for row in self.devices:
            if len(row) != self.n_rs or [j for j in range(self.n_rs)
                                         if row[j] is not None] \
                    != self.local_rs:
                raise ValueError("every dp row must hold the same rs shards")
            types.update(row[j].type for j in self.local_rs)
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {types}")
        if group is None and len(self.local_rs) != self.n_rs:
            raise ValueError("remote rs shards need a process group")


def make_mesh(n_dp: int, n_rs: int = 1, devices=None) -> TorchMesh:
    """A mesh over ``devices`` (row-major, dp by rs; default: the first
    n_dp*n_rs cards).  Entries may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        devices = devices[:n_dp * n_rs]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_dp * n_rs:
        raise ValueError(f"{len(devices)} devices for a {n_dp}x{n_rs} mesh")
    return TorchMesh([devices[i * n_rs:(i + 1) * n_rs] for i in range(n_dp)])


def shard_reference(ref32: np.ndarray, n_rs: int,
                    halo: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split both planes into n_rs contiguous word ranges with ``halo``
    extra words on the right edge.  Returns (shards [n_rs, 2, shard_w +
    halo] u32, zero-padded past the reference; shard_start [n_rs] i32)."""
    nw = ref32.shape[1]
    shard_w = -(-nw // n_rs)
    shards = np.zeros((n_rs, 2, shard_w + halo), dtype=np.uint32)
    starts = np.zeros(n_rs, dtype=np.int32)
    for i in range(n_rs):
        a = i * shard_w
        b = min(a + shard_w + halo, nw)
        shards[i, :, :b - a] = ref32[:, a:b]
        starts[i] = a
    return shards, starts


class ShardedTorchDeviceContext(TorchDeviceContext):
    """TorchDeviceContext over a TorchMesh: the same surface
    (extend_async / fetch / extend, cost_per_cand, CHUNK, stalls, up_bytes,
    up_waves, down_bytes), so the SE and PE aligners take it as they take
    the single context.  ``up_waves`` counts the waves of the dp slices;
    each launches its kernel once per local rs shard.  Results come back
    as int32, merged over rs."""

    def __init__(self, ref: PackedReference, params: AlignParams,
                 mesh: TorchMesh):
        self.params = params
        self.mesh = mesh
        self.mode = _mode_name(params)
        self.n_dp, self.n_rs = mesh.n_dp, mesh.n_rs
        self.shard_w = -(-ref.ref32.shape[1] // self.n_rs)
        shards, self.starts = shard_reference(ref.ref32, self.n_rs, HALO)
        self.nw = self.shard_w + HALO      # words per plane of one shard
        self.ref_shards = {}               # (device, rs index) -> int32
        for row in mesh.devices:
            for j in mesh.local_rs:
                if (row[j], j) not in self.ref_shards:
                    words = shards[j].reshape(-1).view(np.int32)
                    self.ref_shards[row[j], j] = torch.from_numpy(
                        words).to(row[j])
        self.device = mesh.devices[0][mesh.local_rs[0]]
        self._init_counters()

    def rebase(self, dblob: torch.Tensor, C: int, j: int, W: int):
        """(the wave blob with its C locs rebased to rs shard j, in-shard
        mask [C]).  A candidate is in the shard when its whole window (W+1
        words, gapped W+3 from one word earlier) is; the others get loc
        12800 and are masked after the launch.  The strand bit (31) is
        kept."""
        gap = self.params.gap
        locp = dblob[:C].to(torch.int64) & M32
        loc = locp & 0x7FFFFFFF
        k0 = (loc >> 4) - (1 if gap else 0)
        start = int(self.starts[j])
        wg = W + 3 if gap else W + 1
        in_shard = (k0 >= start) & (k0 + wg <= start + self.nw)
        local = (torch.where(in_shard, loc - 16 * start, 12800)
                 | (locp & (1 << 31)))
        local = (local - ((local >> 31) << 32)).to(torch.int32)
        return torch.cat([local, dblob[C:]]), in_shard

    def _launch_row(self, i: int, blob: np.ndarray, W: int, C: int, U: int,
                    E: int):
        """Row i's local shards on one wave: upload once per device,
        launch per shard, mask, merge.  Returns (merged int32 results,
        buffers to keep until the fetch)."""
        gap = self.params.gap
        row = self.mesh.devices[i]
        shape = dict(mode=self.mode, W=W, nw=self.nw, C=C, U=U, E=E)
        uploaded, keep, merged = {}, [], None
        for j in self.mesh.local_rs:
            d = row[j]
            with torch.cuda.device(d) if d.type == "cuda" else nullcontext():
                if d not in uploaded:
                    uploaded[d] = blob_to_device(blob, d)
                    self.up_bytes += blob.nbytes
                sblob, in_shard = self.rebase(uploaded[d][0], C, j, W)
                ref = self.ref_shards[d, j]
                if gap:
                    out = extend_gap_blob(ref, sblob, gap=gap, **shape)
                else:
                    out = (extend_counts_blob(ref, sblob, **shape),)
                out = tuple(
                    torch.where(in_shard.view(-1, *[1] * (t.dim() - 1)),
                                t.to(torch.int32), BIG) for t in out)
                keep.append(sblob)
                if merged is None:
                    merged = out
                else:
                    merged = tuple(
                        torch.minimum(m, o.to(m.device, non_blocking=True))
                        for m, o in zip(merged, out))
        keep.extend(uploaded.values())
        return merged, keep

    def _merge_processes(self, merged):
        """all_reduce(MIN) of the results over the mesh's process group;
        on gloo through host copies (gloo reduces CPU tensors only)."""
        import torch.distributed as dist
        if dist.get_backend(self.mesh.group) == "gloo":
            merged = tuple(t.cpu() for t in merged)
        for t in merged:
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.mesh.group)
        return merged

    def extend_async(self, enc, loc, plane, row) -> List[_Wave]:
        """Split the candidates over dp, then launch each slice's waves on
        every local shard of its row.  With a process-spanning mesh the
        merge is a collective, so every process must make the same calls
        on the same candidates."""
        t0 = time.time()
        C = loc.shape[0]
        per = -(-C // self.n_dp)
        waves = []
        for i in range(self.n_dp):
            sl = slice(i * per, min(C, (i + 1) * per))
            for blob, c, U, E in self.wave_blobs(enc, loc[sl], plane[sl],
                                                 row[sl]):
                self.up_waves += 1
                self.up_cand_max = max(self.up_cand_max, c)
                merged, keep = self._launch_row(i, blob, enc.W, c, U, E)
                if self.mesh.group is not None:
                    merged = self._merge_processes(merged)
                self.down_bytes += sum(t.numel() * t.element_size()
                                       for t in merged)
                waves.append(download(c, merged, t0, tuple(keep)))
        return waves


def auto_mesh_shape(n_devices: int, ref_words: int,
                    hbm_bytes: int = 16 << 30):
    """Pick (n_dp, n_rs): shard the reference over rs only when the packed
    planes (2 x 4 bytes x words, x2 working headroom) exceed one device's
    memory budget; otherwise pure data parallelism."""
    plane_bytes = 2 * 4 * ref_words * 2
    n_rs = 1
    while plane_bytes // n_rs > hbm_bytes and n_rs < n_devices:
        n_rs *= 2
    n_dp = max(n_devices // n_rs, 1)
    return n_dp, n_rs


def mesh_devices(device: torch.device) -> List[torch.device]:
    """The cards a mesh may span for an aligner on ``device``: every
    visible card for a bare ``cuda``; none for a card named by index (a
    multi-process worker keeps to its own) or for the CPU."""
    if device.type != "cuda" or device.index is not None:
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_sharded_context(ref: PackedReference, params: AlignParams,
                         devices=None):
    """A ShardedTorchDeviceContext over ``devices`` (default: every
    visible card), or None.  ``BASAL_TPU_MESH`` overrides: "0" disables,
    "DPxRS" forces a shape.  None also when the shape needs fewer than 2 or
    more devices than given: the caller then takes the single context."""
    devices = list(devices if devices is not None
                   else mesh_devices(torch.device("cuda")))
    spec = os.environ.get("BASAL_TPU_MESH", "")
    if spec == "0":
        return None
    if "x" in spec:
        n_dp, n_rs = (int(t) for t in spec.split("x"))
    else:
        kw = {}
        if devices and devices[0].type == "cuda":
            kw["hbm_bytes"] = min(torch.cuda.get_device_properties(d)
                                  .total_memory for d in devices)
        n_dp, n_rs = auto_mesh_shape(len(devices), ref.ref32.shape[1], **kw)
    if n_dp * n_rs < 2 or n_dp * n_rs > len(devices):
        return None
    mesh = make_mesh(n_dp, n_rs, devices[:n_dp * n_rs])
    return ShardedTorchDeviceContext(ref, params, mesh)
