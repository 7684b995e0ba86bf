"""Count and gap cores on the card: the wrappers of the CUDA kernels.

Both take the reference words and one wave blob (layout:
``ops.extend.carve_blob``).  On CUDA tensors they launch their kernel on the
current stream and never fall back: a build or launch failure raises.  On
CPU tensors they run the plain version, ``ops.extend.extend_kernel_blob``.

- ``extend_counts_blob`` returns u8 mismatch counts through
  ``csrc/count_kernel.cu``.  It replaces the TPU path
  ``extend_counts_pallas_blob`` -> ``carve_blob`` + XLA gather
  (``_counts_core``) -> Pallas ``_count_kernel`` of
  ``basal_tpu/ops/extend_pallas.py``.
- ``extend_gap_blob`` returns the counts and the pos0 / pos1 mismatch
  position lists of the gapped scan through ``csrc/gap_kernel.cu``.  It
  replaces ``extend_gap_pallas_blob`` -> ``carve_blob`` + XLA gather
  (``_gap_core``) -> Pallas ``_gap_kernel`` + ``_positions_block``.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .extend import K_POS, MODES, extend_kernel_blob

_MODE_IDS = {m: i for i, m in enumerate(MODES)}  # matches both kernels
MAX_W = 30  # words of a 480-base read: gap_kernel.cu's largest window
_count_lock = threading.Lock()


def blob_words(mode: str, W: int, C: int, U: int, E: int) -> int:
    """int32 words of a wave blob with these shapes."""
    n_planes = 2 if mode == "multiway" else 1
    return C + 2 * U + 1 + n_planes * U * W + E * W


def _check(ref32: torch.Tensor, blob: torch.Tensor, mode: str, W: int,
           nw: int, C: int, U: int, E: int) -> None:
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown rule mode {mode!r}")
    for name, t in (("ref32", ref32), ("blob", blob)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if ref32.device != blob.device:
        raise ValueError(f"ref32 on {ref32.device} but blob on {blob.device}")
    if ref32.numel() != 2 * nw or ref32.numel() >= 1 << 31:
        raise ValueError(f"ref32 holds {ref32.numel()} words, want 2*nw = "
                         f"{2 * nw} (< 2**31)")
    if C < 0 or W < 1 or E < 1 or (C > 0 and U < 1):
        raise ValueError(f"bad wave shape C={C} U={U} E={E} W={W}")
    want = blob_words(mode, W, C, U, E)
    if blob.numel() != want:
        raise ValueError(f"blob holds {blob.numel()} words, want {want} for "
                         f"mode={mode} C={C} U={U} E={E} W={W}")


def extend_counts_blob(ref32: torch.Tensor, blob: torch.Tensor, *, mode: str,
                       W: int, nw: int, C: int, U: int,
                       E: int) -> torch.Tensor:
    """u8 [C] mismatch counts of one wave (see module docstring)."""
    _check(ref32, blob, mode, W, nw, C, U, E)
    dev = blob.device
    if dev.type == "cpu":
        return extend_kernel_blob(ref32, blob, mode=mode, W=W, nw=nw, C=C,
                                  U=U, E=E)
    if dev.type != "cuda":
        raise ValueError(f"no count kernel for device {dev}")
    out = torch.empty(C, dtype=torch.uint8, device=dev)
    if C == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bt_count_blob(ref32.data_ptr(), ref32.numel(),
                                blob.data_ptr(), out.data_ptr(), C, U, W, nw,
                                _MODE_IDS[mode], stream)
    if err != 0:
        raise RuntimeError(f"count kernel launch failed: cudaError {err}")
    with _count_lock:
        extend_counts_blob.launches += 1
    return out


#: kernel launches made by extend_counts_blob (CPU calls are not counted)
extend_counts_blob.launches = 0


def extend_gap_blob(ref32: torch.Tensor, blob: torch.Tensor, *, mode: str,
                    gap: int, W: int, nw: int, C: int, U: int, E: int):
    """(counts u8 [C], pos0 i16 [C, K_POS], pos1 i16 [C, 2*gap, K_POS]) of
    one gapped wave (see module docstring)."""
    _check(ref32, blob, mode, W, nw, C, U, E)
    if not 1 <= gap <= 3 or W > MAX_W:
        raise ValueError(f"bad gapped wave shape gap={gap} W={W} (want gap "
                         f"1..3, W <= {MAX_W})")
    dev = blob.device
    if dev.type == "cpu":
        return extend_kernel_blob(ref32, blob, mode=mode, W=W, nw=nw, C=C,
                                  U=U, E=E, gap=gap)
    if dev.type != "cuda":
        raise ValueError(f"no gap kernel for device {dev}")
    cnt = torch.empty(C, dtype=torch.uint8, device=dev)
    pos0 = torch.empty((C, K_POS), dtype=torch.int16, device=dev)
    pos1 = torch.empty((C, 2 * gap, K_POS), dtype=torch.int16, device=dev)
    if C == 0:
        return cnt, pos0, pos1
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bt_gap_blob(ref32.data_ptr(), ref32.numel(),
                              blob.data_ptr(), cnt.data_ptr(),
                              pos0.data_ptr(), pos1.data_ptr(), C, U, W, nw,
                              gap, _MODE_IDS[mode], stream)
    if err != 0:
        raise RuntimeError(f"gap kernel launch failed: cudaError {err}")
    with _count_lock:
        extend_gap_blob.launches += 1
    return cnt, pos0, pos1


#: kernel launches made by extend_gap_blob (CPU calls are not counted)
extend_gap_blob.launches = 0
