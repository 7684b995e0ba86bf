"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``basal_tpu_torch/csrc/*.cu`` (one process per
source, all started together) and links them into one shared library with
a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``build/basal_tpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the flags, so a changed source
is rebuilt and an unchanged one is loaded as it is.  ``ptxas -v``'s report
of each kernel's registers, shared memory, stack frame and spills is kept
beside the library (``resource_report``).  Nothing is built or imported
when this module is imported: only the machine with the card has ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .. import trace

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "basal_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libbasal_tpu_torch_kernels.so"
REPORT_NAME = "ptxas.log"

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (PATH or CUDA_HOME)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run_all(cmds) -> str:
    """Run the commands side by side; wait for every one, then raise with
    the output of the first that failed.  Returns their output, joined."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    outs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [so.with_name(f".{s.stem}.{tag}.o") for s in srcs]
    tmp = so.with_name(f".{so.name}.{tag}")
    tmp_report = so.with_name(f".{REPORT_NAME}.{tag}")
    try:
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                           for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        tmp_report.write_text(report)
        os.replace(tmp_report, so.with_name(REPORT_NAME))
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for f in objs + [tmp, tmp_report]:
            f.unlink(missing_ok=True)


def resource_report() -> str:
    """``ptxas -v``'s output for the current sources, from their build."""
    return library_path().with_name(REPORT_NAME).read_text()


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with trace.span("kernels.load"):
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bt_count_blob.argtypes = [p, i, p, p, i, i, i, i, i, p]
        lib.bt_count_blob.restype = i
        lib.bt_gap_blob.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
        lib.bt_gap_blob.restype = i
        i64 = ctypes.c_int64
        lib.bt_index_seeds.argtypes = [p, p, p, p, i, i, i64, i64, i, i, p,
                                       p, p, p, i64, p]
        lib.bt_index_seeds.restype = i
        lib.bt_index_temp_bytes.argtypes = [i64, i64, i]
        lib.bt_index_temp_bytes.restype = i64
        lib.bt_index_sort.argtypes = [p, p, p, p, i64, i, p, p, i64, p, i64,
                                      p]
        lib.bt_index_sort.restype = i
        _lib = lib
        return lib
