"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. Libraries go to
`build/kernels/<hash>/` beside the package (listed in .gitignore), keyed by a
hash of every source and of the flags, and are built at first use: all
sources at once, one nvcc process each. Nothing here runs at import time.
`wanted` is the rule that picks a layer's kernel or its plain composition.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# one library per kernel source
SOURCES = ("fused_block", "fused_attention", "fused_block_bwd",
           "fused_attention_bwd", "res_norm")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of the build of each source (ptxas: registers, shared memory
# and spills of every kernel), kept as lib<name>.log beside the library and
# read back when the library was built by an earlier process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds spent.
    Raises with nvcc's output if any compile fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    for name in SOURCES:
        log_file = out_dir / f"lib{name}.log"
        if name not in todo and log_file.exists():
            BUILD_LOG[name] = log_file.read_text()
    if not todo:
        return 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            BUILD_LOG[name] = log
            (out_dir / f"lib{name}.log").write_text(log)
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it first if
    needed. The caller declares argtypes/restype once per handle."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def wanted(x, impl: str, spatial=None) -> bool:
    """Whether a layer with a kernel (Swin block, res block norms) runs it on
    x: never under attention_impl "plain" or on a space axis (`spatial`: the
    kernels take whole grids), always under "kernel" (a wrapper's CPU branch
    is the kernel's plain version), under "auto" on a CUDA tensor."""
    if impl == "plain" or spatial is not None:
        return False
    return impl == "kernel" or x.is_cuda


def gemm_operand(t, dtype, name: str):
    """`t` in `dtype`, contiguous, checked to be 16-byte aligned (the
    kernels' GEMMs load 16 bytes per thread)."""
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the kernel")
    return t


def int_array(values):
    """A C int array of `values` (a kernel's dimensions)."""
    return (ctypes.c_int * len(values))(*values)


def ptr_array(tensors):
    """A C array of the tensors' device pointers, in order."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
