"""Builds the CUDA sources of ``csrc/`` into one shared library at first use
and loads it with ``ctypes``.

Each ``*.cu`` file compiles to an object with its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects link into
``build/kernels/libreprotorch_<hash>.so`` at the repository root (override
with ``REPRO_TORCH_BUILD_DIR``).  The hash covers the sources and flags, so
an edited source rebuilds and a warm checkout loads without compiling.
Nothing here runs at import time: the CPU-only test suite imports every
module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's output of the last build in this process (ptxas register and
#: shared-memory report per kernel); empty when the library was cached
build_log = ""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                           "built from source at first use and need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless a build of the same sources
    exists; returns its path.  Raises with nvcc's output on failure."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_so)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {so.name} failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)       # atomic: concurrent builds race safely
    build_log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    bind_seg_reduce(lib)
    bind_covar_xtx(lib)
    bind_flash_attention(lib)
    return lib


def bind_flash_attention(lib: ctypes.CDLL) -> None:
    """q, k, v, o, the 12 strides, bf16?, B, H, H_kv, S_q, S_k, D_q, D_v,
    causal, window, stream."""
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.flash_attention.argtypes = [P, P, P, P, ctypes.POINTER(I64), I, I, I,
                                    I, I64, I64, I, I, I, I64, P]
    lib.flash_attention.restype = I


def bind_seg_reduce(lib: ctypes.CDLL) -> None:
    """The four scan entry points of ``seg_reduce.cuh``, each (items, srcs,
    n, grid, n_grids, combine_blocks, scratch, out, stream), and its
    occupancy query."""
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.seg_aggregate, lib.fused_scan_block, lib.tree_hist,
               lib.tree_hist_batched):
        fn.argtypes = [P, P, I64, ctypes.POINTER(I64), I, I64, P, P, P]
        fn.restype = I
    lib.seg_reduce_blocks_per_sm.argtypes = [I, I]
    lib.seg_reduce_blocks_per_sm.restype = I


def bind_covar_xtx(lib: ctypes.CDLL) -> None:
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # x, w, n, f, chunk_rows, n_chunks, stages, rows, smem, scratch, out,
    # stream
    lib.covar_xtx.argtypes = [P, P, I64, I, I64, I, I, I, I, P, P, P]
    lib.covar_xtx_blocks_per_sm.argtypes = [I, I, I]
    for fn in (lib.covar_xtx, lib.covar_xtx_blocks_per_sm):
        fn.restype = I
