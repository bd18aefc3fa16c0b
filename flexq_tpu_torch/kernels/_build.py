"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``flexq_tpu_torch/build/lib<name>-<hash>.so`` (the hash is of the
source together with every ``csrc/*.cuh`` header and the nvcc flags, so an
edited source or header never loads a stale library):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

``build_all()`` starts one nvcc per source at once and waits for all of
them, so a cold start pays the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("row_quant", "w6ax_matmul", "attend_cache", "wa16_matmul", "flash_prefill", "flash_decode")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")
    return path


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        h.update(fname.encode())
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (final path, temp path, process or None)."""
    out = lib_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return out, tmp, proc


def _finish(name: str, out: str, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every listed source in parallel (no-op for built ones)."""
    started = [(n, *_start(n)) for n in names]
    for n, out, tmp, proc in started:
        _finish(n, out, tmp, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out, tmp, proc = _start(name)
        _finish(name, out, tmp, proc)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> Callable:
    """C function ``symbol`` of csrc/<name>.cu with its argument types set
    (c_void_p for every pointer and the stream, so none is cut to 32 bits)
    and an int return: the cudaGetLastError() code after the launch."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
