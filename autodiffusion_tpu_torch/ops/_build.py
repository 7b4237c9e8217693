"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file is a plain C interface around its kernels (no
PyTorch headers, so a file builds in seconds), compiled for Hopper
(``sm_90a``) into its own shared library under ``ops/_build/``. The
libraries are named by a hash of their sources and flags, so an edited
source is rebuilt and an unchanged one is reused within a checkout. All
sources build in parallel, one ``nvcc`` process each. Nothing is built at
import time: the first kernel launch (or an explicit :func:`build_all`)
builds. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

__all__ = ["build_all", "library", "launch", "last_build_seconds",
           "ptxas_report", "LAUNCHES", "reset_launch_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# source stem -> (exported C function, its argtypes); the last argument of
# every function is the CUDA stream
SOURCES = {
    "flash_fwd": ("adt_flash_fwd",
                  [_c_void_p] * 5 + [_c_int] * 5 + [_c_float, _c_void_p]),
    "flash_fwd_packed": ("adt_flash_fwd_packed",
                         [_c_void_p] * 5 + [_c_int] * 7 + [_c_float,
                                                           _c_void_p]),
    "flash_fwd_wide": ("adt_flash_fwd_wide",
                       [_c_void_p] * 5 + [_c_int] * 5 + [_c_float, _c_void_p]),
    "flash_bwd_dq": ("adt_flash_bwd_dq",
                     [_c_void_p] * 7 + [_c_int] * 5 + [_c_float, _c_void_p]),
    "flash_bwd_dkv": ("adt_flash_bwd_dkv",
                      [_c_void_p] * 8 + [_c_int] * 5 + [_c_float, _c_void_p]),
    "group_norm_fwd": ("adt_group_norm_fwd",
                       [_c_void_p] * 8 + [_c_int] * 6 + [_c_float,
                                                         _c_void_p]),
    "group_norm_bwd": ("adt_group_norm_bwd",
                       [_c_void_p] * 15 + [_c_int] * 6 + [_c_void_p]),
    "conv3x3": ("adt_conv3x3", [_c_void_p] * 4 + [_c_int] * 6 + [_c_void_p]),
    "conv3x3_fused": ("adt_conv3x3_fused",
                      [_c_void_p] * 7 + [_c_int] * 6 + [_c_void_p]),
}

# kernel (source stem) -> launches since the last reset: a wrapper adds one
# where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {stem: 0 for stem in SOURCES}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_seconds: Optional[float] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def _flags() -> list:
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]


def _digest(stem: str, flags: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cuh") or name == stem + ".cu":
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (or reuse) every kernel library and load it. Returns
    {source stem: CDLL}. Thread-safe; builds once per process."""
    global _build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.time()
        os.makedirs(BUILD_DIR, exist_ok=True)
        flags = _flags()
        nvcc = None
        procs = {}
        paths = {}
        for stem in SOURCES:
            so = os.path.join(BUILD_DIR, f"{stem}-{_digest(stem, flags)}.so")
            paths[stem] = so
            if os.path.exists(so):
                continue
            nvcc = nvcc or _nvcc()
            tmp = f"{so}.{os.getpid()}.tmp"
            log = open(os.path.join(BUILD_DIR, f"{stem}.log"), "w")
            cmd = [nvcc, *flags, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
            procs[stem] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for stem, (proc, tmp, log) in procs.items():
            proc.wait()
            log.close()
            if proc.returncode != 0:
                failed.append(stem)
            else:
                os.replace(tmp, paths[stem])
        if failed:
            msgs = []
            for stem in failed:
                with open(os.path.join(BUILD_DIR, f"{stem}.log")) as f:
                    msgs.append(f"--- {stem}.cu ---\n{f.read()[-4000:]}")
            raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
        for stem, (fn_name, argtypes) in SOURCES.items():
            lib = ctypes.CDLL(paths[stem])
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[stem] = lib
        _build_seconds = time.time() - t0
        return _libs


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(stem: str, *args) -> None:
    """Call ``stem``'s C entry point with ``args`` on PyTorch's current
    stream, raise if it reports a CUDA error (or -1, a configuration it
    has no kernel for), and count the launch."""
    fn = getattr(library(stem), SOURCES[stem][0])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{stem} kernel launch failed with CUDA error "
                           f"{rc}" + (" (no kernel for this configuration)"
                                      if rc == -1 else ""))
    LAUNCHES[stem] += 1


def last_build_seconds() -> Optional[float]:
    """Wall time of this process's build_all (None before the first)."""
    return _build_seconds


def ptxas_report() -> str:
    """The register / shared-memory / spill lines nvcc's ptxas printed for
    the kernels built in this checkout (empty when every library was
    reused from an earlier build)."""
    out = []
    for stem in SOURCES:
        path = os.path.join(BUILD_DIR, f"{stem}.log")
        if os.path.exists(path):
            with open(path) as f:
                out += [f"{stem}: {line.strip()}" for line in f
                        if "registers" in line or "spill" in line]
    return "\n".join(out)
