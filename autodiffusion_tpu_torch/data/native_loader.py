"""ctypes binding of the framework-free C++ data runtime
(native/adt_data.cpp).

Port of autodiffusion_tpu/data/native_loader.py: a prefetching,
multithreaded batch loader over uint8 [N, H, W, C] ``.npy`` arrays, the
bulk path that feeds training (the reference uses torch DataLoader
workers, image_datasets.py:16-92). The shared library is built from the
repository's ``native/adt_data.cpp`` with ``g++`` at first use, into
``autodiffusion_tpu_torch/ops/_build/`` (named by a hash of the source and
flags); ``native/`` itself is only read. The same seed gives the same
batches as the JAX package's ``NativeNpyLoader``: both drive the same C++
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["NativeNpyLoader", "build_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.normpath(os.path.join(_HERE, "..", "..", "native",
                                        "adt_data.cpp"))
_BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "ops", "_build"))
# native/Makefile's flags but -march=native: x86-64 with FMA, which
# contracts the pixel scaling x / 127.5 - 1 into one rounding as the
# Makefile's native build does on any FMA machine, so both libraries give
# the same floats, and the library runs on any such machine
_FLAGS = ["-O3", "-mfma", "-fPIC", "-std=c++17", "-Wall", "-shared",
          "-pthread"]
_LIB = None
_lock = threading.Lock()


def build_native() -> str:
    """Build the loader library with g++ (once per source and flags);
    returns its path. A failed build raises with the compiler's output."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"adt_data-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *_FLAGS, _SOURCE, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SOURCE}:\n{res.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build_native())
        lib.adt_npy_open.restype = ctypes.c_void_p
        lib.adt_npy_open.argtypes = [ctypes.c_char_p]
        lib.adt_npy_ndim.restype = ctypes.c_int
        lib.adt_npy_ndim.argtypes = [ctypes.c_void_p]
        lib.adt_npy_shape.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.adt_npy_close.argtypes = [ctypes.c_void_p]
        lib.adt_loader_create.restype = ctypes.c_void_p
        lib.adt_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int]
        lib.adt_loader_next.restype = ctypes.c_int
        lib.adt_loader_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.adt_loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeNpyLoader:
    """Infinite iterator of {"x": [B,h,w,C] f32 in [-1,1], "y": [B] i64?}.

    images_npy: uint8 [N,H,W,C] .npy file; labels_npy: optional integer [N].
    crop: center-crop size (0 = full frame).
    """

    def __init__(self, images_npy: str, labels_npy: Optional[str] = None, *,
                 batch_size: int, crop: int = 0, random_flip: bool = True,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4):
        lib = _load_lib()
        self._lib = lib
        # Initialise handle slots before any call that can raise so that
        # close() is always safe and the mmapped npy handles never leak on
        # a failed construction.
        self._img = None
        self._lbl = None
        self._loader = None
        self._closed = False
        try:
            self._img = lib.adt_npy_open(images_npy.encode())
            if not self._img:
                self._img = None
                raise FileNotFoundError(f"cannot mmap npy: {images_npy}")
            nd = lib.adt_npy_ndim(self._img)
            dims = (ctypes.c_int64 * nd)()
            lib.adt_npy_shape(self._img, dims)
            self.shape = tuple(dims[i] for i in range(nd))
            assert nd == 4, \
                f"expected uint8 [N,H,W,C] array, got shape {self.shape}"
            if labels_npy:
                self._lbl = lib.adt_npy_open(labels_npy.encode())
                if not self._lbl:
                    self._lbl = None
                    raise FileNotFoundError(f"cannot mmap npy: {labels_npy}")
                # the C fill_batch indexes labels->data + idx*itemsize for
                # idx in [0, N): a short labels array would be read past
                # its mmap (garbage labels or SIGSEGV in a worker thread)
                lnd = lib.adt_npy_ndim(self._lbl)
                ldims = (ctypes.c_int64 * lnd)()
                lib.adt_npy_shape(self._lbl, ldims)
                lshape = tuple(ldims[i] for i in range(lnd))
                if lnd != 1 or lshape[0] != self.shape[0]:
                    raise ValueError(
                        f"labels npy must be 1-D with one entry per image: "
                        f"images {self.shape[0]}, labels shape {lshape}")
            self.batch_size = batch_size
            self.out_hw = (crop or self.shape[1], crop or self.shape[2])
            self._loader = lib.adt_loader_create(
                self._img, self._lbl, batch_size, crop, int(random_flip),
                int(shuffle), seed, num_workers, prefetch)
            if not self._loader:
                self._loader = None
                raise ValueError(
                    f"invalid loader config: need uint8 [N,H,W,C] with "
                    f"batch_size <= N and crop <= H,W (got shape {self.shape}, "
                    f"batch_size {batch_size}, crop {crop})")
        except Exception:
            self.close()
            raise

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.batch_size
        h, w = self.out_hw
        c = self.shape[3]
        x = np.empty((b, h, w, c), np.float32)
        y = np.empty((b,), np.int64) if self._lbl else None
        self._lib.adt_loader_next(
            self._loader, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if y is not None
            else None)
        out = {"x": x}
        if y is not None:
            out["y"] = y
        return out

    def close(self) -> None:
        if not self._closed:
            if self._loader:
                self._lib.adt_loader_destroy(self._loader)
            if self._img:
                self._lib.adt_npy_close(self._img)
            if self._lbl:
                self._lib.adt_npy_close(self._lbl)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
