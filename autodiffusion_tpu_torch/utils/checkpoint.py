"""Checkpoints: the port's ``.pt`` files, and the JAX package's msgpack
trees read without flax or msgpack.

Port of autodiffusion_tpu/utils/checkpoint.py. The port writes
guided-diffusion's own files (train_util.py:252-275): ``model{step:06d}.pt``
and ``ema_{rate}_{step:06d}.pt`` (state dicts under the module's parameter
names, so they load with ``load_state_dict`` in the port and through
``load_torch_state_dict`` + ``convert_unet`` in the JAX package) and
``opt{step:06d}.pt`` (the optimizer's state dict), each written to a
temporary file and moved into place.

:func:`load_msgpack` decodes what ``flax.serialization.to_bytes`` writes
(``adt train``'s ``model*.msgpack`` / ``ema_*.msgpack``) in pure Python and
numpy: the msgpack subset flax emits (maps, arrays, strings, ints, floats,
bools, nil, binary), ext type 1 (an ndarray: msgpack of shape, dtype name
and bytes), ext type 3 (a numpy scalar) and the
``__msgpack_chunked_array__`` form of arrays over 2^30 bytes. Anything
else raises :class:`MsgpackDecodeError`. bfloat16 arrays come back as
float32.

:func:`save_msgpack` writes what the JAX package's ``save_tree`` (flax's
``to_bytes`` of the device-fetched tree) writes, byte for byte: nested
string-keyed maps of numpy arrays and scalars, arrays over
``MAX_CHUNK_SIZE`` bytes chunked as flax chunks them. So ``load_tree``
reads what the port writes.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "MsgpackDecodeError",
           "load_msgpack", "msgpack_bytes", "save_msgpack",
           "flax_state_dict", "state_dict_from_flax_tree",
           "parse_step_from_filename", "find_latest_checkpoint"]


def save_checkpoint(path: str, obj: Any) -> None:
    """torch.save ``obj`` to ``path`` through a temporary file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    """A ``.pt`` file's object on the CPU (tensors and plain containers)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class MsgpackDecodeError(ValueError):
    """The bytes are not a flax msgpack tree this reader decodes."""


_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(data: memoryview) -> np.ndarray:
    fields = _Reader(data).document()
    if not (isinstance(fields, list) and len(fields) == 3):
        raise MsgpackDecodeError("an ndarray ext is not (shape, dtype, bytes)")
    shape, name, buf = fields
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise MsgpackDecodeError(f"unknown array dtype {name!r}") from e
        arr = np.frombuffer(buf, dtype=dtype)
    return arr.reshape(shape)


class _Reader:
    """A msgpack decoder over a buffer (the subset flax writes)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def document(self) -> Any:
        obj = self.obj()
        if self.pos != len(self.buf):
            raise MsgpackDecodeError(
                f"{len(self.buf) - self.pos} trailing bytes after the object")
        return obj

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackDecodeError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.sint(1)
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise MsgpackDecodeError(f"msgpack ext type {code} is not one flax "
                                 "writes for arrays")

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:                      # bin 8 / 16 / 32
            return self.take(self.uint(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:                      # ext 8 / 16 / 32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:                      # uint 8 - 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                      # int 8 - 64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:                      # fixext 1 - 16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                      # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                      # array 16 / 32
            return [self.obj() for _ in range(self.uint(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):                      # map 16 / 32
            return self.map(self.uint(2 << (b - 0xDE)))
        raise MsgpackDecodeError(f"byte 0x{b:02x} at offset {self.pos - 1} "
                                 "starts no msgpack object")


def _unchunk(tree: Any) -> Any:
    """Join flax's ``__msgpack_chunked_array__`` leaves back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path: str) -> Any:
    """The tree of a flax msgpack file: nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _unchunk(_Reader(data).document())
    except MsgpackDecodeError as e:
        raise MsgpackDecodeError(f"{path}: not a flax msgpack tree: {e}") \
            from None


# flax's limit on one array's bytes before it chunks it (flax/
# serialization.py MAX_CHUNK_SIZE)
MAX_CHUNK_SIZE = 2 ** 30


class _Writer:
    """A msgpack encoder choosing the forms msgpack-python's packer
    chooses (``use_bin_type=True``), as flax calls it. The encoding is a
    list of pieces: small ones gathered in ``out``, each array's bytes a
    view of the array itself, so a large tree is written without being
    copied into one buffer."""

    def __init__(self):
        self.pieces = []
        self.out = bytearray()

    def finish(self) -> list:
        if self.out:
            self.pieces.append(bytes(self.out))
            self.out = bytearray()
        return self.pieces

    def head(self, n: int, fix: int, fix_max: int, wide: Tuple[int, ...]):
        """A length header: the fix form up to ``fix_max``, else the first
        of the 1-, 2- or 4-byte forms (``wide`` their type bytes, ``None``
        where the form does not exist) that holds ``n``."""
        if n <= fix_max:
            self.out.append(fix | n)
            return
        for code, size in zip(wide, (1, 2, 4)):
            if code is not None and n < 1 << (8 * size):
                self.out.append(code)
                self.out += n.to_bytes(size, "big")
                return
        raise ValueError(f"msgpack length {n} over 2^32 - 1")

    def int(self, v: int) -> None:
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.out += struct.pack("b" if v < 0 else "B", v)
            return
        for size, (ucode, scode) in zip((1, 2, 4, 8), ((0xCC, 0xD0),
                                                       (0xCD, 0xD1),
                                                       (0xCE, 0xD2),
                                                       (0xCF, 0xD3))):
            if 0 <= v < 1 << (8 * size):
                self.out.append(ucode)
                self.out += v.to_bytes(size, "big")
                return
            if -(1 << (8 * size - 1)) <= v < 0:
                self.out.append(scode)
                self.out += v.to_bytes(size, "big", signed=True)
                return
        raise ValueError(f"integer {v} does not fit in 64 bits")

    def bin_head(self, n: int) -> None:
        self.head(n, 0, -1, (0xC4, 0xC5, 0xC6))

    def str(self, s: str) -> None:
        b = s.encode("utf-8")
        self.head(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        self.out += b

    def ext_head(self, code: int, n: int) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(fixed[n])
        else:
            self.head(n, 0, -1, (0xC7, 0xC8, 0xC9))
        self.out += struct.pack("b", code)

    def array(self, code: int, arr: np.ndarray) -> None:
        """An ndarray ext (flax's ``_ndarray_to_bytes``: msgpack of
        (shape, dtype name, C-order bytes)) with the bytes as a view."""
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise TypeError("object and structured dtypes have no flax "
                            "msgpack form")
        # (ascontiguousarray makes a 0-d array 1-d: the shape is taken
        # first)
        data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        inner = _Writer()
        inner.head(3, 0x90, 0x0F, (None, 0xDC, 0xDD))
        inner.obj(list(arr.shape))
        inner.str(arr.dtype.name)
        inner.bin_head(data.size)
        lead = bytes(inner.out)
        self.ext_head(code, len(lead) + data.size)
        self.out += lead
        self.finish()
        self.pieces.append(memoryview(data))

    def obj(self, v: Any) -> None:
        if v is None:
            self.out.append(0xC0)
        elif isinstance(v, bool):
            self.out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, float):
            self.out.append(0xCB)
            self.out += struct.pack(">d", v)
        elif isinstance(v, str):
            self.str(v)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            self.bin_head(len(v))
            self.out += v
        elif isinstance(v, dict):
            self.head(len(v), 0x80, 0x0F, (None, 0xDE, 0xDF))
            for k, item in v.items():
                self.str(str(k))
                self.obj(item)
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 0x0F, (None, 0xDC, 0xDD))
            for item in v:
                self.obj(item)
        elif isinstance(v, np.ndarray):
            self.array(_EXT_NDARRAY, v)
        else:
            raise TypeError(f"cannot write a {type(v).__name__} as flax "
                            "msgpack")


def _chunked(tree: Any) -> Any:
    """The tree as the JAX package's ``save_tree`` serializes it: every
    dict's keys sorted and numpy scalars as 0-d arrays (``jax.device_get``
    maps the tree through ``jax.tree_util``, which orders a dict's keys),
    lists and tuples as maps of their indices in order (flax's
    ``to_state_dict``), then arrays over MAX_CHUNK_SIZE bytes in flax's
    chunked form (maps only, as flax descends them)."""
    if isinstance(tree, np.generic):
        tree = np.asarray(tree)
    if isinstance(tree, np.ndarray):
        if tree.nbytes <= MAX_CHUNK_SIZE:
            return tree
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): flat[j:j + size] for i, j in
                           enumerate(range(0, flat.size, size))}}
    if isinstance(tree, (list, tuple)):
        return {str(i): _chunked(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): _chunked(tree[k]) for k in sorted(tree)}
    return tree


def _pieces(tree: Any) -> list:
    w = _Writer()
    w.obj(_chunked(tree))
    return w.finish()


def msgpack_bytes(tree: Any) -> bytes:
    """``tree`` (nested string-keyed dicts of numpy arrays and scalars) as
    the JAX package's ``save_tree`` encodes it."""
    return b"".join(_pieces(tree))


def save_msgpack(path: str, tree: Any) -> None:
    """Write ``tree`` as a flax msgpack file through a temporary file (the
    JAX package's ``save_tree``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in _pieces(tree):
            f.write(piece)
    os.replace(tmp, path)


def state_dict_from_flax_tree(tree: Any, module: torch.nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """A JAX UNet or classifier param tree (nested dicts of numpy arrays)
    as the state dict of ``module`` (the port's UNet or classifier)."""
    from ..models.convert import (classifier_state_dict_from_flax,
                                  unet_state_dict_from_flax)
    from ..models.unet import EncoderUNetModel

    if isinstance(module, EncoderUNetModel):
        return classifier_state_dict_from_flax(tree)
    return unet_state_dict_from_flax(tree)


def flax_state_dict(path: str, module: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A JAX ``model*.msgpack`` / ``ema_*.msgpack`` param tree as the state
    dict of ``module`` (the port's UNet or classifier)."""
    return state_dict_from_flax_tree(load_msgpack(path), module)


def parse_step_from_filename(name: str) -> int:
    """model123456.pt / ema_0.9999_123456.msgpack -> 123456
    (train_util.py:780-792); 0 where the name carries no step."""
    m = re.search(r"(\d+)\.(msgpack|pt)$", name)
    return int(m.group(1)) if m else 0


def find_latest_checkpoint(dir: str, prefix: str = "model"
                           ) -> Optional[Tuple[str, int]]:
    """(path, step) of the ``prefix*.pt`` or ``prefix*.msgpack`` file with
    the highest step in ``dir`` (at one step the port's ``.pt`` wins), or
    None."""
    if not os.path.isdir(dir):
        return None
    best = None
    for name in sorted(os.listdir(dir)):
        if name.startswith(prefix) and name.endswith((".pt", ".msgpack")):
            key = (parse_step_from_filename(name), name.endswith(".pt"))
            if best is None or key > best[0]:
                best = (key, os.path.join(dir, name))
    return None if best is None else (best[1], best[0][0])
