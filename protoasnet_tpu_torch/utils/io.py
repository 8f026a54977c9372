"""Pickle and checkpoint IO.

The port's own checkpoint is a ``torch.save`` of a dict (model state,
optimiser, accumulator, scheduler, epoch, iteration, best metric), written
atomically. Two formats of the JAX package are read too, without JAX:

* ``read_flax_checkpoint``: a ``.ckpt`` the JAX package writes with
  ``flax.serialization.to_bytes`` (msgpack, arrays as flax's ext types);
  this module carries its own msgpack decoder, and returns what
  ``flax.serialization.msgpack_restore`` returns, leaf for leaf and bit for
  bit, except that a bfloat16 array (which numpy lacks) comes back as a
  ``torch.bfloat16`` tensor;
* ``load_migrated_pickle``: the pickle of a reference checkpoint migrated
  by the JAX package (``{epoch, iteration, params, batch_stats}`` of numpy
  arrays), read through an unpickler that builds numpy arrays, dtypes and
  builtin containers only.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["save_pickle", "load_pickle", "save_checkpoint",
           "load_checkpoint", "read_flax_checkpoint", "load_migrated_pickle",
           "checkpoint_format"]


def save_pickle(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    """Unpickle a file this program wrote (pickles can run code: never
    load one from elsewhere)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(state: Dict[str, Any], path: str) -> None:
    """``torch.save`` of ``state`` to ``path`` through a temporary file and
    a rename, so a reader never sees a partial checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint written by ``save_checkpoint`` (tensors, numbers,
    strings, lists and dicts only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def checkpoint_format(path: str) -> str:
    """"migrated" for a ``.pkl``/``.pickle`` (by suffix: a pickle's first
    byte, 0x80, is also an empty msgpack map), else by content: "torch" for
    a zip (``torch.save``), "flax" for a msgpack map (the JAX package's
    ``.ckpt``). Anything else raises."""
    if path.endswith((".pkl", ".pickle")):
        return "migrated"
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "flax"
    raise ValueError(f"{path}: neither a torch.save zip nor a flax msgpack "
                     f"checkpoint (starts with {head!r})")


# ---------------- flax msgpack ----------------

_FIXED = {  # first byte -> (struct format, size) of fixed-width numbers
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# first byte -> width of the length field: str, bin, array, map, ext
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax's ext type codes
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    """One msgpack document from ``buf``. ``raw``: str stays bytes (flax
    decodes an ndarray's own tuple that way). Map keys must be str or
    bytes; errors name the byte offset."""

    def __init__(self, buf, raw: bool, ext: Callable[[int, bytes, int], Any],
                 base: int = 0):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw
        self.ext = ext
        self.base = base  # offset of buf in the file, for messages

    def fail(self, msg: str, at: int):
        raise ValueError(f"flax checkpoint: {msg} at byte {self.base + at}")

    def take(self, n: int, at: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail(f"truncated ({n} bytes wanted)", at)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, width: int, at: int) -> int:
        return struct.unpack(_LEN[width], self.take(width, at))[0]

    def document(self) -> Any:
        out = self.value()
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} bytes after the document",
                      self.pos)
        return out

    def value(self) -> Any:
        at = self.pos
        b = self.take(1, at)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.mapping(b & 0x0F, at)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.string(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n, at))[0]
        if b in _STR:
            return self.string(self.length(_STR[b], at), at)
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b], at), at))
        if b in _ARRAY:
            return self.array(self.length(_ARRAY[b], at))
        if b in _MAP:
            return self.mapping(self.length(_MAP[b], at), at)
        if b in _EXT or b in _FIXEXT:
            n = self.length(_EXT[b], at) if b in _EXT else _FIXEXT[b]
            code = struct.unpack(">b", self.take(1, at))[0]
            start = self.pos
            return self.ext(code, bytes(self.take(n, at)), self.base + start)
        self.fail(f"unknown msgpack type byte 0x{b:02x}", at)

    def string(self, n: int, at: int):
        data = self.take(n, at)
        if self.raw:
            return bytes(data)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError:
            self.fail("a str that is not UTF-8", at)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            k = self.value()
            if not isinstance(k, (str, bytes)):
                self.fail(f"a map key of type {type(k).__name__}", key_at)
            out[k] = self.value()
        return out


def _ndarray(data: bytes, at: int):
    """flax's ndarray payload: a msgpack (shape, dtype name, C-order
    bytes). bfloat16 comes back as a torch.bfloat16 tensor."""
    def no_ext(code, _data, where):
        raise ValueError(f"flax checkpoint: ext type {code} inside an "
                         f"ndarray at byte {where}")

    tpl = _Decoder(data, raw=True, ext=no_ext, base=at).document()
    if not (isinstance(tpl, list) and len(tpl) == 3
            and isinstance(tpl[0], list)
            and all(isinstance(s, int) for s in tpl[0])
            and isinstance(tpl[1], bytes) and isinstance(tpl[2], bytes)):
        raise ValueError(f"flax checkpoint: malformed ndarray at byte {at}")
    shape, name, buffer = tuple(tpl[0]), tpl[1].decode(), tpl[2]
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"flax checkpoint: unknown dtype {name!r} at byte "
                         f"{at}") from None
    if dtype.hasobject:
        raise ValueError(f"flax checkpoint: object dtype at byte {at}")
    if len(buffer) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"flax checkpoint: {len(buffer)} bytes for a "
                         f"{name}{list(shape)} array at byte {at}")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _flax_ext(code: int, data: bytes, at: int):
    if code == _EXT_NDARRAY:
        return _ndarray(data, at)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data, at)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"flax checkpoint: ext type {code} (only flax's ndarray "
                     f"(1) and numpy scalar (3) are read) at byte {at}")


def _tuple_of(d: Dict[str, Any]) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: Dict[str, Any]):
    """A chunked array (flax's ``_chunk``: the flat array in pieces)."""
    shape, chunks = _tuple_of(d["shape"]), _tuple_of(d["chunks"])
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(list(chunks)).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: through nested dicts."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def decode_flax_bytes(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` of ``data``, without JAX."""
    return _unchunk_leaves(_Decoder(data, raw=False, ext=_flax_ext).document())


def read_flax_checkpoint(path: str) -> Any:
    """A checkpoint the JAX package wrote (``utils/io.py::save_checkpoint``
    of that package): a nested dict of numpy arrays, numpy scalars and
    Python numbers, bfloat16 arrays as ``torch.bfloat16`` tensors."""
    with open(path, "rb") as f:
        return decode_flax_bytes(f.read())


# ---------------- migrated reference pickle ----------------

_NUMPY_GLOBALS = {"multiarray._reconstruct", "multiarray.scalar",
                  "numeric._frombuffer", "ndarray", "dtype"}
_NUMPY_ROOTS = ("numpy._core", "numpy.core", "numpy")
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray"}


class _ArraysOnly(pickle.Unpickler):
    """Builds numpy arrays, dtypes, numpy scalars and builtin containers
    and numbers; any other global raises."""

    def find_class(self, module: str, name: str):
        import importlib

        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        sub = next((module[len(root) + 1:] for root in _NUMPY_ROOTS
                    if module == root or module.startswith(root + ".")),
                   None)
        if sub is not None and \
                ".".join(filter(None, (sub, name))) in _NUMPY_GLOBALS:
            # numpy 2 pickles name numpy._core, numpy 1 numpy.core: take
            # whichever this numpy has
            for root in _NUMPY_ROOTS:
                try:
                    mod = importlib.import_module(
                        f"{root}.{sub}" if sub else root)
                    return getattr(mod, name)
                except (ImportError, AttributeError):
                    continue
        raise pickle.UnpicklingError(
            f"migrated checkpoint: global {module}.{name} is not allowed "
            f"(numpy arrays and builtin containers only)")


def load_migrated_pickle(path: str) -> Dict[str, Any]:
    """The pickle the JAX package's ``models/migrate.py`` writes from a
    reference ``.pth``: {epoch, iteration, params, batch_stats}, the trees
    of numpy arrays."""
    with open(path, "rb") as f:
        blob = _ArraysOnly(f).load()
    if not isinstance(blob, dict) or not {"params",
                                          "batch_stats"} <= set(blob):
        raise ValueError(f"{path}: not a migrated checkpoint (no params and "
                         f"batch_stats)")
    return blob
