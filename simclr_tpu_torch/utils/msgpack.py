"""A reader of flax's msgpack state files, in plain Python over ``struct``
and numpy.

The JAX package exports a model as ``flax.serialization.msgpack_serialize``
of ``{'params': ..., 'batch_stats': ...}`` (``simclr_tpu/utils/
checkpoint.py:export_model``). The port imports neither flax nor the
``msgpack`` package, so ``unpackb`` decodes the format itself:

  * the msgpack types: maps, strings (UTF-8), binaries, arrays (as lists),
    integers, floats, nil and booleans;
  * flax's extension types: 1, an ndarray, and 3, a numpy scalar, each a
    nested msgpack ``(shape, dtype name, row-major bytes)``; 2, a Python
    complex, a nested ``(real, imag)``.

An ndarray is a read-only numpy array over its decoded bytes, as flax
returns it. numpy has no bfloat16, so a bfloat16 leaf widens to float32, which
holds every bfloat16 value exactly. Anything else raises ``ValueError``:
another extension code, a byte msgpack never uses, trailing bytes, and
flax's chunked form of leaves over 2**30 bytes (a map holding
``__msgpack_chunked_array__``), which no export of the repo uses.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# Fixed-width scalars: first byte -> struct format (big-endian).
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# Fixed-length extensions: first byte -> payload length.
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``, with flax's
    extension types."""
    buf = memoryview(data)
    obj, pos = _decode(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated input")
    return buf[pos:pos + n], pos + n


def _unpack(fmt: str, buf: memoryview, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


def _decode(buf: memoryview, pos: int) -> Tuple[Any, int]:
    (b,), pos = _take(buf, pos, 1)
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        return _str(buf, pos, b & 0x1f)
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _SCALARS:
        return _unpack(_SCALARS[b], buf, pos)
    if b in _FIXEXT:
        return _ext(buf, pos, _FIXEXT[b])
    if b in _SIZED:
        read, fmt = _SIZED[b]
        n, pos = _unpack(fmt, buf, pos)
        return read(buf, pos, n)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} begins no "
                     "object")


def _bin(buf: memoryview, pos: int, n: int) -> Tuple[bytes, int]:
    raw, pos = _take(buf, pos, n)
    return bytes(raw), pos


def _str(buf: memoryview, pos: int, n: int) -> Tuple[str, int]:
    raw, pos = _take(buf, pos, n)
    return str(raw, "utf-8"), pos


def _array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        out[key], pos = _decode(buf, pos)
    if _CHUNKED in out:
        raise ValueError("msgpack: a chunked array leaf (flax's form of "
                         "leaves over 2**30 bytes) is not supported")
    return out, pos


def _ext(buf: memoryview, pos: int, n: int) -> Tuple[Any, int]:
    code, pos = _unpack(">b", buf, pos)
    payload, pos = _take(buf, pos, n)
    if code == _EXT_NDARRAY:
        return _ndarray(payload), pos
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()], pos
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag), pos
    raise ValueError(f"msgpack: unknown extension type {code}")


def _ndarray(payload: memoryview) -> np.ndarray:
    shape, dtype, raw = unpackb(payload)
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(dtype)).reshape(shape)


# Length-prefixed types: first byte -> (reader, struct format of the
# length).
_SIZED = {0xc4: (_bin, ">B"), 0xc5: (_bin, ">H"), 0xc6: (_bin, ">I"),
          0xd9: (_str, ">B"), 0xda: (_str, ">H"), 0xdb: (_str, ">I"),
          0xdc: (_array, ">H"), 0xdd: (_array, ">I"),
          0xde: (_map, ">H"), 0xdf: (_map, ">I"),
          0xc7: (_ext, ">B"), 0xc8: (_ext, ">H"), 0xc9: (_ext, ">I")}
