"""The subset of MessagePack that a checkpoint manifest uses, without ``msgpack``.

The card's machine has no ``msgpack`` package, so the port carries its
own encoder and decoder for nil, bool, int, float, str, array and map.
``packb`` writes what ``msgpack.packb`` writes with its defaults
(``use_bin_type=True``, ``use_single_float=False``): the smallest integer
form, floats as float64, strings as UTF-8 ``str`` types, lists and
tuples as arrays, dicts as maps in their iteration order.  ``unpackb``
reads those (and float32) back, arrays as lists, as ``msgpack.unpackb``
does with its defaults.  Anything else raises ``TypeError`` or
``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb"]


def _sized(out: bytearray, n: int, fix_base: int, fix_max: int, tags) -> None:
    """Header of a str/array/map of length n: fix form, then 8/16/32-bit."""
    if n < fix_max:
        out.append(fix_base | n)
        return
    for tag, fmt, limit in tags:
        if n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for MessagePack")


_STR_TAGS = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_ARR_TAGS = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP_TAGS = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_UINTS = ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
          (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF))
_INTS = ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
         (0xD3, ">q", -0x8000000000000000))


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
        return
    if -0x20 <= x < 0:
        out.append(x & 0xFF)
        return
    for tag, fmt, limit in (_UINTS if x >= 0 else _INTS):
        if (x <= limit) if x >= 0 else (x >= limit):
            out.append(tag)
            out += struct.pack(fmt, x)
            return
    raise ValueError(f"integer {x} does not fit in 64 bits")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, _STR_TAGS)
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, _ARR_TAGS)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 16, _MAP_TAGS)
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj)`` would."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _read(r: _Reader) -> Any:
    tag = r.take(1)[0]
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if tag in _FIXED:
        return r.unpack(_FIXED[tag])
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag in _LENGTHS:
        kind, fmt = _LENGTHS[tag]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"MessagePack type 0x{tag:02x} is outside the manifest subset")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a str")
        out[key] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    """Decode one MessagePack object, as ``msgpack.unpackb(data)`` would."""
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("extra data after the MessagePack object")
    return obj
