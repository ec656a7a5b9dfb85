"""A minimal msgpack codec: the subset the checkpoint format uses.

The checkpoint files (``checkpoint/ckpt.py``) are a msgpack map of maps
holding strings, byte strings, non-negative integers and arrays of them.
This module reads and writes exactly that subset of the msgpack
specification (https://github.com/msgpack/msgpack/blob/master/spec.md):

* maps: fixmap, map16, map32 (keys and values of the types below);
* str: fixstr, str8, str16, str32 (UTF-8);
* bin: bin8, bin16, bin32;
* non-negative ints: positive fixint, uint8, uint16, uint32, uint64;
* arrays: fixarray, array16, array32.

``packb`` always takes the smallest form, as ``msgpack.packb(obj,
use_bin_type=True)`` does, so a tree gives the same bytes through either.
``unpackb`` raises :class:`MsgpackError` (a ``ValueError``) on truncated
data, on bytes left over after the top object and on a type byte outside
the subset; it never reads past the buffer.
"""
from __future__ import annotations

import struct

__all__ = ["MsgpackError", "packb", "unpackb"]


class MsgpackError(ValueError):
    """Malformed, truncated or unsupported msgpack data."""


def _head(out: bytearray, n: int, fix_base: int, fix_max: int, codes) -> None:
    """The header of a sized type: a fix form below ``fix_max`` (None: no
    fix form), else the first of ``codes`` (8-, 16-, 32-bit lengths; None
    where the type has none) whose length field holds ``n``."""
    if fix_max is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit msgpack's 32-bit length field")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise MsgpackError(f"unsupported type {type(obj).__name__}")
    if isinstance(obj, int):
        if obj < 0:
            raise MsgpackError(f"negative int {obj} is outside the supported subset")
        if obj < 0x80:
            out.append(obj)
        elif obj < 1 << 8:
            out += b"\xcc" + struct.pack(">B", obj)
        elif obj < 1 << 16:
            out += b"\xcd" + struct.pack(">H", obj)
        elif obj < 1 << 32:
            out += b"\xce" + struct.pack(">I", obj)
        elif obj < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            raise MsgpackError(f"int {obj} does not fit uint64")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), 0, None, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"unsupported type {type(obj).__name__}")


def packb(obj) -> bytes:
    """Serialise ``obj`` (dicts, lists, tuples, str, bytes, ints >= 0)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset {self.pos}, "
                               f"{len(self.buf) - self.pos} left")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def obj(self):
        code = self.uint(1)
        if code < 0x80:
            return code
        if code < 0x90:
            return self.map(code & 0x0F)
        if code < 0xA0:
            return self.array(code & 0x0F)
        if code < 0xC0:
            return self.str(code & 0x1F)
        sized = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
                 0xCC: ("int", 1), 0xCD: ("int", 2), 0xCE: ("int", 4), 0xCF: ("int", 8),
                 0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
                 0xDC: ("array", 2), 0xDD: ("array", 4),
                 0xDE: ("map", 2), 0xDF: ("map", 4)}.get(code)
        if sized is None:
            raise MsgpackError(f"unsupported type byte 0x{code:02x} at offset {self.pos - 1}")
        kind, size = sized
        n = self.uint(size)
        if kind == "int":
            return n
        if kind == "bin":
            return bytes(self.take(n))
        return getattr(self, kind)(n)

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"invalid UTF-8 in a str: {e}") from None

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if isinstance(key, (list, dict)):
                raise MsgpackError(f"unhashable map key of type {type(key).__name__}")
            out[key] = self.obj()
        return out


def unpackb(data: bytes):
    """Deserialise one object that spans all of ``data`` (str as ``str``,
    bin as ``bytes``, as ``msgpack.unpackb(data, raw=False)``)."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"extra data: {len(reader.buf) - reader.pos} bytes after "
                           "the top object")
    return obj
