"""The msgpack subset the checkpoint container uses, written and read
without the ``msgpack`` package (the port needs no msgpack): maps, arrays
(Python lists and tuples), str, bin (bytes), int, float (as float64),
bool and nil.

``packb`` emits the bytes ``msgpack.packb(obj, use_bin_type=True)`` does:
the smallest format for every int, str, bin, array and map length, and
float64 for every float; ``map_head`` and ``bin_head`` emit a map's or a
bin's header alone, so a writer can stream a bin's bytes after it.
``unpackb`` reads that subset (plus float32) the way
``msgpack.unpackb(raw=False, strict_map_key=False)`` does, and raises
``ValueError`` on anything else; each bin comes back as a ``memoryview``
into the buffer, not a copy.
"""
from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: fix-format when ``n < fix_max``, else the 8/16/32
    bit form (``codes``; a code of -1 means the width does not exist)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] >= 0 and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _head(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (-1, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (-1, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def map_head(n: int) -> bytes:
    """The header of a map of ``n`` pairs (its pairs follow it)."""
    out = bytearray()
    _head(out, n, 0x80, 16, (-1, 0xDE, 0xDF))
    return bytes(out)


def bin_head(n: int) -> bytes:
    """The header of a bin of ``n`` bytes (its bytes follow it)."""
    out = bytearray()
    _head(out, n, None, 0, (0xC4, 0xC5, 0xC6))
    return bytes(out)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def view(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def take(self, n: int) -> bytes:
        return bytes(self.view(n))

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if c not in sized:
            raise ValueError(f"msgpack type byte 0x{c:02x} is outside the "
                             "checkpoint subset")
        fmt, kind = sized[c]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.view(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf):
    r = _Reader(buf)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return obj
