"""The msgpack subset the checkpoint manifest uses: maps, arrays, str,
int, bool and nil. ``packb`` gives the bytes that ``msgpack.packb`` gives
for such values (its defaults: ``use_bin_type=True``, each value in its
shortest form), and ``unpackb`` reads them back as ``msgpack.unpackb``
does (lists for arrays, str for str). The port carries this codec because
the machines it trains on need not have the ``msgpack`` package."""

from __future__ import annotations

import struct


def _head(n: int, fix: int, fix_max: int, wide: tuple[int, int, int] | None,
          what: str) -> bytes:
    """The header of a str, array or map of n items: the fix form below
    fix_max, else the 8- (str only), 16- or 32-bit length form."""
    if n < fix_max:
        return bytes([fix | n])
    c8, c16, c32 = wide
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return struct.pack(">BH", c16, n)
    if n < 1 << 32:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack: {what} of {n} items is too long")


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if x < top:
                return struct.pack(fmt, code, x)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if x >= low:
                return struct.pack(fmt, code, x)
    raise OverflowError(f"msgpack: integer {x} out of range")


def _pack(x, out: list[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(int(x)))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out += [_head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str"), b]
    elif isinstance(x, (list, tuple)):
        out.append(_head(len(x), 0x90, 16, (None, 0xDC, 0xDD), "array"))
        for item in x:
            _pack(item, out)
    elif isinstance(x, dict):
        out.append(_head(len(x), 0x80, 16, (None, 0xDE, 0xDF), "map"))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(x).__name__}")


def packb(x) -> bytes:
    out: list[bytes] = []
    _pack(x, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.at = data, 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        b = self.data[self.at:self.at + n]
        self.at += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 256
        if 0x80 <= c <= 0x8F:
            return self.items_map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in fixed:
            return fixed[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.num(ints[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return self.take(self.num(strs[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.items_map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack subset: unsupported type byte 0x{c:02x}")

    def items_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    r = _Reader(bytes(data))
    x = r.value()
    if r.at != len(r.data):
        raise ValueError("msgpack: extra data after the value")
    return x
