"""The msgpack subset the checkpoint manifests and WAL records are written in.

``packb`` / ``unpackb`` give the bytes and values of ``msgpack.packb`` /
``msgpack.unpackb`` with msgpack 1.x's defaults (``use_bin_type=True``,
``raw=False``, ``strict_map_key=True``) for the types those files hold, so
the JAX package and this one read each other's files without this package
depending on ``msgpack``:

  * ``None``, ``bool``;
  * ``int`` in the smallest encoding: positive fixint or uint8-uint64 when
    >= 0, negative fixint or int8-int64 when < 0 (``OverflowError``
    outside [-2**63, 2**64));
  * ``float``, always float64 (``0xcb``);
  * ``str`` (utf-8; fixstr / str8 / str16 / str32) and ``bytes`` (bin8 /
    bin16 / bin32);
  * ``list`` and ``tuple`` (fixarray / array16 / array32; unpacked as
    ``list``);
  * ``dict`` in insertion order (fixmap / map16 / map32); unpacked keys
    must be ``str`` or ``bytes``.

Subclasses count as their base type, as in msgpack (``np.float64`` is a
``float``, an ``IntEnum`` an ``int``); any other type raises ``TypeError``
(``bytearray`` and ``memoryview`` too, which msgpack would take), as
msgpack does for ``np.int64``, so a payload the JAX package cannot write
is not writable here either.  ``unpackb`` also reads float32
(``0xca``); extension types are not read.  Truncated, trailing or unknown
bytes raise ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb"]

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += b"\xcc" + _U8.pack(v)
        elif v < 1 << 16:
            out += b"\xcd" + _U16.pack(v)
        elif v < 1 << 32:
            out += b"\xce" + _U32.pack(v)
        elif v < 1 << 64:
            out += b"\xcf" + _U64.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += b"\xd0" + _I8.pack(v)
    elif v >= -(1 << 15):
        out += b"\xd1" + _I16.pack(v)
    elif v >= -(1 << 31):
        out += b"\xd2" + _I32.pack(v)
    elif v >= -(1 << 63):
        out += b"\xd3" + _I64.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 / 16 /
    32-bit form whose code is in ``codes`` (``b""`` where a width has none)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, width, limit in zip(codes, (_U8, _U16, _U32),
                                  (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            out.append(code)
            out += width.pack(n)
            return
    raise ValueError(f"msgpack length {n} out of range")


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out += b"\xcb" + _F64.pack(o)
    elif isinstance(o, bytes):
        _pack_len(len(o), 0, 0, b"\xc4\xc5\xc6", out)
        out += o
    elif isinstance(o, str):
        raw = o.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += raw
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 16, b"\x00\xde\xdf", out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 16, b"\x00\xdc\xdd", out)
        for v in o:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(o: Any) -> bytes:
    """``msgpack.packb(o)`` for the types listed in the module docstring."""
    out = bytearray()
    _pack(o, out)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf) -> None:
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


# first byte -> (kind, length struct) for the sized forms
_SIZED = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}
_NUMS = {
    0xCA: _F32, 0xCB: _F64,
    0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
    0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
}


def _unpack(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b < 0x90:
        return _unpack_map(r, b & 0x0F)
    if b < 0xA0:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if b < 0xC0:
        return _utf8(r.take(b & 0x1F))
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMS:
        return r.num(_NUMS[b])
    if b in _SIZED:
        kind, st = _SIZED[b]
        n = r.num(st)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return _utf8(r.take(n))
        if kind == "array":
            return [_unpack(r) for _ in range(n)]
        return _unpack_map(r, n)
    raise ValueError(f"msgpack byte 0x{b:02x} is not read here (reserved or "
                     f"an extension type)")


def _utf8(view: memoryview) -> str:
    try:
        return str(view, "utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"invalid utf-8 in a msgpack str: {e}") from e


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key "
                             f"when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def unpackb(packed) -> Any:
    """``msgpack.unpackb(packed)`` for the types listed in the module
    docstring; ``ValueError`` on truncated, trailing or unknown bytes."""
    r = _Reader(packed)
    out = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("unpack(b) received extra data.")
    return out
