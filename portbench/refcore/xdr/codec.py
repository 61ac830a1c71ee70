"""Byte-exact XDR (RFC 4506) codec — combinator style.

Reference: the reference uses xdrpp-generated C++ from src/protocol-curr/xdr/*.x
(SURVEY.md §2.1 "XDR protocol defs"). We implement our own declarative codec:
types are combinator objects with pack_into/unpack_from; generated struct/union
classes double as value holders AND as field types, so nested declarations read
like the .x files.

Ledger hashes depend on byte-exact encoding, so this module is tested with
exhaustive round-trip + adversarial truncation tests (tests/test_xdr.py).
"""

from __future__ import annotations

import enum
import struct as _struct
import sys
from typing import Any, Dict, List, Optional as Opt, Sequence, Tuple

_U32 = _struct.Struct(">I")
_I32 = _struct.Struct(">i")
_U64 = _struct.Struct(">Q")
_I64 = _struct.Struct(">q")


class XdrError(ValueError):
    pass


def _pad(n: int) -> int:
    return (4 - n % 4) % 4


class XdrType:
    """Protocol: pack_into(val, out: bytearray); unpack_from(buf, off) -> (val, off)."""

    def pack(self, val: Any) -> bytes:
        out = bytearray()
        self.pack_into(val, out)
        return bytes(out)

    def unpack(self, data: bytes) -> Any:
        val, off = self.unpack_from(data, 0)
        if off != len(data):
            raise XdrError(f"trailing bytes: consumed {off} of {len(data)}")
        return val

    def pack_into(self, val: Any, out: bytearray) -> None:  # pragma: no cover
        raise NotImplementedError

    def unpack_from(self, buf: bytes, off: int) -> Tuple[Any, int]:  # pragma: no cover
        raise NotImplementedError


def _pack_prim(packer, val) -> bytes:
    try:
        return packer.pack(val)
    except (_struct.error, TypeError) as e:
        raise XdrError(f"value out of range: {val!r} ({e})") from None


class _Int32(XdrType):
    def pack_into(self, val, out):
        out += _pack_prim(_I32, val)

    def unpack_from(self, buf, off):
        if off + 4 > len(buf):
            raise XdrError("short buffer for int32")
        return _I32.unpack_from(buf, off)[0], off + 4


class _Uint32(XdrType):
    def pack_into(self, val, out):
        out += _pack_prim(_U32, val)

    def unpack_from(self, buf, off):
        if off + 4 > len(buf):
            raise XdrError("short buffer for uint32")
        return _U32.unpack_from(buf, off)[0], off + 4


class _Int64(XdrType):
    def pack_into(self, val, out):
        out += _pack_prim(_I64, val)

    def unpack_from(self, buf, off):
        if off + 8 > len(buf):
            raise XdrError("short buffer for int64")
        return _I64.unpack_from(buf, off)[0], off + 8


class _Uint64(XdrType):
    def pack_into(self, val, out):
        out += _pack_prim(_U64, val)

    def unpack_from(self, buf, off):
        if off + 8 > len(buf):
            raise XdrError("short buffer for uint64")
        return _U64.unpack_from(buf, off)[0], off + 8


class _Bool(XdrType):
    def pack_into(self, val, out):
        out += _U32.pack(1 if val else 0)

    def unpack_from(self, buf, off):
        v, off = Uint32.unpack_from(buf, off)
        if v not in (0, 1):
            raise XdrError(f"bad bool {v}")
        return bool(v), off


Int32 = _Int32()
Uint32 = _Uint32()
Int64 = _Int64()
Uint64 = _Uint64()
Bool = _Bool()


class Opaque(XdrType):
    """Fixed-length opaque[n], zero-padded to 4."""

    def __init__(self, n: int) -> None:
        self.n = n

    def pack_into(self, val: bytes, out):
        if len(val) != self.n:
            raise XdrError(f"opaque[{self.n}]: got {len(val)} bytes")
        out += val
        out += b"\x00" * _pad(self.n)

    def unpack_from(self, buf, off):
        end = off + self.n + _pad(self.n)
        if end > len(buf):
            raise XdrError(f"short buffer for opaque[{self.n}]")
        if any(buf[off + self.n:end]):
            raise XdrError("nonzero padding")
        return bytes(buf[off:off + self.n]), end


class VarOpaque(XdrType):
    """Variable opaque<max>: u32 length + data + padding."""

    def __init__(self, max_len: int = 0xFFFFFFFF) -> None:
        self.max_len = max_len

    def pack_into(self, val: bytes, out):
        if len(val) > self.max_len:
            raise XdrError(f"opaque<{self.max_len}>: got {len(val)} bytes")
        out += _U32.pack(len(val))
        out += val
        out += b"\x00" * _pad(len(val))

    def unpack_from(self, buf, off):
        n, off = Uint32.unpack_from(buf, off)
        if n > self.max_len:
            raise XdrError(f"opaque<{self.max_len}>: length {n}")
        end = off + n + _pad(n)
        if end > len(buf):
            raise XdrError("short buffer for var opaque")
        if any(buf[off + n:end]):
            raise XdrError("nonzero padding")
        return bytes(buf[off:off + n]), end


class XdrString(XdrType):
    """string<max> — stored as bytes (stellar strings are ASCII-checked upstream)."""

    def __init__(self, max_len: int = 0xFFFFFFFF) -> None:
        self._op = VarOpaque(max_len)

    def pack_into(self, val, out):
        if isinstance(val, str):
            val = val.encode("utf-8")
        self._op.pack_into(val, out)

    def unpack_from(self, buf, off):
        return self._op.unpack_from(buf, off)


class FixedArray(XdrType):
    def __init__(self, elem: "XdrType", n: int) -> None:
        self.elem, self.n = _as_type(elem), n

    def pack_into(self, val: Sequence, out):
        if len(val) != self.n:
            raise XdrError(f"array[{self.n}]: got {len(val)}")
        for v in val:
            self.elem.pack_into(v, out)

    def unpack_from(self, buf, off):
        vals = []
        for _ in range(self.n):
            v, off = self.elem.unpack_from(buf, off)
            vals.append(v)
        return vals, off


class VarArray(XdrType):
    def __init__(self, elem: "XdrType", max_len: int = 0xFFFFFFFF) -> None:
        self.elem, self.max_len = _as_type(elem), max_len

    def pack_into(self, val: Sequence, out):
        if len(val) > self.max_len:
            raise XdrError(f"array<{self.max_len}>: got {len(val)}")
        out += _U32.pack(len(val))
        for v in val:
            self.elem.pack_into(v, out)

    def unpack_from(self, buf, off):
        n, off = Uint32.unpack_from(buf, off)
        if n > self.max_len:
            raise XdrError(f"array<{self.max_len}>: length {n}")
        vals = []
        for _ in range(n):
            v, off = self.elem.unpack_from(buf, off)
            vals.append(v)
        return vals, off


class Optional(XdrType):
    """T* — bool presence + value."""

    def __init__(self, elem: "XdrType") -> None:
        self.elem = _as_type(elem)

    def pack_into(self, val, out):
        if val is None:
            out += _U32.pack(0)
        else:
            out += _U32.pack(1)
            self.elem.pack_into(val, out)

    def unpack_from(self, buf, off):
        present, off = Bool.unpack_from(buf, off)
        if not present:
            return None, off
        return self.elem.unpack_from(buf, off)


class _Void(XdrType):
    def pack_into(self, val, out):
        pass

    def unpack_from(self, buf, off):
        return None, off


Void = _Void()


class _EnumAdapter(XdrType):
    def __init__(self, enum_cls) -> None:
        self.enum_cls = enum_cls

    def pack_into(self, val, out):
        try:
            val = self.enum_cls(val)
        except ValueError:
            raise XdrError(
                f"bad {self.enum_cls.__name__} value {val!r}") from None
        out += _pack_prim(_I32, int(val))

    def unpack_from(self, buf, off):
        v, off = Int32.unpack_from(buf, off)
        try:
            return self.enum_cls(v), off
        except ValueError:
            raise XdrError(f"bad {self.enum_cls.__name__} value {v}") from None


def _as_type(t) -> XdrType:
    """Accept XdrType instances, struct/union classes, and IntEnum classes."""
    if isinstance(t, XdrType):
        return t
    if isinstance(t, type) and issubclass(t, enum.IntEnum):
        return _EnumAdapter(t)
    if isinstance(t, type) and hasattr(t, "_xdr_adapter"):
        return t._xdr_adapter()
    raise TypeError(f"not an XDR type: {t!r}")


def xdr_enum(name: str, values: Dict[str, int]):
    """Declare an XDR enum as an IntEnum (packed as signed int32)."""
    return enum.IntEnum(name, values)


class _StructAdapter(XdrType):
    def __init__(self, cls) -> None:
        self.cls = cls

    def pack_into(self, val, out):
        if not isinstance(val, self.cls):
            raise XdrError(f"expected {self.cls.__name__}, got {type(val).__name__}")
        for fname, ftype in self.cls._spec:
            ftype.pack_into(getattr(val, fname), out)

    def unpack_from(self, buf, off):
        kwargs = {}
        for fname, ftype in self.cls._spec:
            kwargs[fname], off = ftype.unpack_from(buf, off)
        return self.cls(**kwargs), off


_MISSING = object()


def _compile_struct_init(name, field_names, defaults):
    """exec-generate a flat __init__ (no kwargs dict walking) — struct
    construction is a replay-loop hot spot."""
    ns = {"_MISSING": _MISSING}
    params = []
    body = []
    for f in field_names:
        params.append(f"{f}=_MISSING")
        if f in defaults:
            d = defaults[f]
            ns[f"_d_{f}"] = d
            if callable(d):
                body.append(f"    self.{f} = _d_{f}() "
                            f"if {f} is _MISSING else {f}")
            else:
                body.append(f"    self.{f} = _d_{f} "
                            f"if {f} is _MISSING else {f}")
        else:
            ns[f"_m_{f}"] = f"{name}: missing field {f!r}"
            body.append(f"    if {f} is _MISSING:")
            body.append(f"        raise TypeError(_m_{f})")
            body.append(f"    self.{f} = {f}")
    src = f"def __init__(self, *, {', '.join(params)}):\n" + "\n".join(body)
    exec(src, ns)  # noqa: S102 — trusted, generated from declared schema
    return ns["__init__"]


def xdr_struct(name: str, fields: List[Tuple[str, Any]], defaults: Opt[Dict[str, Any]] = None):
    """Declare an XDR struct; returns a value class usable as a field type."""
    spec = [(fname, _as_type(ftype)) for fname, ftype in fields]
    field_names = [f for f, _ in spec]
    defaults = defaults or {}

    class Struct:
        _spec = spec
        __slots__ = tuple(field_names)

        __init__ = _compile_struct_init(name, field_names, defaults)

        @classmethod
        def _xdr_adapter(cls):
            a = cls.__dict__.get("_cached_adapter")
            if a is None:
                a = _StructAdapter(cls)
                cls._cached_adapter = a
            return a

        def to_xdr(self) -> bytes:
            return self._xdr_adapter().pack(self)

        @classmethod
        def from_xdr(cls, data: bytes):
            return cls._xdr_adapter().unpack(data)

        def __eq__(self, other):
            return type(other) is type(self) and all(
                getattr(self, f) == getattr(other, f) for f in field_names)

        def __hash__(self):
            return hash(self.to_xdr())

        def __repr__(self):
            parts = ", ".join(f"{f}={getattr(self, f)!r}" for f in field_names)
            return f"{name}({parts})"

        def copy(self, **overrides):
            kw = {f: getattr(self, f) for f in field_names}
            kw.update(overrides)
            return type(self)(**kw)

        def deep_copy(self):
            """Recursive structural copy, cheaper than the XDR
            pack/unpack round-trip (the LedgerTxn copy-out hot path)."""
            new = object.__new__(type(self))
            for f in field_names:
                setattr(new, f, _deep_copy_py(getattr(self, f)))
            return new

    Struct.__name__ = Struct.__qualname__ = name
    return Struct


def _deep_copy_py(val):
    """Pure-Python deep copy of any XDR value: primitives are immutable
    and shared; lists are rebuilt; structs/unions copy field-wise."""
    if val is None or isinstance(val, (int, bytes, str, bool)):
        return val
    if isinstance(val, list):
        return [_deep_copy_py(v) for v in val]
    return val.deep_copy()


def deep_copy_value(val):
    """Deep copy of any XDR value."""
    return _deep_copy_py(val)


class _UnionAdapter(XdrType):
    def __init__(self, cls) -> None:
        self.cls = cls

    def pack_into(self, val, out):
        if not isinstance(val, self.cls):
            raise XdrError(f"expected {self.cls.__name__}, got {type(val).__name__}")
        arm = self.cls._arm_for(val.switch)
        if arm is None:
            raise XdrError(
                f"{self.cls.__name__}: no arm for discriminant {val.switch!r}")
        self.cls._switch_type.pack_into(val.switch, out)
        if arm[1] is not None:
            arm[1].pack_into(val.value, out)

    def unpack_from(self, buf, off):
        sw, off = self.cls._switch_type.unpack_from(buf, off)
        arm = self.cls._arm_for(sw)
        if arm is None:
            raise XdrError(f"{self.cls.__name__}: no arm for discriminant {sw!r}")
        value = None
        if arm[1] is not None:
            value, off = arm[1].unpack_from(buf, off)
        return self.cls(sw, value), off


def xdr_union(name: str, switch_type, arms: Dict[Any, Tuple[str, Any]],
              default: Opt[Tuple[str, Any]] = None):
    """Declare an XDR union.

    arms: {discriminant: (arm_name, arm_type_or_None)}.  Value class exposes
    .switch, .value, and a classmethod constructor per named arm.
    """
    sw_t = _as_type(switch_type)
    resolved = {k: (an, _as_type(at) if at is not None else None)
                for k, (an, at) in arms.items()}
    default_arm = (default[0], _as_type(default[1]) if default[1] is not None else None) \
        if default else None

    class Union:
        _switch_type = sw_t
        _arms = resolved
        _default = default_arm
        __slots__ = ("switch", "value")

        def __init__(self, switch, value=None):
            self.switch = switch
            self.value = value

        @classmethod
        def _arm_for(cls, sw):
            arm = cls._arms.get(sw)
            if arm is None:
                return cls._default
            return arm

        @property
        def arm(self) -> Opt[str]:
            a = self._arm_for(self.switch)
            return a[0] if a else None

        @classmethod
        def _xdr_adapter(cls):
            a = cls.__dict__.get("_cached_adapter")
            if a is None:
                a = _UnionAdapter(cls)
                cls._cached_adapter = a
            return a

        def to_xdr(self) -> bytes:
            return self._xdr_adapter().pack(self)

        @classmethod
        def from_xdr(cls, data: bytes):
            return cls._xdr_adapter().unpack(data)

        def __eq__(self, other):
            return (type(other) is type(self) and self.switch == other.switch
                    and self.value == other.value)

        def __hash__(self):
            return hash(self.to_xdr())

        def __repr__(self):
            return f"{name}({self.switch!r}, {self.value!r})"

        def deep_copy(self):
            new = object.__new__(type(self))
            new.switch = self.switch
            new.value = _deep_copy_py(self.value)
            return new

        @property
        def type(self):
            """Alias for the discriminant (reads like the reference's
            `pledges.type()` accessor)."""
            return self.switch

    class _ArmDescriptor:
        """Class access → constructor; instance access → the arm's value
        (raises if the union currently holds a different arm).  The
        constructor closure is built once and memoized — class-level arm
        access is a construction hot spot."""

        __slots__ = ("disc", "arm_name", "has_value", "_made")

        def __init__(self, disc, arm_name, has_value):
            self.disc = disc
            self.arm_name = arm_name
            self.has_value = has_value
            self._made = None

        def __get__(self, obj, objtype=None):
            if obj is None:
                make = self._made
                if make is None:
                    disc, has_value = self.disc, self.has_value
                    if has_value:
                        def make(value):
                            return objtype(disc, value)
                    else:
                        def make():
                            return objtype(disc)
                    make.__name__ = self.arm_name
                    self._made = make
                return make
            # match by arm NAME, not discriminant: several discriminants may
            # share an arm name (e.g. SCError's SCE_VALUE/SCE_AUTH `code`),
            # and instance access must work for all of them
            if obj.arm != self.arm_name:
                raise AttributeError(
                    f"{name} holds arm {obj.arm!r}, not {self.arm_name!r}")
            return obj.value

    for disc, (arm_name, arm_type) in resolved.items():
        if not arm_name.isidentifier() or hasattr(Union, arm_name):
            continue
        setattr(Union, arm_name, _ArmDescriptor(disc, arm_name,
                                                arm_type is not None))

    Union.__name__ = Union.__qualname__ = name
    return Union


def xdr_typedef(t) -> XdrType:
    return _as_type(t)


def pack(t, val) -> bytes:
    return _as_type(t).pack(val)


def unpack(t, data: bytes):
    return _as_type(t).unpack(data)
