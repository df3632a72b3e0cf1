"""Compact binary codec for the rpc.messages dataclasses.

Port of pegasus_tpu/rpc/codec.py, pure-Python path only (the JAX
package's native fastcodec route writes the same bytes and is not
ported). The wire format is derived from the dataclass type annotations:

    int        -> zigzag varint
    bool       -> 1 byte
    bytes      -> varint length + raw
    str        -> varint length + utf-8
    Optional[X]-> presence byte + X
    List[X]    -> varint count + X...
    dataclass  -> varint field count + fields in declaration order
    IntEnum    -> as int

The leading field count lets a decoder accept messages from an older
encoder (missing trailing fields fall back to dataclass defaults): the
append-only evolution rule. Field ORDER, types and defaults are the
wire contract with pegasus_tpu peers, not field names.
"""

import dataclasses
import functools
import threading
import typing


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_varint(out: bytearray, n: int) -> None:
    if n < 0x80:  # the overwhelmingly common case: counts, lengths,
        out.append(n)  # small zigzagged ints — one append, no loop
        return
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf, off: int):
    b = buf[off]
    if not b & 0x80:
        return b, off + 1
    shift = 0
    val = 0
    end = off + 10  # the longest varint the encoder emits for [-2^63, 2^64)
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        if off >= end:
            # corrupt frame: without the bound this would keep absorbing
            # continuation bytes into an ever-growing int where the JAX
            # package's decoders raise: all reject the same input
            raise CodecError("varint overflow (longer than 10 bytes)")
        shift += 7


class CodecError(Exception):
    pass


# The annotation interpretation (typing.get_origin / get_args /
# issubclass walks) is done ONCE per type here, yielding closure pairs
# (enc(out, v), dec(buf, off) -> (v, off)); the serving path runs only the
# closures. Re-interpreting annotations per value measured ~40% of YCSB
# server CPU (typing.get_origin alone: 3M calls per 10k-op run).
@functools.lru_cache(maxsize=None)
def _codec_for(t):
    origin = typing.get_origin(t)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if len(args) != 1:
            raise CodecError(f"unsupported union {t!r}")
        # inner codec resolved on first non-None use (same lazy rule as
        # lists: an always-None Optional of an unsupported type must work)
        lazy = []

        def inner_codec():
            if not lazy:
                lazy.append(_codec_for(args[0]))
            return lazy[0]

        def enc(out, v):
            if v is None:
                out.append(0)
            else:
                out.append(1)
                inner_codec()[0](out, v)

        def dec(buf, off):
            flag = buf[off]
            off += 1
            if not flag:
                return None, off
            return inner_codec()[1](buf, off)

        return enc, dec
    if origin in (list, typing.List):
        (item_t,) = typing.get_args(t)
        # item codec resolved on first non-empty use: an always-empty list
        # of an unsupported item type must keep working (it writes/reads
        # only the zero count — e.g. LogMutation.requests: List[tuple])
        lazy = []

        def item_codec():
            if not lazy:
                lazy.append(_codec_for(item_t))
            return lazy[0]

        def enc(out, v):
            write_varint(out, len(v))
            if not v:
                return
            enc_i = item_codec()[0]
            for item in v:
                enc_i(out, item)

        def dec(buf, off):
            n, off = read_varint(buf, off)
            if not n:
                return [], off
            dec_i = item_codec()[1]
            out = []
            for _ in range(n):
                item, off = dec_i(buf, off)
                out.append(item)
            return out, off

        return enc, dec
    if t is bytes:

        def enc(out, v):
            write_varint(out, len(v))
            out.extend(v)

        def dec(buf, off):
            n, off = read_varint(buf, off)
            return bytes(buf[off : off + n]), off + n

        return enc, dec
    if t is str:

        def enc(out, v):
            raw = v.encode("utf-8")
            write_varint(out, len(raw))
            out.extend(raw)

        def dec(buf, off):
            n, off = read_varint(buf, off)
            return bytes(buf[off : off + n]).decode("utf-8"), off + n

        return enc, dec
    if t is bool:

        def enc(out, v):
            out.append(1 if v else 0)

        def dec(buf, off):
            return bool(buf[off]), off + 1

        return enc, dec
    if t is int:
        # the hottest codec leaf (decrees, ballots, ids, error codes…):
        # zigzag + varint inlined for the 1-byte case, no helper calls
        def enc(out, v):
            v = int(v)
            v = (v << 1) ^ (v >> 63) if v < 0 else v << 1
            if v < 0x80:
                out.append(v)
            else:
                write_varint(out, v)

        def dec(buf, off):
            b = buf[off]
            if not b & 0x80:
                return (b >> 1) ^ -(b & 1), off + 1
            n, off = read_varint(buf, off)
            return (n >> 1) ^ -(n & 1), off

        return enc, dec
    if isinstance(t, type) and issubclass(t, int):  # IntEnum

        def enc(out, v):
            write_varint(out, _zigzag(int(v)))

        def dec(buf, off):
            n, off = read_varint(buf, off)
            return t(_unzigzag(n)), off

        return enc, dec
    if dataclasses.is_dataclass(t):
        # bind the plan once on first use (lazy, not eager, so recursive
        # dataclasses don't loop during plan construction)
        plan = []

        def enc(out, v):
            if not plan:
                plan.append(_plan_of(t))
            plan[0].encode(out, v)

        def dec(buf, off):
            if not plan:
                plan.append(_plan_of(t))
            return plan[0].decode(buf, off)

        return enc, dec
    raise CodecError(f"unsupported type {t!r}")


class _StructPlan:
    __slots__ = ("cls", "names", "encs", "decs", "n", "pairs")

    def __init__(self, cls):
        self.cls = cls
        hints = typing.get_type_hints(cls)
        fields = dataclasses.fields(cls)
        self.names = [f.name for f in fields]
        self.encs = [_codec_for(hints[f.name])[0] for f in fields]
        self.decs = [_codec_for(hints[f.name])[1] for f in fields]
        self.n = len(fields)
        self.pairs = list(zip(self.names, self.encs))

    def encode(self, out, obj):
        # write_varint, not a raw byte: a 128+-field dataclass still
        # frames correctly
        write_varint(out, self.n)
        for name, enc in self.pairs:
            enc(out, getattr(obj, name))

    def decode(self, buf, off):
        n, off = read_varint(buf, off)
        if n > self.n:
            raise CodecError(f"{self.cls.__name__}: encoder sent {n} "
                             f"fields, decoder knows {self.n}")
        kwargs = {}
        for i in range(n):
            kwargs[self.names[i]], off = self.decs[i](buf, off)
        return self.cls(**kwargs), off


_plan_cache = {}  # cls -> finished plan; published only AFTER init
# lru_cache does not serialize concurrent misses: plan construction is
# serialized so every thread sees one finished plan per class
_plan_lock = threading.Lock()


def _plan_of(cls) -> _StructPlan:
    plan = _plan_cache.get(cls)  # lock-free hot path (GIL-atomic dict)
    if plan is not None:
        return plan
    with _plan_lock:
        plan = _plan_cache.get(cls)
        if plan is None:
            plan = _plan_cache[cls] = _StructPlan(cls)
        return plan


def encode(obj) -> bytes:
    """Serialize a rpc.messages dataclass instance."""
    out = bytearray()
    _plan_of(type(obj)).encode(out, obj)
    return bytes(out)


def decode(cls, data) -> object:
    """Deserialize `data` into an instance of dataclass `cls`."""
    obj, off = _plan_of(cls).decode(data, 0)
    if off != len(data):
        raise CodecError(f"{cls.__name__}: {len(data) - off} trailing bytes")
    return obj
