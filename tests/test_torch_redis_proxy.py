"""The RESP proxy (pegasus_tpu_torch.redis_proxy) against pegasus_tpu's,
in one process.

- The RESP codec: every encoder gives the reference's bytes on a table of
  values, and read_command parses a table of streams (arrays, inline
  forms, binary bulk strings, empty lines, malformed and truncated
  input) into the reference's arguments, or raises its error type.
- Each package's RedisProxy over its own servers (tests/test_torch_geo.py
  GeoBox: the port's cuda backend on device="cpu", the reference's cpu
  backend) answers one scripted session of KV and GEO commands, errors
  and inline commands included, with byte-equal replies; the TTLs of a
  SETEX key, which depend on the clock, are held to a window.
"""

import io
import socket

import pytest

from chip_smoke import _resp_cmd as _resp
from chip_smoke import _resp_reply as _raw_reply
from pegasus_tpu.redis_proxy import RedisProxy as RefProxy
from pegasus_tpu.redis_proxy import proxy as ref_proxy
from pegasus_tpu_torch.ops.pipeline import stop_pools
from pegasus_tpu_torch.redis_proxy import RedisProxy
from pegasus_tpu_torch.redis_proxy import proxy as port_proxy
from pegasus_tpu_torch.runtime.tasking import TRACKED
from tests.test_torch_geo import GeoBox

ENCODED = [
    ("_encode_simple", ("OK",)), ("_encode_simple", ("PONG",)),
    ("_encode_simple", ("",)), ("_encode_error", ("unknown command 'X'",)),
    ("_encode_int", (0,)), ("_encode_int", (-2,)), ("_encode_int", (1 << 62,)),
    ("_encode_bulk", (None,)), ("_encode_bulk", (b"",)),
    ("_encode_bulk", (b"hello",)), ("_encode_bulk", (b"\r\n\x00\xff",)),
    ("_encode_array", (None,)), ("_encode_array", ([],)),
    ("_encode_array", ([b"a", None, 3, [b"121.5", b"31.2"], [], None],)),
    ("_encode_array", (([b"x"], (b"y", 7)),)),
]

STREAMS = [
    b"*1\r\n$4\r\nPING\r\n",
    b"*3\r\n$3\r\nSET\r\n$2\r\nk1\r\n$5\r\nhello\r\n",
    b"*2\r\n$3\r\nGET\r\n$4\r\n\r\n\x00\xff\r\n",
    b"*0\r\n",
    b"PING\r\n",
    b"SET  k   v \r\n",
    b"\r\n",
    b"GET k\n",
    b"*2\r\n$3\r\nGET\r\n:5\r\n",          # not a bulk string
    b"*2\r\n$3\r\nGET\r\n",               # truncated: peer closed
    b"",                                  # peer closed
    b"*x\r\n",                            # bad count
    b"*1\r\n$4\r\nPI",                    # short bulk
    b"*2\r\n$4\r\nPING\r\n$1\r\nx\r\nGET a b\r\n*1\r\n$4\r\nQUIT\r\n",
]


@pytest.mark.parametrize("name,args", ENCODED,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(ENCODED)])
def test_encoders_equal_the_reference(name, args):
    assert getattr(port_proxy, name)(*args) == getattr(ref_proxy, name)(*args)


def _parse_all(mod, data: bytes) -> list:
    """Every command read_command takes from `data`, then the error that
    ended the stream (its type)."""
    f = io.BytesIO(data)
    out = []
    for _ in range(8):
        try:
            out.append(mod.read_command(f))
        except Exception as e:  # noqa: BLE001 - the error type is compared
            out.append(type(e).__name__)
            break
    return out


@pytest.mark.parametrize("i", range(len(STREAMS)))
def test_read_command_equals_the_reference(i):
    got = _parse_all(port_proxy, STREAMS[i])
    assert got == _parse_all(ref_proxy, STREAMS[i])
    assert got[-1] in ("ConnectionError", "ValueError")


SESSION = [
    _resp("PING"), b"PING\r\n",
    _resp("SET", "rk1", "hello"), _resp("GET", "rk1"), _resp("GET", "nope"),
    _resp("EXISTS", "rk1", "nope"), _resp("SET", "rk2", "v", "EX", 900),
    _resp("SET", "rk3", "v", "NX"), _resp("SET", "onlykey"),
    _resp("SETEX", "rk4", 500, "temp"), _resp("TTL", "rk1"),
    _resp("TTL", "nope"), _resp("PTTL", "rk1"), _resp("PTTL", "nope"),
    _resp("INCR", "cnt"), _resp("INCRBY", "cnt", 10), _resp("DECR", "cnt"),
    _resp("DECRBY", "cnt", 4), _resp("INCRBY", "cnt", "many"),
    _resp("GET", "cnt"), _resp("INCR", "rk1"), _resp("DEL", "rk1", "nope"),
    _resp("GET", "rk1"), _resp("EXISTS", "rk1"), b"GET rk4\r\n",
    b"EXISTS rk4 rk2 rk1\r\n", _resp("FLUSHALL"),
    _resp("GEOADD", "fleet", "121.4737", "31.2304", "car1", "121.4745",
          "31.2310", "car2", "121.49", "31.24", "car3"),
    _resp("GEOADD", "fleet", "abc", "31", "car9"),
    _resp("GEOPOS", "fleet", "car1", "nope", "car3"),
    _resp("GEODIST", "fleet", "car1", "car2"),
    _resp("GEODIST", "fleet", "car1", "car3", "km"),
    _resp("GEODIST", "fleet", "car1", "nope"), _resp("GEODIST", "fleet"),
    _resp("GEORADIUS", "fleet", "121.4737", "31.2304", "500", "m"),
    _resp("GEORADIUS", "fleet", "121.4737", "31.2304", "3", "km"),
    _resp("GEORADIUS", "other", "121.4737", "31.2304", "3", "km"),
    _resp("GEORADIUSBYMEMBER", "fleet", "car1", "10", "m"),
    _resp("GEORADIUSBYMEMBER", "fleet", "car1", "5", "km"),
    _resp("GEORADIUSBYMEMBER", "fleet", "nope", "5", "km"),
]


@pytest.fixture
def proxies(tmp_path):
    made, socks, files = {}, [], {}
    try:
        for kind, cls in (("port", RedisProxy), ("ref", RefProxy)):
            box = GeoBox(tmp_path, kind)
            made[kind] = (box, cls(box.clients["main"], geo=box.geo).start())
            sock = socket.create_connection(made[kind][1].address, timeout=30)
            socks.append(sock)
            files[kind] = sock.makefile("rwb")
        yield files
    finally:
        for s in socks:
            s.close()
        for box, proxy in made.values():
            proxy.stop()
            box.close()
        stop_pools()
        TRACKED.join_all(timeout_s=5.0)


def test_one_session_gives_byte_equal_replies(proxies):
    replies = {kind: [] for kind in proxies}
    for cmd in SESSION:
        for kind, f in proxies.items():
            f.write(cmd)
            f.flush()
            replies[kind].append(_raw_reply(f))
    assert replies["port"] == replies["ref"]
    got = dict(zip(SESSION, replies["port"]))
    assert got[_resp("GET", "cnt")] == b"$1\r\n6\r\n"
    assert got[b"EXISTS rk4 rk2 rk1\r\n"] == b":2\r\n"
    assert got[_resp("SET", "rk3", "v", "NX")] == \
        b"-ERR unsupported SET option NX\r\n"
    assert got[_resp("GEORADIUS", "fleet", "121.4737", "31.2304", "3",
                     "km")] == (b"*3\r\n$4\r\ncar1\r\n$4\r\ncar2\r\n"
                                b"$4\r\ncar3\r\n")
    assert sum(r.startswith(b"-ERR") for r in replies["port"]) >= 6
    # the clock-dependent replies: within a second of what was set
    for kind, f in proxies.items():
        for cmd, hi, scale in (("TTL", 500, 1), ("PTTL", 500, 1000)):
            f.write(_resp(cmd, "rk4"))
            f.flush()
            n = int(_raw_reply(f)[1:])
            assert (hi - 2) * scale <= n <= hi * scale, (kind, cmd, n)
