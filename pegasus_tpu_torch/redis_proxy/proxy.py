"""Redis protocol proxy: RESP server mapped onto the pegasus client.

Port of pegasus_tpu/redis_proxy/proxy.py, whole (upstream
src/redis_protocol: proxy_lib/redis_parser.cpp command table :41-53,
session layer proxy_layer.h). It speaks RESP over TCP, translating
SET/GET/DEL/SETEX/TTL/PTTL/INCR[BY]/DECR[BY] onto KV ops (redis key =
hash_key, sort_key = "") and GEOADD/GEODIST/GEOPOS/GEORADIUS[BYMEMBER]
onto the geo client's dual-table index. Any redis client (redis-cli,
libraries) can talk to a cluster through it. Like the reference it has
no entry point of its own: a program constructs and starts it.
"""

import socket
import socketserver

from ..client import PegasusClient, PegasusError
from ..geo.geo_client import GeoClient
from ..runtime.tasking import spawn_thread

EMPTY_SK = b""


# ------------------------------------------------------------- RESP codec

def _encode_simple(s: str) -> bytes:
    return b"+" + s.encode() + b"\r\n"


def _encode_error(s: str) -> bytes:
    return b"-ERR " + s.encode() + b"\r\n"


def _encode_int(n: int) -> bytes:
    return b":" + str(n).encode() + b"\r\n"


def _encode_bulk(v) -> bytes:
    if v is None:
        return b"$-1\r\n"
    return b"$" + str(len(v)).encode() + b"\r\n" + v + b"\r\n"


def _encode_array(items) -> bytes:
    if items is None:
        return b"*-1\r\n"
    out = b"*" + str(len(items)).encode() + b"\r\n"
    for it in items:
        if isinstance(it, (list, tuple)):
            out += _encode_array(it)
        elif isinstance(it, int):
            out += _encode_int(it)
        else:
            out += _encode_bulk(it)
    return out


def _read_line(rfile) -> bytes:
    line = rfile.readline()
    if not line:
        raise ConnectionError("peer closed")
    return line.rstrip(b"\r\n")


def read_command(rfile) -> list:
    """One RESP command -> list[bytes] (arrays + inline forms)."""
    line = _read_line(rfile)
    if not line:
        return []
    if line[:1] == b"*":
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = _read_line(rfile)
            if hdr[:1] != b"$":
                raise ValueError("expected bulk string")
            ln = int(hdr[1:])
            data = rfile.read(ln + 2)[:-2]
            args.append(data)
        return args
    return line.split()  # inline command


# ---------------------------------------------------------------- proxy


class RedisProxy:
    def __init__(self, client: PegasusClient, geo: GeoClient = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.client = client
        self.geo = geo
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                while True:
                    try:
                        args = read_command(self.rfile)
                    except (ConnectionError, ValueError, OSError):
                        return
                    if not args:
                        continue
                    try:
                        out = outer.dispatch(args)
                    except PegasusError as e:
                        out = _encode_error(str(e))
                    except (ValueError, IndexError) as e:
                        out = _encode_error(f"wrong arguments: {e}")
                    try:
                        self.wfile.write(out)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.address = self._srv.server_address
        self._thread = spawn_thread(self._srv.serve_forever, daemon=True,
                                    start=False)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    # ------------------------------------------------------------ dispatch

    def dispatch(self, args: list) -> bytes:
        cmd = args[0].upper().decode()
        fn = getattr(self, f"cmd_{cmd.lower()}", None)
        if fn is None:
            return _encode_error(f"unknown command '{cmd}'")
        return fn(args[1:])

    def cmd_ping(self, a):
        return _encode_simple("PONG")

    def cmd_set(self, a):
        ttl = 0
        i = 2
        while i < len(a):
            opt = a[i].upper()
            if opt == b"EX" and i + 1 < len(a):
                ttl = int(a[i + 1])
                i += 2
            else:
                # NX/XX/PX/KEEPTTL would silently change semantics if
                # answered OK as a plain SET — refuse instead
                return _encode_error(f"unsupported SET option {opt.decode()}")
        self.client.set(a[0], EMPTY_SK, a[1], ttl_seconds=ttl)
        return _encode_simple("OK")

    def cmd_setex(self, a):
        self.client.set(a[0], EMPTY_SK, a[2], ttl_seconds=int(a[1]))
        return _encode_simple("OK")

    def cmd_get(self, a):
        return _encode_bulk(self.client.get(a[0], EMPTY_SK))

    def cmd_del(self, a):
        n = 0
        for key in a:
            if self.client.exist(key, EMPTY_SK):
                self.client.delete(key, EMPTY_SK)
                n += 1
        return _encode_int(n)

    def cmd_exists(self, a):
        return _encode_int(sum(1 for k in a if self.client.exist(k, EMPTY_SK)))

    def cmd_ttl(self, a):
        t = self.client.ttl(a[0], EMPTY_SK)
        return _encode_int(-2 if t is None else (-1 if t < 0 else t))

    def cmd_pttl(self, a):
        t = self.client.ttl(a[0], EMPTY_SK)
        return _encode_int(-2 if t is None else (-1 if t < 0 else t * 1000))

    def cmd_incr(self, a):
        return _encode_int(self.client.incr(a[0], EMPTY_SK, 1))

    def cmd_incrby(self, a):
        return _encode_int(self.client.incr(a[0], EMPTY_SK, int(a[1])))

    def cmd_decr(self, a):
        return _encode_int(self.client.incr(a[0], EMPTY_SK, -1))

    def cmd_decrby(self, a):
        return _encode_int(self.client.incr(a[0], EMPTY_SK, -int(a[1])))

    # geo ------------------------------------------------------------------

    def _need_geo(self):
        if self.geo is None:
            raise ValueError("geo commands not configured")
        return self.geo

    def cmd_geoadd(self, a):
        geo = self._need_geo()
        key, n = a[0], 0
        for i in range(1, len(a) - 2, 3):
            lng, lat, member = float(a[i]), float(a[i + 1]), a[i + 2]
            geo.set_geo_data(lat, lng, key, member, b"||||||")
            n += 1
        return _encode_int(n)

    def cmd_geodist(self, a):
        geo = self._need_geo()
        d = geo.distance(a[0], a[1], a[0], a[2])
        if d is None:
            return _encode_bulk(None)
        unit = a[3].lower() if len(a) > 3 else b"m"
        scale = {b"m": 1.0, b"km": 1000.0}.get(unit, 1.0)
        return _encode_bulk(repr(round(d / scale, 4)).encode())

    def cmd_geopos(self, a):
        geo = self._need_geo()
        out = []
        for member in a[1:]:
            v = geo.get(a[0], member)
            ll = geo.codec.decode(v) if v is not None else None
            out.append(None if ll is None
                       else [repr(ll[1]).encode(), repr(ll[0]).encode()])
        return _encode_array(out)

    def cmd_georadius(self, a):
        geo = self._need_geo()
        lng, lat, radius = float(a[1]), float(a[2]), float(a[3])
        radius *= {b"m": 1, b"km": 1000}.get(a[4].lower() if len(a) > 4 else b"m", 1)
        rows = geo.search_radial(lat, lng, radius)
        return _encode_array([sk for _, hk, sk, _ in rows if hk == a[0]])

    def cmd_georadiusbymember(self, a):
        geo = self._need_geo()
        radius = float(a[2]) * {b"m": 1, b"km": 1000}.get(
            a[3].lower() if len(a) > 3 else b"m", 1)
        rows = geo.search_radial_by_key(a[0], a[1], radius)
        return _encode_array([sk for _, hk, sk, _ in rows if hk == a[0]])
