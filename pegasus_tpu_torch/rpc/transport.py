"""TCP RPC transport: framed request/response with task-code dispatch.

Port of pegasus_tpu/rpc/transport.py: its framing, header and error
codes, so a pegasus_tpu peer and a pegasus_tpu_torch peer talk to each
other on one socket. Serverlets register their per-frame handlers
(register_serverlet); calls carry the partition routing fields
(app_id, partition_index, partition_hash) and, on a sharded connection,
the `sharded` flag. Pure Python: the JAX package's native frame reader
and vectored writer send the same bytes and are not ported (their
pure-Python twins are).

Request tracing: a call made inside an active trace
(runtime/tracing.py REQUEST_TRACER) carries its trace_id and
trace_sampled in the header and records an `rpc.<code>` span; the
server serves a traced frame inside REQUEST_TRACER.serve, so the
handler's spans join the caller's trace. The header is the JAX
package's, so a trace crosses between the packages in both directions.

Middlewares (add_middleware; the toollets of runtime/toollets.py) wrap
every per-frame handler.

Priority codes: requests beyond the 16-worker pool queue, except the
replication and lifecycle codes of RpcServer.PRIORITY_CODES, which get a
thread of their own when every worker is busy. A pool whose workers all
wait in client_write for prepare acks must still serve the prepares
those acks need.

Batch dispatch: a serverlet may also register batch handlers for hot
read codes (register_batch). The frame reader bins each pipelined wave
by task code (_FrameReader.wave_batched), and a binned batch of one code
is ONE pool task, ONE handler call and ONE coalesced reply write. Its
responses are byte-identical to the per-frame path's, and it ticks the
same counters per frame. A batch goes back to per-frame dispatch where
the JAX package's does: when the `serve.native` fail point triggers,
when a frame carries a trace context (its spans attach per request),
and when middlewares are installed (they wrap per-frame handlers).

Frame: u32 LE payload length | payload. Payload = u32 LE header length |
codec-encoded RpcHeader | body bytes. Requests and responses share the
frame; `is_response` tells them apart. Every connection is full-duplex:
a reader thread matches responses to pending sequence numbers, so many
calls can be in flight at once.
"""

import socket
import socketserver
import struct
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass

from . import codec
from ..runtime.fail_points import FailPointError, fail_point
from ..runtime.perf_counters import counters
from ..runtime.table_stats import TABLE_STATS
from ..runtime.tasking import spawn_thread, tracked_executor
from ..runtime.tracing import REQUEST_TRACER, TraceContext

# RPC-layer error codes (a handler's own status rides in its response
# body's `error` field)
ERR_OK = 0
ERR_HANDLER_NOT_FOUND = 1
ERR_TIMEOUT = 2
ERR_INVALID_STATE = 3
ERR_OBJECT_NOT_FOUND = 4
ERR_BUSY = 5
ERR_INVALID_DATA = 6
ERR_NETWORK_FAILURE = 7
ERR_FORWARD_TO_PRIMARY = 8


@dataclass
class RpcHeader:
    """Every field of the JAX package's header, in its order, so frames
    decode on both sides. trace_id 0 is an untraced call; `sharded` marks
    a connection that carries one partition's traffic."""

    seq: int = 0
    code: str = ""
    app_id: int = 0
    partition_index: int = 0
    partition_hash: int = 0
    error: int = 0          # response-only: rpc-level error
    error_text: str = ""
    is_response: bool = False
    trace_id: int = 0
    trace_sampled: bool = False
    sharded: bool = False


class RpcError(Exception):
    def __init__(self, err: int, text: str = ""):
        super().__init__(f"rpc error {err}: {text}")
        self.err = err
        self.text = text


def _send_frame(sock, header: RpcHeader, body: bytes, lock=None) -> None:
    h = codec.encode(header)
    hl = len(h)
    # one buffer, one copy of the body
    frame = bytearray(8 + hl + len(body))
    struct.pack_into("<II", frame, 0, 4 + hl + len(body), hl)
    frame[8: 8 + hl] = h
    frame[8 + hl:] = body
    if lock:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def _send_frames(sock, pairs, lock=None) -> None:
    """[(RpcHeader, body), ...] as one coalesced write: the same bytes in
    the same order as one _send_frame per pair."""
    buf = bytearray()
    for header, body in pairs:
        h = codec.encode(header)
        buf += struct.pack("<II", 4 + len(h) + len(body), len(h))
        buf += h
        buf += body
    if lock:
        with lock:
            sock.sendall(buf)
    else:
        sock.sendall(buf)


class _FrameReader:
    """Buffered framing for a socket with a single reader thread: one recv
    may yield several pipelined frames. `hot` is the task codes that
    wave_batched coalesces into per-code batches."""

    __slots__ = ("sock", "buf", "pos", "hot")

    def __init__(self, sock, initial: bytes = b"", hot=()):
        self.sock = sock
        self.buf = bytearray(initial)
        self.pos = 0
        self.hot = frozenset(hot)

    def _fill(self, need: int) -> None:
        buf = self.buf
        if self.pos and (len(buf) == self.pos or self.pos > (1 << 16)):
            del buf[: self.pos]  # compact consumed bytes
            self.pos = 0
        while len(buf) - self.pos < need:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk

    def frame(self):
        self._fill(4)
        pos = self.pos
        (plen,) = struct.unpack_from("<I", self.buf, pos)
        self._fill(4 + plen)
        pos = self.pos  # _fill may have compacted
        (hlen,) = struct.unpack_from("<I", self.buf, pos + 4)
        if plen < 4 or hlen > plen - 4:
            raise codec.CodecError("corrupt frame lengths")
        mv = memoryview(self.buf)
        try:
            header = codec.decode(RpcHeader, mv[pos + 8: pos + 8 + hlen])
            body = bytes(mv[pos + 8 + hlen: pos + 4 + plen])
        finally:
            mv.release()  # buf must be resizable before the next _fill
        self.pos = pos + 4 + plen
        return header, body

    def _buffered_frame(self) -> bool:
        """A complete frame sits in the buffer (no recv needed)?"""
        avail = len(self.buf) - self.pos
        if avail < 4:
            return False
        (plen,) = struct.unpack_from("<I", self.buf, self.pos)
        return avail >= 4 + plen

    def wave(self):
        """-> every complete frame currently available (blocking for the
        first)."""
        out = [self.frame()]
        while self._buffered_frame():
            out.append(self.frame())
        return out

    def wave_batched(self):
        """wave() binned by hot task code: frames whose code is in `hot`
        join ONE (code, frames) entry opened at their first frame's
        arrival position; every other frame gets a singleton entry, in
        arrival order."""
        out, bins = [], {}
        for header, body in self.wave():
            code = header.code
            lst = bins.get(code)
            if lst is not None:
                lst.append((header, body))
                continue
            lst = [(header, body)]
            if code in self.hot:
                bins[code] = lst
            out.append((code, lst))
        return out


class RpcServer:
    """Threaded TCP server. Handlers: code -> fn(header, body) -> body.

    A handler may raise RpcError to return an rpc-level error; any other
    exception becomes an ERR_INVALID_DATA response carrying its repr.
    Requests run on a bounded worker pool; requests beyond it queue,
    except PRIORITY_CODES, which escape to a thread of their own when all
    POOL_WORKERS are busy (a full pool may be waiting on them)."""

    POOL_WORKERS = 16
    PRIORITY_CODES = frozenset({
        "RPC_PREPARE", "RPC_LEARN", "RPC_FD_FAILURE_DETECTOR_PING",
        "RPC_LEARN_PREPARE", "RPC_LEARN_FETCH", "RPC_LEARN_TAIL",
        "RPC_LEARN_FINISH",
        "RPC_CONFIG_PROPOSAL_OPEN_REPLICA",
        "RPC_CONFIG_PROPOSAL_CLOSE_REPLICA",
    })

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._handlers = {}
        # hot read codes with a batch handler: fn(headers, bodies) -> one
        # result per frame (bytes | RpcError | Exception)
        self._batch_handlers = {}
        self._middlewares = []   # fn(code, header, body, next) -> body
        self._pool = tracked_executor(self.POOL_WORKERS,
                                      thread_name_prefix="rpc-serve")
        # pool tasks submitted and not yet finished: at POOL_WORKERS a
        # priority frame takes its own thread instead of queueing, and
        # the excess over POOL_WORKERS is the dispatch queue's depth
        self._busy_lock = threading.Lock()
        self._busy = 0  #: guarded_by self._busy_lock
        self._depth_gauge = counters.number("rpc.server.dispatch_queue_depth")
        # live accepted connections: stop() shuts them down so a stopped
        # server looks like a killed one to its peers (in-flight calls
        # fail at once instead of waiting out the client timeout)
        self._conn_lock = threading.Lock()
        self._conns = set()  #: guarded_by self._conn_lock
        self._c_qps = counters.rate("rpc.server.qps")
        self._c_err = counters.rate("rpc.server.error_count")
        self._c_lat = counters.percentile("rpc.server.latency_us")
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer.serve_connection(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Server((host, port), _Handler)
        self.address = self._srv.server_address  # (host, actual_port)
        # a short poll: stop() waits out at most one poll of the accept
        # loop (socketserver's default half second made every stop slow)
        self._thread = spawn_thread(
            self._srv.serve_forever, poll_interval=0.05, name="rpc-accept",
            daemon=True, start=False)

    def serve_connection(self, sock) -> None:
        """Serve one connection to exhaustion: read pipelined frame waves,
        binned by hot task code, and dispatch each singleton frame and
        each batch to the pool."""
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            return
        wlock = threading.Lock()
        with self._conn_lock:
            self._conns.add(sock)
        try:
            reader = _FrameReader(sock, hot=tuple(self._batch_handlers))
            while True:
                for code, frames in reader.wave_batched():
                    if len(frames) == 1:
                        header, body = frames[0]
                        self._dispatch(sock, wlock, header, body)
                    else:
                        self._dispatch_batch(sock, wlock, code, frames)
        except (ConnectionError, OSError, codec.CodecError, RuntimeError):
            pass  # RuntimeError: stopping, the pool is shut down
        finally:
            with self._conn_lock:
                self._conns.discard(sock)

    def register(self, code: str, handler) -> None:
        self._handlers[code] = handler

    def register_batch(self, code: str, handler) -> None:
        """Register a batch handler: fn(headers, bodies) -> one result per
        frame, each bytes (success), RpcError, or any Exception (encoded
        exactly as the per-frame path encodes them). The code must also
        have a per-frame handler: singleton frames, traced frames and the
        serve.native fail point route per frame."""
        self._batch_handlers[code] = handler

    def register_serverlet(self, obj) -> None:
        """Register every (code, fn) pair of obj.rpc_handlers(), plus
        obj.rpc_batch_handlers() when the serverlet provides them."""
        for code, fn in obj.rpc_handlers().items():
            self.register(code, fn)
        for code, fn in getattr(obj, "rpc_batch_handlers",
                                dict)().items():
            self.register_batch(code, fn)

    def add_middleware(self, mw) -> None:
        """mw(code, header, body, next_fn) -> response body: wraps every
        per-frame handler (the toollet seam). A server with a middleware
        serves every frame on the per-frame path."""
        self._middlewares.append(mw)

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread.is_alive():
            self._srv.shutdown()
        self._srv.server_close()
        # shutdown (never close: the handler thread owns the fd) every
        # live connection, so peers see EOF now, as after a process kill
        with self._conn_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._pool.shutdown(wait=False)

    def _dispatch(self, sock, wlock, header: RpcHeader, body: bytes) -> None:
        """One frame to the pool. serve.dispatch is the chaos seam of a
        wedged dispatcher: sleep(ms) stalls this connection's loop,
        raise(msg) answers ERR_BUSY instead of serving."""
        try:
            fail_point("serve.dispatch")
        except FailPointError as e:
            self._c_err.increment()
            if header.app_id:
                # a rejected dispatch is an error the TABLE saw, although
                # no replica handler ran (no-op for an unmapped app_id)
                TABLE_STATS.charge_app_error(header.app_id)
            try:
                _send_frame(sock, RpcHeader(
                    seq=header.seq, code=header.code, is_response=True,
                    error=ERR_BUSY, error_text=str(e)), b"", lock=wlock)
            except (ConnectionError, OSError):
                pass
            return
        if header.code in self.PRIORITY_CODES:
            with self._busy_lock:
                overflow = self._busy >= self.POOL_WORKERS
            if overflow:
                spawn_thread(self._serve_one, sock, wlock, header, body,
                             name="rpc-priority", daemon=True)
                return
        self._submit(self._serve_one, sock, wlock, header, body)

    def _submit(self, fn, *args) -> None:
        """One task to the pool, counted busy until it finishes."""
        with self._busy_lock:
            self._busy += 1
            depth = self._busy - self.POOL_WORKERS
        if depth > 0:
            self._depth_gauge.set(depth)
        try:
            self._pool.submit(self._run_pooled, fn, *args)
        except RuntimeError:   # stopping: the pool is shut down
            with self._busy_lock:
                self._busy -= 1
            raise

    def _run_pooled(self, fn, *args) -> None:
        try:
            fn(*args)
        finally:
            with self._busy_lock:
                self._busy -= 1
                depth = self._busy - self.POOL_WORKERS
            self._depth_gauge.set(max(0, depth))

    def _serve_one(self, sock, wlock, header: RpcHeader, body: bytes) -> None:
        resp = RpcHeader(seq=header.seq, code=header.code, is_response=True)
        out = b""
        t0 = time.perf_counter()
        # a traced frame: the handler's whole stack (replication, plog,
        # engine spans) records into the caller's trace
        scope = (REQUEST_TRACER.serve(
            TraceContext(header.trace_id, header.trace_sampled, remote=True),
            header.code) if header.trace_id else nullcontext())
        with scope:
            try:
                fn = self._handlers.get(header.code)
                if fn is None:
                    resp.error = ERR_HANDLER_NOT_FOUND
                    resp.error_text = header.code
                else:
                    call = fn
                    for mw in reversed(self._middlewares):
                        call = (lambda h, b, _mw=mw, _next=call:
                                _mw(h.code, h, b, _next))
                    out = call(header, body)
            except RpcError as e:
                resp.error, resp.error_text = e.err, e.text
            except Exception as e:  # handler failure -> error, not a dead conn
                resp.error, resp.error_text = ERR_INVALID_DATA, repr(e)
        self._c_qps.increment()
        self._c_lat.set(int((time.perf_counter() - t0) * 1e6))
        if resp.error:
            self._c_err.increment()
        try:
            _send_frame(sock, resp, out, lock=wlock)
        except (ConnectionError, OSError):
            pass

    def _dispatch_batch(self, sock, wlock, code: str, frames) -> None:
        """Dispatch a hot-code batch the reader coalesced: ONE pool task,
        ONE handler call, ONE coalesced reply write. Per-frame dispatch
        instead when the serve.native fail point triggers, when any frame
        carries a trace context, or when middlewares are installed; the
        per-frame twin writes byte-identical responses."""
        batch_ok = True
        try:
            if fail_point("serve.native") is not None:
                batch_ok = False
        except FailPointError:
            batch_ok = False
        if (not batch_ok or self._middlewares
                or any(h.trace_id for h, _ in frames)):
            for header, body in frames:
                self._dispatch(sock, wlock, header, body)
            return
        # serve.dispatch fires once per batch: the batch IS one dispatch
        try:
            fail_point("serve.dispatch")
        except FailPointError as e:
            self._c_err.increment(len(frames))
            for h, _ in frames:
                if h.app_id:
                    TABLE_STATS.charge_app_error(h.app_id)
            try:
                _send_frames(sock, [(RpcHeader(
                    seq=h.seq, code=h.code, is_response=True,
                    error=ERR_BUSY, error_text=str(e)), b"")
                    for h, _ in frames], lock=wlock)
            except (ConnectionError, OSError):
                pass
            return
        self._submit(self._serve_batch, sock, wlock, code, frames)

    def _serve_batch(self, sock, wlock, code: str, frames) -> None:
        t0 = time.perf_counter()
        headers = [h for h, _ in frames]
        bodies = [b for _, b in frames]
        try:
            results = self._batch_handlers[code](headers, bodies)
        except Exception as e:  # handler failure -> errors, not a dead conn
            results = [e] * len(frames)
        pairs, n_err = [], 0
        for header, res in zip(headers, results):
            resp = RpcHeader(seq=header.seq, code=header.code,
                             is_response=True)
            out = b""
            if isinstance(res, RpcError):
                resp.error, resp.error_text = res.err, res.text
            elif isinstance(res, BaseException):
                resp.error, resp.error_text = ERR_INVALID_DATA, repr(res)
            else:
                out = res
            if resp.error:
                n_err += 1
            pairs.append((resp, out))
        # the per-frame path's counter cardinality: one qps tick and one
        # latency sample per frame (the batch shares its elapsed time)
        elapsed = int((time.perf_counter() - t0) * 1e6)
        self._c_qps.increment(len(frames))
        for _ in frames:
            self._c_lat.set(elapsed)
        if n_err:
            self._c_err.increment(n_err)
        try:
            _send_frames(sock, pairs, lock=wlock)
        except (ConnectionError, OSError):
            pass


class RpcConnection:
    """One full-duplex client connection with pipelined calls.

    shard: any hashable marking this connection as carrying exactly one
    partition's traffic (the ConnectionPool's shard key); its frames set
    RpcHeader.sharded, which lets a pegasus_tpu partition-group node hand
    the whole connection to the owning group executor."""

    def __init__(self, addr, connect_timeout: float = 5.0, shard=None):
        self.addr = tuple(addr)
        self.shard = shard
        self._sock = socket.create_connection(self.addr,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        # request/response pairs: Nagle + delayed ACK would stall them
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending = {}   # seq -> (event, slot)  #: guarded_by self._plock
        self._seq = 0        #: guarded_by self._plock
        self._dead = None
        self._reader = spawn_thread(self._read_loop, name="rpc-conn-reader",
                                    daemon=True)

    def _read_loop(self):
        try:
            reader = _FrameReader(self._sock)
            while True:
                frames = reader.wave()
                with self._plock:
                    ents = [(self._pending.pop(h.seq, None), h, b)
                            for h, b in frames]
                for ent, header, body in ents:
                    if ent:
                        ev, slot = ent
                        slot.append((header, body))
                        ev.set()
        except (ConnectionError, OSError, codec.CodecError) as e:
            self._dead = e
            with self._plock:
                pending = list(self._pending.values())
                self._pending.clear()
            for ev, slot in pending:
                slot.append(None)
                ev.set()

    def _register(self, code: str, app_id: int = 0, pidx: int = 0,
                  phash: int = 0):
        """-> (seq, event, slot, header) of one new pending call; the
        header carries the thread's active trace context."""
        with self._plock:
            self._seq += 1
            seq = self._seq
            ev, slot = threading.Event(), []
            self._pending[seq] = (ev, slot)
        ctx = REQUEST_TRACER.current()
        return seq, ev, slot, RpcHeader(
            seq=seq, code=code, app_id=app_id, partition_index=pidx,
            partition_hash=phash, trace_id=ctx.trace_id if ctx else 0,
            trace_sampled=bool(ctx and ctx.sampled),
            sharded=self.shard is not None)

    def _result(self, slot):
        if not slot or slot[0] is None:
            raise RpcError(ERR_NETWORK_FAILURE, str(self._dead))
        rh, rbody = slot[0]
        if rh.error != ERR_OK:
            raise RpcError(rh.error, rh.error_text)
        return rh, rbody

    def call(self, code: str, body: bytes, app_id: int = 0,
             partition_index: int = 0, partition_hash: int = 0,
             timeout: float = 10.0):
        """-> (RpcHeader, body bytes); raises RpcError on rpc-level
        failure."""
        if self._dead:
            raise RpcError(ERR_NETWORK_FAILURE, str(self._dead))
        seq, ev, slot, header = self._register(code, app_id, partition_index,
                                               partition_hash)
        with REQUEST_TRACER.span(f"rpc.{code}", bytes=len(body)):
            try:
                _send_frame(self._sock, header, body, lock=self._wlock)
            except (ConnectionError, OSError) as e:
                with self._plock:
                    self._pending.pop(seq, None)
                raise RpcError(ERR_NETWORK_FAILURE, str(e))
            if not ev.wait(timeout):
                with self._plock:
                    self._pending.pop(seq, None)
                raise RpcError(ERR_TIMEOUT, f"{code} after {timeout}s")
        return self._result(slot)

    def call_many(self, calls, timeout: float = 10.0):
        """Pipelined batch of calls: every request frame leaves in ONE
        coalesced socket send, then the responses are collected in issue
        order. Each call is (code, body) or (code, body, app_id, pidx,
        phash), the latter routed like call(). -> [(RpcHeader, body)];
        raises RpcError on the first failure."""
        return self.call_many_collect(self.call_many_send(calls), calls,
                                      timeout)

    def call_many_send(self, calls):
        """Send half of call_many: one coalesced write, -> a pending token
        for call_many_collect. Lets a caller send waves on several
        connections before collecting any."""
        if not calls:
            return []
        if self._dead:
            raise RpcError(ERR_NETWORK_FAILURE, str(self._dead))
        pend, buf = [], bytearray()
        for call in calls:
            code, body = call[0], call[1]
            route = tuple(call[2:5]) if len(call) > 2 else ()
            seq, ev, slot, header = self._register(code, *route)
            pend.append((seq, ev, slot))
            h = codec.encode(header)
            buf += struct.pack("<II", 4 + len(h) + len(body), len(h))
            buf += h
            buf += body
        try:
            with REQUEST_TRACER.span("rpc.call_many", bytes=len(buf),
                                     records=len(calls)):
                with self._wlock:
                    self._sock.sendall(buf)
        except (ConnectionError, OSError) as e:
            with self._plock:
                for seq, _, _ in pend:
                    self._pending.pop(seq, None)
            raise RpcError(ERR_NETWORK_FAILURE, str(e))
        return pend

    def call_many_collect(self, pend, calls, timeout: float = 10.0):
        """Collect half of call_many: the responses in issue order."""
        deadline = time.monotonic() + timeout
        out = []
        for i, (seq, ev, slot) in enumerate(pend):
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                with self._plock:  # abandon everything still in flight
                    for s2, _, _ in pend[i:]:
                        self._pending.pop(s2, None)
                raise RpcError(ERR_TIMEOUT,
                               f"{calls[i][0]} after {timeout}s")
            out.append(self._result(slot))
        return out

    def close(self):
        # shutdown first: a close alone leaves the reader thread blocked
        # in recv, and the peer's serving thread waiting for a frame, for
        # as long as both processes live
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class ConnectionPool:
    """(addr, shard) -> RpcConnection cache with reconnect-on-failure.

    shard=None is one connection per node; a non-None shard keys a
    dedicated connection for one partition's traffic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns = {}  #: guarded_by self._lock

    def get(self, addr, shard=None) -> RpcConnection:
        key = (tuple(addr), shard)
        with self._lock:
            conn = self._conns.get(key)
        if conn is not None and not conn._dead:
            return conn
        # connect outside the pool lock: a black-holed peer blocks for the
        # connect timeout and must not serialize every other caller
        fresh = RpcConnection(key[0], shard=shard)
        with self._lock:
            cur = self._conns.get(key)
            if cur is not None and not cur._dead and cur is not conn:
                fresh.close()  # lost the race to another connector
                return cur
            self._conns[key] = fresh
        return fresh

    def invalidate(self, addr) -> None:
        """Drop every shard's connection to addr (a dead node is dead for
        all of its partitions)."""
        addr = tuple(addr)
        with self._lock:
            dead = [k for k in self._conns if k[0] == addr]
            conns = [self._conns.pop(k) for k in dead]
        for c in conns:
            c.close()

    def close(self):
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
