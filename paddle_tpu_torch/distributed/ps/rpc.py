"""The RPC fabric: framing, extension verbs, retries, breakers, errors.

Counterpart of the fabric part of `paddle_tpu/distributed/ps/rpc.py`,
copied: the header and frames, both riders, the opcode numbers, the
retry loop, the circuit breakers, the in-band error frames, the fault
sites and the `ps_*` metric families are the JAX module's, so a JAX
client talks to a port server and a port client to a JAX server, byte
for byte. The serving fleet's verbs (`serving/distributed/worker.py`)
ride it as extension verbs.

Wire format (little-endian):
  header:   u8 op | u32 n | u32 aux
  PING/STOP hdr                        -> u32 0
  extension hdr | n payload bytes      -> u32 len | len bytes
  error     any request                -> u32 0xFFFFFFFF | u32 len | text

Riders: with an active trace (`observability.tracecontext`) the client
sets 0x80 in the op byte and appends `16B trace_id | 8B client_span_id`
after the header; the server parents its handler span under that remote
span. 0x40 marks a `u64 client_id | u64 seq` request id after the header
(after the trace context when both are set), which the JAX server's PUSH
dedups on. The server parses both riders on every frame, so unflagged
and flagged frames of either package are served alike.

Self-healing: `ShardClientBase._exchange` retries transport failures
(reset, refused, timeout, or the `ps.rpc.connect` / `ps.rpc.send` fault
sites) with exponential backoff and jitter, under a bounded attempt
count and an optional per-verb deadline (`RetryPolicy`); only verbs
registered idempotent (or read-only) are retried. A per-endpoint circuit
breaker opens after N consecutive transport failures, fast-fails while
open (`PSUnavailableError`) and half-opens one probe after a cooldown. A
handler that raises answers with an in-band error frame
(`PSServerError` at the caller) and the connection stays usable.

PULL, PUSH and the graph verbs (GSAMPLE, GFEAT, GDEGREE) keep their
opcodes, but the port's server carries no sparse or graph table until
ROADMAP A.13: it consumes their bodies and answers with the error frame
a JAX `PSServer` without a table answers. An unknown op closes the
connection, as the JAX server does.

Metrics: `ps_client_request_seconds` / `ps_server_request_seconds` per
verb, `ps_client_bytes_total` / `ps_server_bytes_total`,
`ps_client_pool_connections`, `ps_errors_total{side}`,
`ps_retries_total{verb}` and `ps_breaker_state{endpoint}` (0 closed, 1
open, 2 half-open), in the port's own registry.
"""
import itertools
import os
import random
import socket
import struct
import threading
import time


from ...observability import faults as _faults
from ...observability import metrics as _metrics
from ...observability import tracecontext as _tc
from ...profiler import TracerEventType, _tracer

__all__ = ["OP_PULL", "OP_PUSH", "OP_PING", "OP_STOP", "OP_GSAMPLE",
           "OP_GFEAT", "OP_GDEGREE", "READONLY_VERBS", "register_verb",
           "RetryPolicy", "PSServer", "ShardClientBase", "PSServerError",
           "PSUnavailableError"]

OP_PULL, OP_PUSH, OP_PING, OP_STOP = 0, 1, 2, 3
OP_GSAMPLE, OP_GFEAT, OP_GDEGREE = 4, 5, 6
_OP_NAMES = {OP_PULL: "PULL", OP_PUSH: "PUSH", OP_PING: "PING",
             OP_STOP: "STOP", OP_GSAMPLE: "GSAMPLE", OP_GFEAT: "GFEAT",
             OP_GDEGREE: "GDEGREE"}


# verbs declared side-effect-free at registration: the fleet
# observability sweep (OP_METRICS / OP_DUMP) polls every worker on an
# interval, and a read-only verb is safe to retry, safe to fan out to a
# sick host, and safe to drop on failure — the federator skips dark
# members instead of erroring the poll. Introspectable so tools can
# assert their polling path never carries a mutating verb.
READONLY_VERBS = frozenset()


def register_verb(op, name, idempotent=False, readonly=False):
    """Register an EXTENSION verb on the shared fabric (the serving
    KV-handoff and control verbs ride it, inheriting the retry loop,
    breakers, trace propagation, byte/latency metrics, and in-band error
    frames).

    `op` must stay below 0x40 so the 0x40/0x80 header-flag riders remain
    unambiguous. Extension verbs are served by PSServer `handlers` (see
    PSServer.__init__); `idempotent=True` opts the verb into the client
    retry loop — extension verbs must make that safe themselves (e.g.
    dedup by an application-level request key). `readonly=True`
    additionally declares the verb side-effect-free (implies idempotent;
    see READONLY_VERBS) — the contract the fleet metrics federation
    sweep rides."""
    global _IDEMPOTENT_OPS, READONLY_VERBS
    op = int(op)
    if not 0 <= op < REQID_FLAG:
        raise ValueError(f"verb op {op} collides with the header flag "
                         f"bits (must be < {REQID_FLAG:#x})")
    if _OP_NAMES.get(op, name) != name:
        raise ValueError(f"verb op {op} already registered as "
                         f"{_OP_NAMES[op]!r}")
    _OP_NAMES[op] = name
    if idempotent or readonly:
        _IDEMPOTENT_OPS = _IDEMPOTENT_OPS | {op}
    if readonly:
        READONLY_VERBS = READONLY_VERBS | {op}
_HDR = struct.Struct("<BII")
_GS = struct.Struct("<iBH")       # seed | weighted | edge-type length
_TL = struct.Struct("<H")         # type-name length
_U32 = struct.Struct("<I")
# op-byte flag: a PUSH retry-dedup id rides the frame — `u64 client_id |
# u64 seq` right after the header (after the 0x80 trace ctx when both
# are set). The id is fixed across retries of one logical push.
REQID_FLAG = 0x40
_REQID = struct.Struct("<QQ")
_OP_MASK = ~(_tc.WIRE_FLAG | REQID_FLAG) & 0xFF
# verbs the retry loop may replay without a dedup id (read-only or
# harmlessly repeatable); PUSH joins them via the REQID rider
_IDEMPOTENT_OPS = frozenset((OP_PULL, OP_PING, OP_GSAMPLE, OP_GFEAT,
                             OP_GDEGREE))
# a response whose leading u32 is the sentinel carries `u32 len | len bytes`
# of error text instead of payload — serving errors (unknown edge type, no
# graph on this server, bad shapes) reach the caller as PSServerError with
# the real cause, and the connection stays usable
_ERR = 0xFFFFFFFF

# RPC-fabric metrics (module-level families: every client/server in the
# process reports into the same labeled series)
_M_CLIENT_SECONDS = _metrics.histogram(
    "ps_client_request_seconds",
    "PS RPC client round-trip latency per verb", labelnames=("verb",))
_M_SERVER_SECONDS = _metrics.histogram(
    "ps_server_request_seconds",
    "PS RPC server handler time per verb", labelnames=("verb",))
_M_CLIENT_BYTES = _metrics.counter(
    "ps_client_bytes_total",
    "PS RPC client wire bytes per verb and direction",
    labelnames=("verb", "direction"))
_M_SERVER_BYTES = _metrics.counter(
    "ps_server_bytes_total",
    "PS RPC server wire bytes per verb and direction",
    labelnames=("verb", "direction"))
_M_POOL = _metrics.gauge(
    "ps_client_pool_connections",
    "Open PS client pool sockets in this process")
_M_ERRORS = _metrics.counter(
    "ps_errors_total",
    "In-band PS error frames, by which side observed them",
    labelnames=("side",))
_M_RETRIES = _metrics.counter(
    "ps_retries_total",
    "PS RPC client attempts beyond the first, per verb",
    labelnames=("verb",))
_M_BREAKER = _metrics.gauge(
    "ps_breaker_state",
    "Per-shard circuit breaker state (0 closed, 1 open, 2 half-open)",
    labelnames=("endpoint",))


class PSServerError(RuntimeError):
    """A server-side serving error relayed over the wire verbatim."""


class PSUnavailableError(ConnectionError):
    """A shard stayed dark: retries exhausted, the per-verb deadline
    passed, or its circuit breaker is open."""


def _env_float(name, default):
    raw = os.environ.get(name)
    return float(raw) if raw else default


class RetryPolicy:
    """Backoff schedule + bounds for the `_exchange` retry loop.

    `deadline_s` caps one logical request's total wall time; it can be a
    float (every verb) or a {verb: seconds} dict (per-verb deadlines —
    e.g. a tight PULL budget with a looser GSAMPLE one). Env defaults:
    PTN_PS_RETRY_MAX (attempts, 5), PTN_PS_RETRY_BASE_S (0.05),
    PTN_PS_RETRY_DEADLINE_S (unset = unbounded)."""

    def __init__(self, max_attempts=None, base_delay_s=None,
                 max_delay_s=2.0, jitter=0.5, deadline_s=None, seed=None):
        self.max_attempts = max(1, int(
            max_attempts if max_attempts is not None
            else _env_float("PTN_PS_RETRY_MAX", 5)))
        self.base_delay_s = (base_delay_s if base_delay_s is not None
                             else _env_float("PTN_PS_RETRY_BASE_S", 0.05))
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        if deadline_s is None:
            deadline_s = _env_float("PTN_PS_RETRY_DEADLINE_S", 0.0) or None
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)

    def deadline_for(self, verb):
        if isinstance(self.deadline_s, dict):
            return self.deadline_s.get(verb)
        return self.deadline_s

    def backoff(self, attempt):
        """Sleep before retry number `attempt` (1-based): exponential,
        capped, with subtractive jitter so synchronized clients fan out."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s)
        return d * (1.0 - self.jitter * self._rng.random())


class _Breaker:
    """Per-shard circuit breaker: CLOSED -> (N consecutive transport
    failures) -> OPEN (fast-fail) -> cooldown -> HALF_OPEN (one probe) ->
    CLOSED on success / OPEN on failure."""

    _STATES = {"closed": 0, "open": 1, "half-open": 2}

    def __init__(self, threshold, cooldown_s, endpoint,
                 clock=time.monotonic):
        self._threshold = max(1, int(threshold))
        self._cooldown = float(cooldown_s)
        self._clock = clock
        self.endpoint = endpoint
        self.state = "closed"
        self._fails = 0
        self._open_until = 0.0
        self._probe_expires = 0.0
        self._lock = threading.Lock()
        _M_BREAKER.labels(endpoint=endpoint).set(0)

    def _set(self, state):
        self.state = state
        _M_BREAKER.labels(endpoint=self.endpoint).set(self._STATES[state])

    def allow(self):
        """May a request go out now? Grants one probe per cooldown while
        not closed. A probe that never reports back (an exception outside
        the transport classes escaped the retry loop) expires after a
        cooldown and a new probe is granted — half-open can never become
        a permanent dark state."""
        with self._lock:
            if self.state == "closed":
                return True
            now = self._clock()
            if self.state == "open" and now >= self._open_until:
                self._set("half-open")
                self._probe_expires = now + self._cooldown
                return True
            if self.state == "half-open" and now >= self._probe_expires:
                self._probe_expires = now + self._cooldown
                return True
            return False              # open and cooling, or probe in flight

    def ok(self):
        with self._lock:
            self._fails = 0
            if self.state != "closed":
                self._set("closed")

    def fail(self):
        """Record a transport failure; returns True when the breaker is
        (now) open, so callers can stop retrying."""
        with self._lock:
            self._fails += 1
            if self.state == "half-open" or self._fails >= self._threshold:
                self._open_until = self._clock() + self._cooldown
                self._set("open")
            return self.state == "open"


class _MeteredSock:
    """Socket proxy that counts wire bytes both ways — the client byte
    metrics stay exact without touching any reader closure."""

    __slots__ = ("_s", "sent_bytes", "recv_bytes")

    def __init__(self, s):
        self._s = s
        self.sent_bytes = 0
        self.recv_bytes = 0

    def sendall(self, data):
        self._s.sendall(data)
        self.sent_bytes += len(data)

    def recv_into(self, buf, nbytes=0):
        r = self._s.recv_into(buf, nbytes)
        self.recv_bytes += r
        return r


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


class PSServer:
    """Serves extension verbs (`handlers`) plus PING and STOP over TCP.
    `port=0` picks a free port (exposed as .port after start)."""

    def __init__(self, host="127.0.0.1", port=0, handlers=None):
        # extension verbs (register_verb): {op: fn(payload_bytes, aux,
        # reqid, rctx) -> response payload bytes}. The server consumes
        # the n-byte body BEFORE dispatch (header n = payload length for
        # extension verbs), so a raising handler leaves the stream in
        # sync and answers with an in-band error frame. rctx is the
        # caller's (trace_id, span_id) or None, for handlers that fan
        # out further RPCs under the same trace.
        self.handlers = dict(handlers or {})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._conns = set()          # live connection sockets (chaos kill)
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                # closing the listener does not interrupt a blocked
                # accept() on every kernel: a connect racing shutdown
                # can still be handed to us — refuse it, or a "dead"
                # server would keep serving one ghost connection
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        mconn = _MeteredSock(conn)      # request/response bytes per verb
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while True:
                b0 = mconn.recv_bytes
                op, n, aux = _HDR.unpack(_recv_exact(mconn, _HDR.size))
                rctx = None
                if op & _tc.WIRE_FLAG:
                    # trace context rides the frame: strip the flag, read
                    # the 24 ctx bytes, parent our span under the caller's
                    rctx = _tc.unpack_ctx(
                        _recv_exact(mconn, _tc.CTX_WIRE_BYTES))
                reqid = None
                if op & REQID_FLAG:
                    # PUSH retry-dedup id (client_id, seq)
                    reqid = _REQID.unpack(
                        _recv_exact(mconn, _REQID.size))
                op &= _OP_MASK
                if op == OP_STOP:
                    self._stop.set()
                    try:
                        self._sock.close()
                    finally:
                        mconn.sendall(_U32.pack(0))
                    return
                if op == OP_PING:
                    mconn.sendall(_U32.pack(0))
                    continue
                if op in (OP_PULL, OP_PUSH):
                    handler = self._serve_sparse
                elif op in (OP_GSAMPLE, OP_GFEAT, OP_GDEGREE):
                    handler = self._serve_graph
                elif op in self.handlers:
                    ext = self.handlers[op]

                    def handler(conn, op, n, aux, reqid, _ext=ext,
                                _rctx=rctx):
                        body = _recv_exact(conn, n)   # sync before dispatch
                        # gray-worker chaos: the body is
                        # already consumed, so `slow` stalls and `flaky`
                        # errors leave the stream in sync — the client
                        # sees latency or an in-band error frame, never
                        # a torn connection. Keyed by our endpoint so
                        # one worker in a shared process can be gray.
                        spec = _faults.fire("serving.rpc.serve",
                                            key=self.endpoint)
                        if spec is not None and spec.mode == "flaky":
                            raise spec._exception()
                        out = _ext(body, aux, reqid, _rctx)
                        return _U32.pack(len(out)) + out
                else:
                    raise ConnectionError(f"unknown op {op}")
                verb = _OP_NAMES.get(op, str(op))
                span = _tracer.begin(f"ps.server::{verb}",
                                     TracerEventType.Communication,
                                     attrs={"n": int(n)})
                if span is not None and rctx is not None:
                    # cross-process parenting: the remote client span is
                    # this span's parent, in the caller's trace
                    span["trace"], span["parent"] = rctx
                t0 = time.perf_counter()
                try:
                    # handlers consume the FULL request body before any
                    # table/graph work, so a serving error leaves the
                    # stream in sync and we can answer with an error frame
                    # instead of killing the connection
                    resp = handler(mconn, op, n, aux, reqid)
                except (ConnectionError, OSError):
                    _tracer.cancel(span)
                    raise
                except Exception as e:  # noqa: BLE001 — relayed to caller
                    msg = f"{type(e).__name__}: {e}".encode()[:65536]
                    resp = _U32.pack(_ERR) + _U32.pack(len(msg)) + msg
                    _M_ERRORS.labels(side="server").inc()
                    if span is not None:
                        span.setdefault("attrs", {})["error"] = msg.decode(
                            errors="replace")[:200]
                finally:
                    _M_SERVER_SECONDS.labels(verb=verb).observe(
                        time.perf_counter() - t0)
                if span is not None and span.get("dur") is None:
                    _tracer.end(span)
                _M_SERVER_BYTES.labels(verb=verb, direction="in").inc(
                    mconn.recv_bytes - b0)
                _M_SERVER_BYTES.labels(verb=verb, direction="out").inc(
                    len(resp))
                mconn.sendall(resp)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def close_connections(self):
        """Abruptly sever every live connection (the in-process half of
        a host-death simulation: peers see resets mid-frame, exactly as
        if the process were SIGKILLed). `shutdown()` deliberately does
        NOT do this — established connections normally drain on their
        own."""
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    @staticmethod
    def _serve_sparse(conn, op, n, dim, reqid=None):
        """PULL/PUSH: consume the body, then answer as a JAX server
        without a sparse table does (ROADMAP A.13 brings the tables)."""
        _recv_exact(conn, 8 * n)
        if op == OP_PUSH:
            _recv_exact(conn, 4 * n * dim)
        raise PSServerError("this server carries no sparse table")

    @staticmethod
    def _serve_graph(conn, op, n, aux, reqid=None):
        """GSAMPLE/GFEAT/GDEGREE: consume the body, then answer as a JAX
        server without a graph table does."""
        if op == OP_GSAMPLE:
            _, _, tlen = _GS.unpack(_recv_exact(conn, _GS.size))
        else:
            (tlen,) = _TL.unpack(_recv_exact(conn, _TL.size))
        _recv_exact(conn, tlen)
        _recv_exact(conn, 8 * n)
        raise PSServerError("this server carries no graph table")

    def shutdown(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class ShardClientBase:
    """Per-endpoint connection pool every fabric client builds on:
    one lazy socket + lock per shard server (requests serialized per
    connection, pipelined across shards), framing-desync recovery by
    dropping a half-consumed socket, and the self-healing layer: retry
    policy + per-shard circuit breakers (see `_exchange`).

    Timeouts: `connect_timeout_s` bounds the TCP connect (env
    PTN_PS_CONNECT_TIMEOUT_S, default 30); `request_timeout_s` is the
    per-request socket timeout once connected (env
    PTN_PS_REQUEST_TIMEOUT_S, default 30 — matching the pre-retry
    fabric, so a hung-but-connected server always surfaces; 0 = block
    forever) — a timed-out request is a transport failure and goes
    through the retry path like any reset."""

    def __init__(self, endpoints, connect_timeout_s=None,
                 request_timeout_s=None, retry=None, breaker_threshold=None,
                 breaker_cooldown_s=None):
        self.endpoints = list(endpoints)
        self._socks = [None] * len(self.endpoints)
        self._locks = [threading.Lock() for _ in self.endpoints]
        self._connect_timeout = (
            connect_timeout_s if connect_timeout_s is not None
            else _env_float("PTN_PS_CONNECT_TIMEOUT_S", 30.0))
        if request_timeout_s is None:
            request_timeout_s = _env_float(
                "PTN_PS_REQUEST_TIMEOUT_S", 30.0) or None
        elif request_timeout_s == 0:
            request_timeout_s = None
        self._request_timeout = request_timeout_s
        self.retry = retry if retry is not None else RetryPolicy()
        thr = (breaker_threshold if breaker_threshold is not None
               else _env_float("PTN_PS_BREAKER_THRESHOLD", 5))
        cool = (breaker_cooldown_s if breaker_cooldown_s is not None
                else _env_float("PTN_PS_BREAKER_COOLDOWN_S", 1.0))
        self._breakers = [_Breaker(thr, cool, ep) for ep in self.endpoints]
        # PUSH dedup identity: unique per client instance AND per pid —
        # re-randomized after a fork, or parent and child would emit
        # colliding (client_id, seq) pairs and the server would silently
        # drop one side's gradients as duplicates. The seq is assigned
        # once per logical push, BEFORE the retry loop.
        self._push_ident = None          # (pid, client_id, counter)
        self._push_ident_lock = threading.Lock()

    def _next_push_reqid(self):
        with self._push_ident_lock:
            if self._push_ident is None or \
                    self._push_ident[0] != os.getpid():
                self._push_ident = (os.getpid(),
                                    struct.unpack("<Q", os.urandom(8))[0],
                                    itertools.count(1))
            _, client_id, counter = self._push_ident
            return client_id, next(counter)

    def _sock(self, i, connect_timeout=None):
        if self._socks[i] is None:
            host, port = self.endpoints[i].rsplit(":", 1)
            try:
                _faults.fire("ps.rpc.connect")
                s = socket.create_connection(
                    (host, int(port)),
                    timeout=self._connect_timeout if connect_timeout is None
                    else connect_timeout)
            except OSError:
                _M_ERRORS.labels(side="client").inc()
                raise
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self._request_timeout)
            self._socks[i] = s
            _M_POOL.inc()
        return self._socks[i]

    def _drop_sock(self, i):
        if self._socks[i] is not None:
            try:
                self._socks[i].close()
            except OSError:
                pass
            self._socks[i] = None
            _M_POOL.dec()

    def _exchange(self, i, msg, reader):
        """Send one framed request to shard i, parse the reply with
        `reader(sock)` under the per-shard lock — retrying transport
        failures until the verb's budget runs out.

        This is the fabric's single choke point, so both the
        observability riders and the self-healing live here: a
        `ps.client::<verb>` span whose id travels in the frame when a
        trace is active (the 0x80 header-flag path), the per-verb latency
        histogram, exact sent/received byte counts, the PUSH dedup id
        (0x40 rider, fixed across retries), the retry loop
        (reconnect-on-retry, exponential backoff + jitter, bounded
        attempts, per-verb deadline), and the shard's circuit breaker.
        An exhausted budget or an open breaker surfaces as
        PSUnavailableError; a PSServerError reply counts as fabric
        HEALTH (the server answered) and is never retried."""
        op = msg[0]
        verb = _OP_NAMES.get(op, str(op))
        breaker = self._breakers[i]
        if not breaker.allow():
            raise PSUnavailableError(
                f"shard {i} ({self.endpoints[i]}) circuit breaker is open")
        span = _tracer.begin(f"ps.client::{verb}",
                             TracerEventType.Communication,
                             attrs={"shard": i,
                                    "endpoint": self.endpoints[i]})
        # riders: trace ctx (0x80) then PUSH dedup id (0x40); the wire
        # frame is built ONCE so retries replay the identical bytes —
        # the dedup guarantee depends on the seq not changing
        flags, riders = 0, b""
        trace_id = _tc.current_trace_id()
        if trace_id is not None:
            span_id = span["span_id"] if span is not None \
                else _tc.new_span_id()
            flags |= _tc.WIRE_FLAG
            riders += _tc.pack_ctx(trace_id, span_id)
        if op == OP_PUSH:
            flags |= REQID_FLAG
            riders += _REQID.pack(*self._next_push_reqid())
        if flags:
            msg = (bytes((op | flags,)) + msg[1:_HDR.size] + riders
                   + msg[_HDR.size:])
        retryable = op in _IDEMPOTENT_OPS or op == OP_PUSH
        deadline_s = self.retry.deadline_for(verb)
        deadline = (time.monotonic() + deadline_s) if deadline_s else None
        attempt = 0
        last_exc = None
        try:
            while True:
                if deadline is not None and last_exc is not None \
                        and time.monotonic() >= deadline:
                    # the deadline expired DURING backoff: give up on the
                    # real failure we already counted — no synthetic
                    # attempt, no extra breaker.fail(), no ~0s histogram
                    # sample
                    raise PSUnavailableError(
                        f"shard {i} ({self.endpoints[i]}) unavailable "
                        f"after {attempt} attempt(s) for {verb}: deadline "
                        f"exhausted") from last_exc
                attempt += 1
                # per-ATTEMPT latency: one histogram sample per wire
                # round-trip, backoff sleeps excluded — chaos must not
                # masquerade as server latency in the comparisons
                t0 = time.perf_counter()
                try:
                    try:
                        with self._locks[i]:
                            try:
                                _faults.fire("ps.rpc.send")
                                # the deadline bounds BLOCKING attempts
                                # too: the CONNECT and this attempt's
                                # socket timeout both shrink to the
                                # remaining budget
                                left = None
                                if deadline is not None:
                                    left = deadline - time.monotonic()
                                    if left <= 0:
                                        raise socket.timeout(
                                            f"{verb} deadline exhausted")
                                raw = self._sock(
                                    i, connect_timeout=None if left is None
                                    else min(left, self._connect_timeout))
                                if left is not None:
                                    raw.settimeout(
                                        min(left, self._request_timeout)
                                        if self._request_timeout else left)
                                s = _MeteredSock(raw)
                                s.sendall(msg)
                                # reply-lost window (the PUSH-dedup case)
                                _faults.fire("ps.rpc.send")
                                out = reader(s)
                            except PSServerError:
                                # error frame fully consumed: stream in sync
                                _M_ERRORS.labels(side="client").inc()
                                raise
                            except Exception:
                                # a half-consumed socket would desynchronize
                                # the framing for every later request: drop
                                # it so the next attempt reconnects
                                self._drop_sock(i)
                                raise
                            finally:
                                # the shrunken per-attempt timeout must not
                                # outlive the attempt — a kept socket (e.g.
                                # after a PSServerError reply) would time
                                # out later healthy requests spuriously
                                if deadline is not None and \
                                        self._socks[i] is not None:
                                    try:
                                        self._socks[i].settimeout(
                                            self._request_timeout)
                                    except OSError:
                                        pass
                    finally:
                        _M_CLIENT_SECONDS.labels(verb=verb).observe(
                            time.perf_counter() - t0)
                    _M_CLIENT_BYTES.labels(verb=verb, direction="sent").inc(
                        s.sent_bytes)
                    _M_CLIENT_BYTES.labels(verb=verb, direction="recv").inc(
                        s.recv_bytes)
                    breaker.ok()
                    if span is not None and attempt > 1:
                        span.setdefault("attrs", {})["attempts"] = attempt
                    return out
                except PSServerError:
                    breaker.ok()          # the shard answered: fabric fine
                    raise
                except (ConnectionError, OSError) as e:
                    last_exc = e
                    now_open = breaker.fail()
                    out_of_budget = (
                        not retryable
                        or attempt >= self.retry.max_attempts
                        or now_open
                        or (deadline is not None
                            and time.monotonic() >= deadline))
                    if out_of_budget:
                        raise PSUnavailableError(
                            f"shard {i} ({self.endpoints[i]}) unavailable "
                            f"after {attempt} attempt(s) for {verb}: "
                            f"{type(e).__name__}: {e}") from e
                    _M_RETRIES.labels(verb=verb).inc()
                    time.sleep(self.retry.backoff(attempt))
        finally:
            _tracer.end(span)

    def _ack(self, s):
        (n,) = _U32.unpack(_recv_exact(s, 4))
        if n == _ERR:
            (ln,) = _U32.unpack(_recv_exact(s, 4))
            raise PSServerError(_recv_exact(s, ln).decode())
        return n

    def ping(self):
        for i in range(len(self.endpoints)):
            self._exchange(i, _HDR.pack(OP_PING, 0, 0), self._ack)
        return True

    def stop_servers(self):
        for i in range(len(self.endpoints)):
            try:
                self._exchange(i, _HDR.pack(OP_STOP, 0, 0), self._ack)
            except (ConnectionError, OSError):
                pass

    def close(self):
        for i in range(len(self._socks)):
            self._drop_sock(i)


