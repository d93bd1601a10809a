"""The port's RPC fabric against the JAX package's, on the CPU.

`paddle_tpu_torch.distributed.ps.rpc` copies the fabric part of
`paddle_tpu/distributed/ps/rpc.py`. Over an echo extension verb
registered in both packages' verb tables:

  * an in-band error frame reaches the caller as `PSServerError` and the
    connection stays usable;
  * injected `ps.rpc.connect` / `ps.rpc.send` drops are retried and the
    replies come back unchanged (after `tests/test_faults.py`);
  * the circuit breaker opens after its threshold, fast-fails, and a
    half-open probe after the cooldown closes it
    (`test_faults.py:293`); a deadline bounds a server that accepts and
    never answers (`:354`), and per-verb deadlines hold (`:410`);
  * the read-only verb contract of the serving verbs
    (`test_fleet.py:495`);
  * with an active trace, the server span parents under the remote
    client span;
  * wire equality: a JAX client calls a port server and a port client a
    JAX server, and each server answers the same raw frames (PING, the
    echo verb, a handler error, PULL without a table, both riders) with
    the same bytes.

Metric values are read as deltas: registries are process-global.
"""
import socket
import struct
import time

import pytest

import paddle_tpu  # noqa: F401
from paddle_tpu.distributed.ps import rpc as jrpc
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import tracecontext as jtc
from paddle_tpu.serving.distributed import worker as jworker
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.distributed.ps import rpc as trpc
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracecontext as ttc
from paddle_tpu_torch.serving.distributed import worker as tworker

OP_ECHO = 60
OP_BOOM = 61
RPC = {"jax": jrpc, "port": trpc}
for _mod in RPC.values():
    _mod.register_verb(OP_ECHO, "ECHO", idempotent=True)
    _mod.register_verb(OP_BOOM, "BOOM", idempotent=True)


def _echo(body, aux, reqid, rctx):
    return b"echo:" + struct.pack("<I", aux) + body


def _boom(body, aux, reqid, rctx):
    raise ValueError(f"bad payload of {len(body)} bytes")


HANDLERS = {OP_ECHO: _echo, OP_BOOM: _boom}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.disarm_all()
    tfaults.disarm_all()
    yield
    jfaults.disarm_all()
    tfaults.disarm_all()


def _server(pkg):
    return RPC[pkg].PSServer(handlers=HANDLERS)


def _fast_retry(pkg, **kw):
    kw.setdefault("max_attempts", 6)
    kw.setdefault("base_delay_s", 0.001)
    kw.setdefault("seed", 0)
    return RPC[pkg].RetryPolicy(**kw)


def _call(client, op, payload, aux=0, i=0):
    """One extension-verb exchange through `client._exchange`: the reply
    payload bytes."""
    rpc = RPC["port"] if isinstance(client, trpc.ShardClientBase) \
        else RPC["jax"]
    msg = rpc._HDR.pack(op, len(payload), aux) + payload

    def reader(s):
        n = client._ack(s)
        return rpc._recv_exact(s, n)
    return client._exchange(i, msg, reader)


def _counter(name, **labels):
    flat = tmetrics.flatten_snapshot(tmetrics.registry().snapshot(),
                                     kinds=("counter",))
    key = name
    if labels:
        key += "{" + ",".join(f"{k}={labels[k]}"
                              for k in sorted(labels)) + "}"
    return flat.get(key, 0.0)


def test_error_frame_keeps_the_connection_usable():
    server = _server("port")
    client = trpc.ShardClientBase([server.endpoint],
                                  retry=_fast_retry("port"))
    before = _counter("ps_errors_total", side="server")
    try:
        assert _call(client, OP_ECHO, b"a", aux=3) == \
            b"echo:" + struct.pack("<I", 3) + b"a"
        sock = client._socks[0]
        with pytest.raises(trpc.PSServerError,
                           match="ValueError: bad payload of 4 bytes"):
            _call(client, OP_BOOM, b"abcd")
        assert client._socks[0] is sock          # kept, stream in sync
        assert _call(client, OP_ECHO, b"b") == \
            b"echo:" + struct.pack("<I", 0) + b"b"
        assert client.ping()
        assert _counter("ps_errors_total", side="server") == before + 1
    finally:
        client.close()
        server.shutdown()


@pytest.mark.parametrize("site", ["ps.rpc.connect", "ps.rpc.send"])
def test_injected_drops_recover(site):
    server = _server("port")
    want = [_echo(bytes([k]) * k, k, None, None) for k in range(1, 9)]
    r0 = _counter("ps_retries_total", verb="ECHO")
    tfaults.arm(site, "drop", p=0.15, seed=3)
    client = trpc.ShardClientBase([server.endpoint],
                                  retry=_fast_retry("port"),
                                  breaker_threshold=100)
    try:
        got = []
        for k in range(1, 9):
            if site == "ps.rpc.connect":
                client._drop_sock(0)            # every call connects
            got.append(_call(client, OP_ECHO, bytes([k]) * k, aux=k))
    finally:
        tfaults.disarm_all()
        client.close()
        server.shutdown()
    assert got == want
    assert _counter("ps_retries_total", verb="ECHO") > r0, \
        "the fault schedule must have forced at least one retry"


def test_breaker_opens_then_half_open_probe_recovers():
    server = _server("port")
    client = trpc.ShardClientBase(
        [server.endpoint], retry=_fast_retry("port", max_attempts=1),
        breaker_threshold=2, breaker_cooldown_s=0.1)
    try:
        endpoint = server.endpoint
        gauge = tmetrics.registry().gauge("ps_breaker_state",
                                          labelnames=("endpoint",))
        tfaults.arm("ps.rpc.send", "drop", max_fires=2)
        with pytest.raises(trpc.PSUnavailableError):
            client.ping()                       # failure 1
        with pytest.raises(trpc.PSUnavailableError):
            client.ping()                       # failure 2 -> OPEN
        assert gauge.labels(endpoint=endpoint).value == 1
        with pytest.raises(trpc.PSUnavailableError,
                           match="breaker is open"):
            client.ping()                       # fast-fail, no socket work
        time.sleep(0.15)                        # cooldown elapses
        assert client.ping()                    # half-open probe succeeds
        assert gauge.labels(endpoint=endpoint).value == 0
    finally:
        tfaults.disarm_all()
        client.close()
        server.shutdown()


def test_deadline_bounds_a_wedged_server():
    """A server that accepts but never replies: the verb's deadline
    becomes the attempt's socket timeout."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    host, port = lsock.getsockname()
    client = trpc.ShardClientBase(
        [f"{host}:{port}"],
        retry=trpc.RetryPolicy(max_attempts=3, base_delay_s=0.01,
                               deadline_s=0.3, seed=0))
    try:
        t0 = time.monotonic()
        with pytest.raises(trpc.PSUnavailableError):
            client.ping()
        assert time.monotonic() - t0 < 3.0
    finally:
        client.close()
        lsock.close()


def test_per_verb_deadline():
    policy = trpc.RetryPolicy(deadline_s={"PULL": 0.5, "PUSH": 2.0})
    assert policy.deadline_for("PULL") == 0.5
    assert policy.deadline_for("PUSH") == 2.0
    assert policy.deadline_for("GSAMPLE") is None
    assert trpc.RetryPolicy(deadline_s=1.0).deadline_for("PULL") == 1.0
    # a per-verb budget bounds that verb on a wedged server
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    host, port = lsock.getsockname()
    client = trpc.ShardClientBase(
        [f"{host}:{port}"],
        retry=trpc.RetryPolicy(max_attempts=2, base_delay_s=0.01,
                               deadline_s={"ECHO": 0.2}, seed=0),
        request_timeout_s=30)
    try:
        t0 = time.monotonic()
        with pytest.raises(trpc.PSUnavailableError):
            _call(client, OP_ECHO, b"x")
        assert time.monotonic() - t0 < 3.0
    finally:
        client.close()
        lsock.close()


def test_readonly_verb_contract():
    """The federation sweep rides declared read-only verbs: METRICS is
    read-only (so idempotent), DUMP is idempotent but not read-only, and
    no mutating serving verb is read-only; the same in both packages."""
    for rpc, w in ((trpc, tworker), (jrpc, jworker)):
        assert w.OP_METRICS in rpc.READONLY_VERBS
        assert w.OP_METRICS in rpc._IDEMPOTENT_OPS
        assert w.OP_DUMP not in rpc.READONLY_VERBS
        assert w.OP_DUMP in rpc._IDEMPOTENT_OPS
        for op in (w.OP_SUBMIT, w.OP_KV_PUT, w.OP_SWAP, w.OP_PREFILL):
            assert op not in rpc.READONLY_VERBS
    assert trpc.READONLY_VERBS == jrpc.READONLY_VERBS
    names = {op: trpc._OP_NAMES[op] for op in range(16, 28)}
    assert names == {op: jrpc._OP_NAMES[op] for op in range(16, 28)}


def test_server_span_parents_under_the_remote_client_span():
    server = _server("port")
    client = trpc.ShardClientBase([server.endpoint])
    tracer = tprofiler._tracer
    tracer.drain()
    tracer.enabled = True
    try:
        with ttc.trace_scope() as tid:
            _call(client, OP_ECHO, b"traced")
        time.sleep(0.05)                 # the server thread ends its span
    finally:
        tracer.enabled = False
        client.close()
        server.shutdown()
    events = tracer.drain()
    cli = [e for e in events if e["name"] == "ps.client::ECHO"]
    srv = [e for e in events if e["name"] == "ps.server::ECHO"]
    assert len(cli) == 1 and len(srv) == 1
    assert cli[0]["trace"] == tid and srv[0]["trace"] == tid
    assert srv[0]["parent"] == cli[0]["span_id"]
    assert srv[0]["tid"] != cli[0]["tid"]


def _raw_exchange(endpoint, frames):
    """Send raw request frames on one connection; the raw reply bytes of
    each (read until the reply's framing is complete)."""
    host, port = endpoint.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5)
    out = []
    try:
        for frame, reply_len in frames:
            s.sendall(frame)
            buf = b""
            while len(buf) < 4:
                buf += s.recv(4 - len(buf))
            (n,) = struct.unpack("<I", buf)
            want = 0 if reply_len == "ack" else n
            if n == 0xFFFFFFFF:
                while len(buf) < 8:
                    buf += s.recv(8 - len(buf))
                want = 4 + struct.unpack("<I", buf[4:8])[0]
            while len(buf) < 4 + want:
                buf += s.recv(4 + want - len(buf))
            out.append(buf)
    finally:
        s.close()
    return out


def test_wire_equality_across_the_packages():
    hdr = trpc._HDR
    ctx = ttc.pack_ctx(ttc.new_trace_id(), ttc.new_span_id())
    reqid = struct.pack("<QQ", 7, 1)
    frames = [
        (hdr.pack(trpc.OP_PING, 0, 0), "ack"),
        (hdr.pack(OP_ECHO, 5, 9) + b"hello", "body"),
        (hdr.pack(OP_ECHO | 0x80, 2, 1) + ctx + b"hi", "body"),
        (hdr.pack(OP_ECHO | 0xC0, 3, 2) + ctx + reqid + b"abc", "body"),
        (hdr.pack(OP_BOOM, 4, 0) + b"oops", "body"),
        (hdr.pack(trpc.OP_PULL, 2, 4) + b"\0" * 16, "body"),
        (hdr.pack(OP_ECHO, 0, 0), "body"),
    ]
    servers = {pkg: _server(pkg) for pkg in RPC}
    try:
        raw = {pkg: _raw_exchange(s.endpoint, frames)
               for pkg, s in servers.items()}
        assert raw["port"] == raw["jax"]
        assert raw["port"][4][:4] == b"\xff\xff\xff\xff"
        assert b"no sparse table" in raw["port"][5]
        # and through each package's client against the other's server
        replies = {}
        for cpkg in RPC:
            for spkg, s in servers.items():
                c = RPC[cpkg].ShardClientBase([s.endpoint])
                try:
                    with (ttc if cpkg == "port" else jtc).trace_scope():
                        r = [_call(c, OP_ECHO, b"x" * k, aux=k)
                             for k in range(3)]
                    with pytest.raises(RPC[cpkg].PSServerError,
                                       match="bad payload of 2 bytes"):
                        _call(c, OP_BOOM, b"zz")
                    assert c.ping()
                    replies[cpkg, spkg] = r
                finally:
                    c.close()
        assert len(set(map(tuple, replies.values()))) == 1
    finally:
        for s in servers.values():
            s.shutdown()


def test_unknown_op_closes_the_connection_in_both():
    servers = {pkg: _server(pkg) for pkg in RPC}
    try:
        for s in servers.values():
            host, port = s.endpoint.rsplit(":", 1)
            c = socket.create_connection((host, int(port)), timeout=5)
            c.sendall(trpc._HDR.pack(55, 0, 0))
            assert c.recv(4) == b""             # closed, nothing answered
            c.close()
    finally:
        for s in servers.values():
            s.shutdown()


def test_stop_and_close_connections():
    server = _server("port")
    client = trpc.ShardClientBase([server.endpoint],
                                  retry=_fast_retry("port", max_attempts=1))
    try:
        assert client.ping()
        server.close_connections()             # a host death mid-session
        # the severed socket fails once; the retry budget of 1 surfaces it
        with pytest.raises(trpc.PSUnavailableError):
            _call(client, OP_ECHO, b"after")
        assert client.ping()                   # reconnects, server alive
        client.stop_servers()
        time.sleep(0.05)
        with pytest.raises(trpc.PSUnavailableError):
            client.ping()
    finally:
        client.close()
        server.shutdown()
