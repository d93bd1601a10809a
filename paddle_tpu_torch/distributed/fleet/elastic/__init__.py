"""Elastic training: fault tolerance and scale in/out (counterpart of
`paddle_tpu/distributed/fleet/elastic/__init__.py`).

The registry is the port's TCPStore (no etcd): each node heartbeats
`__elastic/nodes/<rank>` with a timestamp; the manager counts a node dead
when its lease (TTL) lapses, and `launch_elastic` relaunches a failed job
with backoff (`PADDLE_ELASTIC_MAX_RESTARTS`, `PADDLE_ELASTIC_BACKOFF_S`)
while the healthy set stays within the `--nnodes N:M` range. Where the
reference carries on without a store when its native library is missing,
the port raises: the store is part of the policy.
"""
import json
import os
import threading
import time


class ElasticLevel:
    FAULT_TOLERANCE = 1   # fixed world size, restart on failure
    ELASTIC = 2           # world size may change in [min, max]


def enable_elastic(args):
    return getattr(args, "elastic_level", -1) > 0


class ElasticManager:
    """TTL-lease node registry over TCPStore (reference: manager.py:127)."""

    def __init__(self, store, rank, np_range=(1, 1), ttl_s=6.0,
                 heartbeat_s=2.0):
        self._store = store
        self._rank = rank
        self._min, self._max = np_range
        self._ttl = ttl_s
        self._hb = heartbeat_s
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ lease API
    def register(self):
        self._beat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _beat(self):
        self._store.set(f"__elastic/nodes/{self._rank}",
                        json.dumps({"ts": time.time(),
                                    "host": os.environ.get(
                                        "PADDLE_CURRENT_ENDPOINT", "")}))

    def _loop(self):
        while not self._stop.wait(self._hb):
            try:
                self._beat()
            except Exception:
                return  # store gone: job is tearing down

    def alive_nodes(self, world_size):
        """Ranks whose lease is fresh."""
        now = time.time()
        alive = []
        for r in range(world_size):
            raw = self._store.get_nowait(f"__elastic/nodes/{r}")
            if raw is None:
                continue
            try:
                info = json.loads(raw)
            except (ValueError, TypeError):
                continue
            if now - float(info.get("ts", 0)) <= self._ttl:
                alive.append(r)
        return alive

    def need_rescale(self, world_size):
        """True when the healthy set no longer matches the running world:
        a dead node (fault) or a joinable node (scale-out)."""
        alive = self.alive_nodes(world_size)
        if len(alive) < world_size:
            return len(alive) >= self._min  # relaunch smaller if allowed
        return False

    def exit(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        try:
            self._store.delete_key(f"__elastic/nodes/{self._rank}")
        except Exception:
            pass


def launch_elastic(args, spawn_fn):
    """Supervise spawn_fn under the elastic policy: register this node's
    TTL lease in the rendezvous store, and on a trainer failure re-launch
    only while the healthy node set stays within the [min, max] range
    (reference: manager.py watch loop + relaunch)."""
    lo, _, hi = str(args.nnodes).partition(":")
    lo, hi = int(lo), int(hi or lo)
    rank = getattr(args, "rank", 0)

    from ...store import TCPStore
    if args.master:
        host, _, port = args.master.partition(":")
        store = TCPStore(host or "127.0.0.1", int(port or 0),
                         is_master=(rank == 0), world_size=hi, timeout=30.0)
    else:
        store = TCPStore(is_master=True, world_size=hi, timeout=30.0)
    manager = ElasticManager(store, rank=rank, np_range=(lo, hi))
    manager.register()

    max_restarts = int(os.environ.get("PADDLE_ELASTIC_MAX_RESTARTS", "10"))
    backoff_cap = float(os.environ.get("PADDLE_ELASTIC_BACKOFF_S", "30"))
    attempts = 0
    try:
        while True:
            rc = spawn_fn(args, args.nproc_per_node, _port())
            if rc == 0:
                return 0
            attempts += 1
            if attempts > max_restarts:
                return rc
            if len(manager.alive_nodes(hi)) < lo:
                # below the minimum scale: no point relaunching
                return rc
            time.sleep(min(2 ** attempts, backoff_cap))
    finally:
        manager.exit()
        store.stop()


def _port():
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
