"""TCPStore: the user-level rendezvous key-value store (counterpart of
`paddle_tpu/distributed/store.py`).

The server and client are the port's copy of the reference's
`native/src/kvstore.cc`, built by `native/__init__.py`; the master rank
hosts the server in-process, and every rank (master included) talks to it
over a client socket.

The process group does not rendezvous through this store:
`env.init_parallel_env` hands `torch.distributed.init_process_group` a
`tcp://` address, and torch keeps its own store there. This one is for
user-level rendezvous, as in the reference: electing a master,
exchanging endpoints, barriers in the launcher and the elastic manager.
"""
from .. import native


class TCPStore:
    """paddle-compatible surface: TCPStore(host, port, is_master, world_size)."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=900.0):
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        # timeout governs connect AND every blocking store op (paddle
        # TCPStore semantics): a dead peer turns into a TimeoutError, not a
        # silent hang until the scheduler's wall clock
        self._timeout_ms = int(timeout * 1000) if timeout and timeout > 0 else -1
        self._server = None
        if is_master:
            self._server = native.TCPStoreServer(port)
            port = self._server.port
        self.port = port
        self._client = native.TCPStoreClient(host, port,
                                             timeout_ms=self._timeout_ms)
        self._barrier_gen = {}

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self._client.set(key, value)

    def get(self, key):
        """Blocks until the key is set (paddle TCPStore.get semantics)."""
        return self._client.wait(key, timeout_ms=self._timeout_ms)

    def get_nowait(self, key):
        return self._client.get(key)

    def add(self, key, amount=1):
        return self._client.add(key, amount)

    def wait(self, key, timeout=None):
        tmo = int(timeout * 1000) if timeout is not None else self._timeout_ms
        return self._client.wait(key, timeout_ms=tmo)

    def delete_key(self, key):
        self._client.delete(key)

    def barrier(self, name="default", world_size=None):
        """All ranks increment a counter, then wait for it to reach N.

        Generation-numbered so the same barrier name is reusable: every rank
        calls barrier() the same number of times, so local generation
        counters agree without coordination."""
        n = world_size or self.world_size
        gen = self._barrier_gen.get(name, 0)
        self._barrier_gen[name] = gen + 1
        key = f"__barrier/{name}/{gen}"
        arrived = self.add(key + "/count", 1)
        if arrived == n:
            self.set(key + "/release", b"1")
            if gen > 0:  # garbage-collect the previous generation
                prev = f"__barrier/{name}/{gen - 1}"
                self.delete_key(prev + "/count")
                self.delete_key(prev + "/release")
        self._client.wait(key + "/release", timeout_ms=self._timeout_ms)

    def stop(self):
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
