"""The port's parameter-server verbs and graph table against the JAX
package's, across the wire both ways.

  * PULL / PUSH on a two-shard sparse cluster: a port client
    (`PSClient`, `DistributedSparseTable`, `SparseEmbedding` over it)
    against JAX servers, and a JAX client against port servers
    (`[client-server]`), held bit for bit to local tables of the same
    seeds routed by `shard_for`; a port server with a disk tier behind it;
  * the graph verbs (GSAMPLE uniform and weighted under a seed, GFEAT,
    GDEGREE, typed edges) on a graph sharded two ways, every client /
    server pairing of the two packages giving the same bytes, and an
    error frame that leaves the connection serving;
  * `GraphTable` locally against the JAX one (tests/test_graph_table.py:
    42-168): build, degrees, features, seeded sampling, typed edges,
    incremental edges, the mixed-weights error, the shard stripes;
  * a port server in another process, pulled and pushed by a port and a
    JAX client (tests/test_ps_rpc.py:99);
  * the isolation check: importing every module this slice adds or
    changes leaves no `jax` and no `paddle_tpu` in `sys.modules`.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

DIM = 8
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _ps(pkg):
    if pkg == "jax":
        from paddle_tpu.distributed import ps
    else:
        from paddle_tpu_torch.distributed import ps
    return ps


def _native(pkg):
    if pkg == "jax":
        from paddle_tpu import native
    else:
        from paddle_tpu_torch import native
    return native


PAIRS = [("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("client,server", PAIRS,
                         ids=[f"{c}-{s}" for c, s in PAIRS])
def test_sparse_verbs_across_packages(client, server):
    sps, cps = _ps(server), _ps(client)
    tables = [_native(server).SparseTable(DIM, rule="adagrad", lr=0.3,
                                          seed=s) for s in range(2)]
    local = [_native("jax").SparseTable(DIM, rule="adagrad", lr=0.3, seed=s)
             for s in range(2)]
    servers = [sps.PSServer(table=t) for t in tables]
    dt = cps.DistributedSparseTable([s.endpoint for s in servers], DIM)
    try:
        keys = np.array([0, 1, 2, 3, 10, 11, 3], np.int64)
        own = sps.shard_for(keys, 2)
        want = np.stack([local[o].pull(keys[i:i + 1])[0]
                         for i, o in enumerate(own)])
        np.testing.assert_array_equal(dt.pull(keys), want)
        g = np.random.RandomState(0).randn(keys.size, DIM).astype(np.float32)
        dt.push(keys, g)
        for o in range(2):
            m = own == o
            local[o].push(keys[m], g[m])
        for o in range(2):
            k = np.arange(12)[np.arange(12) % 2 == o]
            np.testing.assert_array_equal(
                np.concatenate(tables[o].pull_with_state(k), 1),
                np.concatenate(local[o].pull_with_state(k), 1))
        # the lookup op over the remote table
        if client == "port":
            emb = cps.SparseEmbedding(DIM, table=dt, device="cpu")
            out = emb(np.array([[5, 6]]))
            np.testing.assert_array_equal(out.numpy()[0],
                                          dt.pull(np.array([5, 6])))
            out.sum().backward()
            local[1].push([5], np.ones((1, DIM), np.float32))
            np.testing.assert_array_equal(tables[1].pull([5]),
                                          local[1].pull([5]))
        assert dt.client.ping()
    finally:
        dt.client.close()
        for s in servers:
            s.shutdown()


def test_port_server_with_a_disk_tier(tmp_path):
    from paddle_tpu_torch.distributed import ps
    t = ps.make_table(DIM, table_class="SSDSparseTable", rule="sgd", lr=1.0,
                      path=str(tmp_path / "ssd.log"), hot_capacity=2)
    server = ps.PSServer(table=t)
    client = _ps("jax").PSClient([server.endpoint], DIM)
    try:
        keys = np.arange(6, dtype=np.int64)
        before = client.pull(keys)
        client.push(keys, np.ones((6, DIM), np.float32))
        np.testing.assert_array_equal(client.pull(keys), before - 1.0)
        assert t.stats["hot_rows"] == 2 and t.stats["disk_rows"] >= 4
        with pytest.raises(_ps("jax").PSServerError, match="no graph table"):
            _ps("jax").DistGraphClient([server.endpoint]).node_degree([0])
    finally:
        client.close()
        server.shutdown()
        t.destroy()


def demo_graph(GraphTable, shard_id, num_shards, n_nodes=32, seed=7):
    """tests/graph_ps_worker.py's two-community graph over `GraphTable`,
    plus a typed edge set and typed features."""
    rng = np.random.RandomState(seed)
    half = n_nodes // 2
    src, dst, w = [], [], []
    for u in range(n_nodes):
        comm = u // half
        for v in rng.choice(np.arange(comm * half, (comm + 1) * half),
                            size=6, replace=False):
            src.append(u)
            dst.append(int(v))
            w.append(1.0)
        src.append(u)
        dst.append(int(rng.randint((1 - comm) * half, (2 - comm) * half)))
        w.append(0.1)
    feats = rng.randn(n_nodes, 8).astype(np.float32)
    g = GraphTable(shard_id=shard_id, num_shards=num_shards, seed=seed)
    g.add_edges(src, dst, weights=w)
    g.add_edges(dst, src, edge_type="rev")
    g.set_node_features(np.arange(n_nodes), feats)
    g.set_node_features(np.arange(0, n_nodes, 2),
                        feats[::2, :3] * 2, node_type="item")
    return g.build()


def _graph_answers(client):
    ids = np.arange(32)
    out = []
    for strategy in ("uniform", "weighted"):
        out += list(client.sample_neighbors(ids, 3, strategy=strategy,
                                            seed=11))
    out += list(client.sample_neighbors(ids[::3], -1, edge_type="rev"))
    out.append(client.pull_features(ids[::-1]))
    out.append(client.pull_features(ids, node_type="item"))
    out.append(client.node_degree(ids, edge_type="rev"))
    return out


def test_graph_verbs_across_packages():
    answers = {}
    for server in ("jax", "port"):
        sps = _ps(server)
        servers = [sps.PSServer(graph=demo_graph(sps.GraphTable, i, 2))
                   for i in range(2)]
        try:
            for client in ("jax", "port"):
                c = _ps(client).DistGraphClient([s.endpoint for s in servers])
                answers[client, server] = _graph_answers(c)
                if (client, server) == ("port", "port"):
                    with pytest.raises(sps.PSServerError,
                                       match="unknown edge type"):
                        c.sample_neighbors([0], 1, edge_type="rates")
                    np.testing.assert_array_equal(c.node_degree([0]), [7])
                c.close()
        finally:
            for s in servers:
                s.shutdown()
    want = answers["jax", "jax"]
    for key, got in answers.items():
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    assert want[1].sum() == 32 * 3 and want[6].shape == (32, 8)


def test_graph_table_equals_reference():
    tg, jg = (_ps(p).GraphTable for p in ("port", "jax"))
    for shards in (1, 2):
        for i in range(shards):
            a = demo_graph(tg, i, shards)
            b = demo_graph(jg, i, shards)
            ids = np.arange(40)
            for strategy in ("uniform", "weighted"):
                for x, y in zip(a.sample_neighbors(ids, 2, strategy=strategy,
                                                   seed=3),
                                b.sample_neighbors(ids, 2, strategy=strategy,
                                                   seed=3)):
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.node_degree(ids),
                                          b.node_degree(ids))
            np.testing.assert_array_equal(a.pull_features(ids, "item"),
                                          b.pull_features(ids, "item"))
            assert a.edge_types() == b.edge_types() == ["", "rev"]
            assert a.num_edges() == b.num_edges() and \
                a.feature_dim == b.feature_dim == 8
    # un-seeded draws come from the shard's own stream, the same in both
    for x, y in zip(demo_graph(tg, 1, 2).sample_neighbors(np.arange(8), 2),
                    demo_graph(jg, 1, 2).sample_neighbors(np.arange(8), 2)):
        np.testing.assert_array_equal(x, y)
    for G in (tg, jg):
        g = G()
        g.add_edges([0, 1], [1, 2])
        g.build()
        g.add_edges([0], [3])                     # after build(): kept
        g.build()
        np.testing.assert_array_equal(g.node_degree([0, 1]), [2, 1])
        g.add_edges([5], [6], weights=[1.0], edge_type="w")
        g.add_edges([5], [7], edge_type="w")
        with pytest.raises(ValueError, match="some add_edges calls"):
            g.build()


SERVER_SCRIPT = r"""
import os, sys
sys.path.insert(0, sys.argv[2])
from paddle_tpu_torch.distributed.ps import PSServer, SparseTable
srv = PSServer(SparseTable(8, rule="sgd", lr=1.0, seed=1))
tmp = sys.argv[1] + ".tmp"
with open(tmp, "w") as f:
    f.write(srv.endpoint)
os.replace(tmp, sys.argv[1])
srv._stop.wait()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")]
sys.exit(3 if bad else 0)
"""


def test_true_cross_process_pull_push(tmp_path):
    ep_file = str(tmp_path / "ep.txt")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", SERVER_SCRIPT, ep_file,
                             REPO], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        for _ in range(300):
            if os.path.exists(ep_file):
                break
            time.sleep(0.05)
        endpoint = open(ep_file).read().strip()
        local = _native("jax").SparseTable(DIM, rule="sgd", lr=1.0, seed=1)
        keys = np.array([100, 200, 300], np.int64)
        for pkg in ("port", "jax"):
            client = _ps(pkg).PSClient([endpoint], DIM)
            assert client.ping()
            np.testing.assert_array_equal(client.pull(keys),
                                          local.pull(keys))
            client.push(keys, np.full((3, DIM), 0.5, np.float32))
            local.push(keys, np.full((3, DIM), 0.5, np.float32))
            np.testing.assert_array_equal(client.pull(keys),
                                          local.pull(keys))
            client.close()
        client = _ps("port").PSClient([endpoint], DIM)
        client.stop_servers()
        client.close()
        assert proc.wait(timeout=20) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.distributed.ps as ps\n"
        "import paddle_tpu_torch.distributed.ps.device_cache\n"
        "import paddle_tpu_torch.distributed.ps.disk_table\n"
        "import paddle_tpu_torch.distributed.ps.graph_table\n"
        "import paddle_tpu_torch.distributed.ps.rpc\n"
        "import paddle_tpu_torch.native as n\n"
        "import paddle_tpu_torch.parallel.collectives\n"
        "import paddle_tpu_torch.parallel.ring_attention\n"
        "import paddle_tpu_torch.parallel.gpt_spmd\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel"
        ".pp_compiled\n"
        "import paddle_tpu_torch.hapi.model\n"
        "import paddle_tpu_torch.static.nn\n"
        "t = n.SparseTable(4, seed=1); t.pull([1]); n.stat_add('x')\n"
        "n.HostArena(1 << 20).destroy()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
