"""A shard of the distributed graph store for GNN sampling (counterpart
of `paddle_tpu/distributed/ps/graph_table.py`, copied).

Reference: paddle/fluid/distributed/ps/table/common_graph_table.{h,cc}, the
GraphTable behind fleet's DistGraphClient: nodes and edges partitioned
across server shards by node id, each shard's adjacency held as arrays,
neighbour sampling (uniform and weighted) and feature pulls served by the
shard, so a trainer moves only sampled subgraphs.

The graph is host-side minibatch-construction state, so the store is
numpy: the sampling is slicing over a CSR built once at `build()`, with
numpy's RandomState, so a seed gives the JAX package's samples. Node `u`
lives on shard `u % num_shards` (`shard_for`), and a shard stores the
out-edges of its own nodes, so "sample the neighbours of u" asks one
shard. The transport is `rpc.py` (GSAMPLE / GFEAT / GDEGREE and
`DistGraphClient`).
"""
import numpy as np

__all__ = ["GraphTable"]


class GraphTable:
    """One shard of the distributed graph (num_shards=1 ⇒ the whole graph).

    Typed nodes and edges: every edge set and every feature column family
    is keyed by a type string (default ``""``), matching the reference's
    edge_type/node_type config. Feeding the FULL edge/feature lists to every
    shard is supported — each shard keeps only its stripe — so loader code
    is shard-oblivious.
    """

    def __init__(self, shard_id=0, num_shards=1, seed=0):
        self.shard_id = int(shard_id)
        self.num_shards = max(int(num_shards), 1)
        # shard-decorrelated stream for un-seeded sampling requests
        self._rng = np.random.RandomState((int(seed) * 1000003 + self.shard_id)
                                          % (2 ** 31))
        self._pending = {}   # etype -> [(src, dst, weight-or-None), ...]
        self._csr = {}       # etype -> (offsets {node: (start, cnt)}, nbrs, w)
        self._feats = {}     # ntype -> ({node: row}, (rows, fd) float32)

    def _owned(self, ids):
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        if self.num_shards == 1:
            return ids, np.ones(ids.size, bool)
        from . import shard_for
        return ids, shard_for(ids, self.num_shards) == self.shard_id

    # -- construction ------------------------------------------------------
    def add_edges(self, src, dst, weights=None, edge_type=""):
        """Register directed edges; only edges whose SOURCE is owned by this
        shard are kept (the sharding rule). Call `build()` when done."""
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        if src.size != dst.size:
            raise ValueError(f"src/dst length mismatch: {src.size} vs "
                             f"{dst.size}")
        w = None
        if weights is not None:
            w = np.asarray(weights, np.float32).reshape(-1)
            if w.size != src.size:
                raise ValueError(f"weights length {w.size} != edges "
                                 f"{src.size}")
        _, own = self._owned(src)
        if edge_type in self._csr:
            # incremental add after build(): fold the built CSR back into a
            # pending chunk so the next build() keeps the old edges
            self._pending.setdefault(edge_type, []).insert(
                0, self._csr_to_chunk(edge_type))
            del self._csr[edge_type]
        self._pending.setdefault(edge_type, []).append(
            (src[own], dst[own], None if w is None else w[own]))

    def set_node_features(self, ids, features, node_type=""):
        """Attach a float32 feature row per owned node (reference: the
        feature columns of common_graph_table's Node)."""
        ids, own = self._owned(ids)
        feats = np.asarray(features, np.float32)
        feats = feats.reshape(ids.size, -1)
        index, rows = self._feats.get(node_type, ({}, None))
        keep_ids, keep = ids[own], feats[own]
        if rows is None:
            rows = keep.copy()
            index = {int(k): i for i, k in enumerate(keep_ids)}
        else:
            if rows.shape[1] != keep.shape[1]:
                raise ValueError(f"feature dim changed: {rows.shape[1]} -> "
                                 f"{keep.shape[1]}")
            base = rows.shape[0]
            rows = np.concatenate([rows, keep])
            for i, k in enumerate(keep_ids):
                index[int(k)] = base + i
        self._feats[node_type] = (index, rows)

    def _csr_to_chunk(self, etype):
        offsets, nbrs, w = self._csr[etype]
        nodes = sorted(offsets, key=lambda n: offsets[n][0])
        src = np.repeat(np.asarray(nodes, np.int64),
                        [offsets[n][1] for n in nodes])
        return (src, nbrs, w)

    def build(self):
        """Finalize pending edges into per-type CSR (offsets into one
        concatenated neighbor array, sorted by source node)."""
        for etype, chunks in self._pending.items():
            src = np.concatenate([c[0] for c in chunks]) if chunks else \
                np.zeros(0, np.int64)
            dst = np.concatenate([c[1] for c in chunks]) if chunks else \
                np.zeros(0, np.int64)
            with_w = [c[2] is not None for c in chunks]
            if any(with_w) and not all(with_w):
                raise ValueError(
                    f"edge type {etype!r}: some add_edges calls passed "
                    f"weights and some did not — weighted sampling would "
                    f"silently degrade to uniform; pass weights for all "
                    f"chunks or none")
            w = np.concatenate([c[2] for c in chunks]) if chunks and \
                all(with_w) else None
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
            if w is not None:
                w = w[order]
            uniq, starts, cnts = np.unique(src, return_index=True,
                                           return_counts=True)
            offsets = {int(u): (int(s), int(c))
                       for u, s, c in zip(uniq, starts, cnts)}
            self._csr[etype] = (offsets, dst, w)
        self._pending.clear()
        return self

    def _adj(self, edge_type):
        if edge_type not in self._csr:
            if self._pending.get(edge_type):
                raise RuntimeError("GraphTable.build() not called after "
                                   "add_edges")
            raise KeyError(f"unknown edge type {edge_type!r} "
                           f"(have {sorted(self._csr)})")
        return self._csr[edge_type]

    # -- serving -----------------------------------------------------------
    def sample_neighbors(self, ids, sample_size=-1, edge_type="",
                         strategy="uniform", seed=None):
        """Server-side neighbor sampling: for each queried node return up to
        `sample_size` out-neighbors (all of them when sample_size <= 0),
        uniform or weight-proportional, WITHOUT replacement.

        Returns (neighbors int64 concat, counts int32 per query node);
        un-owned / unknown nodes get count 0 — the client routes by the
        sharding rule so that only happens on direct local use."""
        offsets, nbrs, w = self._adj(edge_type)
        ids = np.asarray(ids, np.int64).reshape(-1)
        rng = self._rng if seed is None else \
            np.random.RandomState(int(seed) % (2 ** 31))
        k = int(sample_size)
        out, counts = [], np.zeros(ids.size, np.int32)
        for i, node in enumerate(ids):
            ent = offsets.get(int(node))
            if ent is None:
                continue
            start, cnt = ent
            if k <= 0 or cnt <= k:
                pick = nbrs[start:start + cnt]
            elif strategy == "weighted" and w is not None:
                p = w[start:start + cnt].astype(np.float64)
                p = p / p.sum()
                pick = nbrs[start + rng.choice(cnt, k, replace=False, p=p)]
            else:
                pick = nbrs[start + rng.choice(cnt, k, replace=False)]
            out.append(pick)
            counts[i] = pick.size
        neighbors = np.concatenate(out) if out else np.zeros(0, np.int64)
        return neighbors, counts

    def pull_features(self, ids, node_type=""):
        """(n, feat_dim) float32 feature rows; nodes without a stored row
        (or owned elsewhere) come back zero — embedding-style semantics so
        a partial feature load never crashes serving."""
        index, rows = self._feats.get(node_type, ({}, None))
        ids = np.asarray(ids, np.int64).reshape(-1)
        fd = 0 if rows is None else rows.shape[1]
        out = np.zeros((ids.size, fd), np.float32)
        for i, node in enumerate(ids):
            r = index.get(int(node))
            if r is not None:
                out[i] = rows[r]
        return out

    def node_degree(self, ids, edge_type=""):
        """Out-degree of each queried node on this shard (int64)."""
        offsets, _, _ = self._adj(edge_type)
        ids = np.asarray(ids, np.int64).reshape(-1)
        return np.asarray([offsets.get(int(n), (0, 0))[1] for n in ids],
                          np.int64)

    @property
    def feature_dim(self):
        dims = {t: r.shape[1] for t, (_, r) in self._feats.items()
                if r is not None}
        return dims.get("", next(iter(dims.values()), 0))

    def edge_types(self):
        return sorted(set(self._csr) | set(self._pending))

    def num_edges(self, edge_type=""):
        offsets, nbrs, _ = self._adj(edge_type)
        return int(nbrs.size)
