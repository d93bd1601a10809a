"""Tensor-parallel paged serving: one controller, explicit shards.

Counterpart of `paddle_tpu/serving/distributed/tp.py`. The JAX engine
places its weights and KV pools over a 1-D 'mp' mesh and lets XLA's
partitioner insert the collectives; this engine writes the partition out.
One process drives every shard, as the JAX engine's one controller drives
its mesh:

  - weights split as `param_partition_specs` says (`Split(axis, groups)`
    in the port's `[out, in]` layout): qkv and fc1 column-parallel,
    out_proj and fc2 row-parallel, wte vocab-parallel (the tied head is
    its transpose), LayerNorms, biases of row-parallel layers and wpe
    replicated, each shard holding its own copy;
  - qkv's output axis is q|k|v-major (`reshape(B, S, 3, heads, d)`), so
    it is cut as three groups: shard t takes heads
    [t*h/tp, (t+1)*h/tp) of q, of k and of v (and of the bias);
  - the KV pools split over heads: each shard holds its own
    [num_blocks, block_size, heads/tp, head_dim] pool per layer (and its
    [num_blocks, heads/tp] scales with kv_dtype="int8"), and launches the
    paged kernel over its own heads, so a forward launches
    `num_layers * tp` paged kernels;
  - row-parallel partials are summed in float32 in a fixed shard order
    and the bias added once; the vocab-parallel lookup is masked per
    shard and summed; the head's logits are the shards' slices
    concatenated. With tp=1 every split is the identity and the forward
    runs GPTBlock's own ops;
  - block tables, positions and tokens are host state shared by every
    shard, so the block math (allocator, prefix cache, KV ledger) is the
    paged engine's.

A row-parallel product summed over shards does not round like one cuBLAS
product, so streams are held token-exact (not bit-exact) against the
single-device engine. Prefill and decode are the paged engine's
executables (`decode`, `prefill[bucket]`), captured once each as CUDA
graphs; the tp shards of a stage launch in stream order on one stream.
Every shard of this engine lives on the engine's device: shards of one
stage on different cards need one process a rank and collectives inside
the captures, which this engine does not do.

int8 decode weights (weight_dtype="int8") are quantized over the whole
weight first and then split like the float weight, so each shard's codes
are the single-device codes; the per-output-channel scales follow the
split only where the channel axis is the split axis (`quant_scale_split`)
and are replicated for row-parallel weights. The float set stays
resident for prefill, so a shard's weight bytes are about 1.25x its float
bytes (`hbm_accounting`).

The engine's master copy of the weights (`_params`, and the int8 decode
set) lives on the host once the shards hold theirs: a hot swap stages
into it and copies each shard's slice into the shard's storage in place,
so the captured graphs keep reading it. The handoff, tier and probe paths
read and write the pools through `_pool`, a whole-model view whose reads
concatenate the shards' heads and whose writes split them
(`HeadConcat`), so bundles from a sharded engine are byte-equal to the
single-device engine's.
"""
import collections

import torch
import torch.nn.functional as F

from ...observability import numerics as _numerics
from ...text.models.gpt import LN_EPS, cached_positions, paged_attend
from .. import blocks
from ..engine import PagedEngineConfig, PagedGenerationEngine
from ..tenancy.adapters import lora_apply, lora_delta

__all__ = ["TensorParallelEngineConfig", "TensorParallelPagedEngine",
           "Split", "param_partition_specs", "quant_scale_split",
           "shard_tensor", "HeadConcat"]


class TensorParallelEngineConfig(PagedEngineConfig):
    """PagedEngineConfig plus the tensor-parallel degree `tp`, which must
    divide num_heads (heads are the split attention axis)."""

    def __init__(self, tp=2, **kwargs):
        super().__init__(**kwargs)
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")

    _DICT_FIELDS = PagedEngineConfig._DICT_FIELDS + ("tp",)


# How a parameter splits over the tp shards: its `axis` (in the port's
# [out, in] layout) is `groups` equal groups, each cut into tp contiguous
# pieces; shard t takes piece t of every group. The JAX model annotates
# the same facts as `split_axis` in its [in, out] layout.
Split = collections.namedtuple("Split", ["axis", "groups"])

_SPLITS = {
    "attn.qkv.weight": Split(0, 3),         # column-parallel, q|k|v-major
    "attn.qkv.bias": Split(0, 3),
    "attn.out_proj.weight": Split(1, 1),    # row-parallel
    "mlp.fc1.weight": Split(0, 1),          # column-parallel
    "mlp.fc1.bias": Split(0, 1),
    "mlp.fc2.weight": Split(1, 1),          # row-parallel
    "wte.weight": Split(0, 1),              # vocab-parallel (tied head)
    "lm_head.weight": Split(0, 1),
}


def param_partition_specs(model):
    """{param name: Split, or None for a replicated param} of a GPT."""
    specs = {}
    for name, _ in model.named_parameters():
        leaf = name.split(".", 2)[2] if name.startswith("blocks.") else name
        specs[name] = _SPLITS.get(leaf)
    return specs


def quant_scale_split(split):
    """The split of an int8 weight's per-output-channel scales [out, 1]:
    the weight's own when the channel axis (0) is the split axis
    (column-parallel and vocab-parallel weights), else None: a
    row-parallel shard holds every output channel, so every shard keeps
    all the scales."""
    return split if split is not None and split.axis == 0 else None


def shard_index(n, split, tp, t):
    """Indices along a split axis of length n that shard t of tp takes."""
    size = n // split.groups
    lo, hi = size * t // tp, size * (t + 1) // tp
    return torch.cat([torch.arange(g * size + lo, g * size + hi)
                      for g in range(split.groups)])


def shard_tensor(arr, split, tp, t, device):
    """Shard t's tensor of `arr` on `device`: its slice under `split`, or
    a copy of its own (replicated)."""
    with torch.no_grad():
        if split is not None:
            arr = arr.index_select(split.axis, shard_index(
                arr.shape[split.axis], split, tp, t).to(arr.device))
        return arr.detach().to(device, copy=True)


class HeadConcat:
    """A whole-model view of one pool tensor split over head shards: a read
    (`view[idx]`) concatenates the shards' results along the heads axis, a
    write (`view[idx] = v`, `index_copy_`) splits the value along it, so
    the engine's handoff, tier and probe paths index it as they index one
    pool tensor. `axis` is the heads axis (2 for K/V codes, 1 for the
    int8 scales)."""

    def __init__(self, parts, axis):
        self.parts = list(parts)
        self.axis = axis
        self._sizes = [p.shape[axis] for p in self.parts]
        shape = list(self.parts[0].shape)
        shape[axis] = sum(self._sizes)
        self.shape = torch.Size(shape)
        self.dtype = self.parts[0].dtype
        self.device = self.parts[0].device

    def _out_axis(self, idx):
        """The heads axis of `part[idx]`: advanced indices on the leading
        axes replace them with the indices' broadcast dims."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        ndim = max((i.dim() for i in idx if torch.is_tensor(i)), default=0)
        return self.axis - len(idx) + ndim

    def __getitem__(self, idx):
        return torch.cat([p[idx] for p in self.parts],
                         dim=self._out_axis(idx))

    def __setitem__(self, idx, value):
        pieces = torch.split(value, self._sizes, dim=self._out_axis(idx))
        for p, v in zip(self.parts, pieces):
            p[idx] = v

    def index_copy_(self, dim, index, source):
        pieces = torch.split(source, self._sizes, dim=self.axis)
        for p, v in zip(self.parts, pieces):
            p.index_copy_(dim, index, v)
        return self


class Shard:
    """One tp shard of one stage: its device, heads and vocab rows, its
    float params and decode params ({global name: tensor, or {"q",
    "scale"}}), and its KV pool (one layer cache per layer of the
    stage)."""
    __slots__ = ("name", "device", "heads", "vocab", "params",
                 "decode_params", "pool")


class Stage:
    """One pipeline stage's placement: its block range, device and tp
    shards, the per-shard output-column indices of the column-parallel
    layers (`columns[name][t]`, on the device, to slice an adapter delta),
    and the static buffers a pipeline engine keeps per stage (`bufs`)."""
    __slots__ = ("start", "stop", "device", "is_first", "is_last",
                 "shards", "names", "columns", "bufs")

    @property
    def layers(self):
        return self.stop - self.start


def _row_parallel(xs, ws, bias, view, name):
    """A row-parallel linear over the shards' inputs `xs`: partials summed
    in float32 in shard order, the bias added once, then the target's LoRA
    delta over the whole input. One shard: the linear itself."""
    if len(xs) == 1:
        return lora_apply(F.linear(xs[0], ws[0], bias), xs[0], view, name)
    acc = None
    for x, w in zip(xs, ws):
        part = F.linear(x, w).float()
        acc = part if acc is None else acc + part
    y = (acc + bias).to(xs[0].dtype)
    if view is not None and view.get(name) is not None:
        y = lora_apply(y, torch.cat(xs, dim=-1), view, name)
    return y


def _column_parallel(x, ws, bs, view, name, columns):
    """A column-parallel linear: each shard's output columns, plus those
    columns of the target's LoRA delta over the (replicated) input."""
    if len(ws) == 1:
        return [lora_apply(F.linear(x, ws[0], bs[0]), x, view, name)]
    pair = None if view is None else view.get(name)
    delta = None if pair is None else lora_delta(x, pair[0], pair[1],
                                                 view["slot"])
    outs = []
    for w, b, cols in zip(ws, bs, columns):
        y = F.linear(x, w, b)
        if delta is not None:
            y = y + delta.index_select(-1, cols).to(y.dtype)
        outs.append(y)
    return outs


class ShardedPagedEngine(PagedGenerationEngine):
    """The paged engine over explicit shards: `_stages` (each a `Stage` of
    tp `Shard`s) hold the weights and the pools, the host holds the master
    copy, and `_pool` is the whole-model view over the shards' pools. The
    tensor-parallel engine is one stage; the pipeline-parallel engines
    (`pp.py`) are several."""

    _tp = 1

    def _stage_plan(self):
        """[(start, stop, device)] of the stages, in layer order."""
        return [(0, self._model.cfg.num_layers, self.device)]

    def _alloc_state(self):
        cfg = self._model.cfg
        tp = self._tp
        if cfg.num_heads % tp:
            raise ValueError(f"tp={tp} must divide num_heads="
                             f"{cfg.num_heads} (heads are the split axis)")
        self._specs = param_partition_specs(self._model)
        self._stages = [self._build_stage(s, a, b, dev)
                        for s, (a, b, dev) in enumerate(self._stage_plan())]
        # the master copy moves to the host: the shards hold the serving
        # state; a swap stages into the masters and reslices
        host = torch.device("cpu")
        decode_own = {n for n, v in self._decode_params.items()
                      if v is not self._params[n]}
        self._params = {n: t.to(host) for n, t in self._params.items()}
        self._decode_params = {
            n: ({k: x.to(host) for k, x in v.items()} if isinstance(v, dict)
                else v.to(host)) if n in decode_own else self._params[n]
            for n, v in self._decode_params.items()}
        super()._alloc_state()

    def _build_stage(self, index, start, stop, device):
        cfg = self._model.cfg
        tp = self._tp
        st = Stage()
        st.start, st.stop, st.device = start, stop, device
        st.is_first = start == 0
        st.is_last = stop == cfg.num_layers
        st.names = [n for n in self._params if self._stage_holds(st, n)]
        st.bufs = {}
        heads = cfg.num_heads // tp
        st.shards = []
        for t in range(tp):
            sh = Shard()
            sh.name = f"stage{index}.tp{t}"
            sh.device = device
            sh.heads = heads
            sh.vocab = (cfg.vocab_size * t // tp,
                        cfg.vocab_size * (t + 1) // tp)
            sh.params = {n: self._shard(self._params[n], self._specs[n], t,
                                        device) for n in st.names}
            sh.decode_params = {}
            for n in st.names:
                v = self._decode_params[n]
                if v is self._params[n]:
                    sh.decode_params[n] = sh.params[n]
                else:
                    sh.decode_params[n] = self._shard_decode(
                        v, self._specs[n], t, device)
            sh.pool = self._alloc_pools(stop - start, heads, device)
            st.shards.append(sh)
        st.columns = {}
        if tp > 1:
            h, inter = cfg.hidden_size, cfg.intermediate_size
            for name, n, split in (("qkv", 3 * h, Split(0, 3)),
                                   ("fc1", inter, Split(0, 1))):
                st.columns[name] = [shard_index(n, split, tp, t).to(device)
                                    for t in range(tp)]
        return st

    def _stage_holds(self, st, name):
        """Whether stage `st` holds param `name`: its blocks, the
        embeddings on the first stage, the final LayerNorm and the head
        (the tied wte) on the last."""
        if name.startswith("blocks."):
            return st.start <= int(name.split(".")[1]) < st.stop
        if name.startswith("wte."):
            return st.is_first or (st.is_last and
                                   self._model.cfg.tie_embeddings)
        if name.startswith("wpe."):
            return st.is_first
        return st.is_last                   # ln_f, lm_head

    def _shard(self, arr, split, t, device):
        return shard_tensor(arr, split, self._tp, t, device)

    def _shard_decode(self, v, split, t, device):
        """A decode entry's shard: int8 codes split like the float weight,
        their scales per `quant_scale_split`; a float entry of its own
        storage split like the param."""
        if isinstance(v, dict):
            return {"q": self._shard(v["q"], split, t, device),
                    "scale": self._shard(v["scale"],
                                         quant_scale_split(split), t,
                                         device)}
        return self._shard(v, split, t, device)

    def _whole_pool(self):
        """The whole-model view of the shards' pools: every stage's layers
        in order, each field a `HeadConcat` over the stage's shards (the
        shard's tensor itself with one shard)."""
        out = []
        for st in self._stages:
            for li in range(st.layers):
                layers = [sh.pool[li] for sh in st.shards]
                fields = []
                for field in layers[0]._fields:
                    parts = [getattr(l, field) for l in layers]
                    axis = 2 if parts[0].dim() == 4 else 1
                    fields.append(parts[0] if len(parts) == 1
                                  else HeadConcat(parts, axis))
                out.append(type(layers[0])(*fields))
        return tuple(out)

    @property
    def _shards(self):
        return [sh for st in self._stages for sh in st.shards]

    # -- the sharded forward -----------------------------------------------
    def _stage_forward(self, st, x, tables, pos, valid=None, decode=False,
                       op="block", adapter_ids=None):
        """Stage `st`'s forward (GPTStage's ops, each split linear run per
        shard): op "block" returns the hidden state after the stage's
        blocks, "block_head" the logits, "head" the logits of a hidden
        state `x` (no blocks). The first stage embeds token ids `x`. The
        K/V of every block is written into the shards' pools in place;
        decode forwards run the decode params and add each slot's adapter
        delta when a bank is attached. The paged attention runs under the
        config's `attention_impl`."""
        params = [self._dequant_params(sh.decode_params) if decode
                  else sh.params for sh in st.shards]
        if op == "head":
            return self._head(params, x)
        if st.is_first:
            x = self._embed(st, params, x, pos)
        adapters = self._stage_adapters(st, adapter_ids) if decode \
            else None
        with blocks.attention_impl(self.config.attention_impl):
            for li in range(st.start, st.stop):
                view = None if adapters is None else \
                    {"slot": adapters["slot"],
                     **adapters["layers"][li - st.start]}
                x = self._block(st, params, li, x, tables, pos, valid, view)
                _numerics.tap_layer(li, "act", x)
        if op == "block_head":
            return self._head(params, x)
        return x

    def _stage_adapters(self, st, adapter_ids):
        """The stage's per-slot adapter view {"slot", "layers": the stage's
        layers of the bank}, or None without a bank."""
        if self._adapter_bank is None:
            return None
        tree = self._stage_adapter_tree(st)
        return {"slot": self._adapter_ids() if adapter_ids is None
                else adapter_ids,
                "layers": tree["layers"][st.start:st.stop]}

    def _stage_adapter_tree(self, st):
        return self._adapter_tree

    def _embed(self, st, params, ids, pos):
        cfg = self._model.cfg
        ids = ids.to(torch.int64)
        positions = cached_positions(pos, ids.shape[1],
                                     cfg.max_position_embeddings)
        if len(params) == 1:
            emb = F.embedding(ids, params[0]["wte.weight"])
        else:
            # vocab-parallel: each shard looks up its own rows, masked
            emb = None
            for sh, p in zip(st.shards, params):
                lo, hi = sh.vocab
                local = ids - lo
                hit = (local >= 0) & (local < hi - lo)
                part = torch.where(
                    hit[..., None],
                    F.embedding(local.clamp(0, hi - lo - 1), p["wte.weight"]),
                    0.0)
                emb = part if emb is None else emb + part
        return emb + F.embedding(positions, params[0]["wpe.weight"])

    def _block(self, st, params, li, x, tables, pos, valid, view):
        cfg = self._model.cfg
        H = cfg.hidden_size
        hd = H // cfg.num_heads
        pre = f"blocks.{li}."
        p0 = params[0]

        def ws(name):
            return [p[pre + name] for p in params]
        h = F.layer_norm(x, (H,), p0[pre + "ln1.weight"],
                         p0[pre + "ln1.bias"], LN_EPS)
        B, S, _ = h.shape
        qkvs = _column_parallel(h, ws("attn.qkv.weight"),
                                ws("attn.qkv.bias"), view, "qkv",
                                st.columns.get("qkv"))
        outs = []
        for sh, qkv in zip(st.shards, qkvs):
            q, k, v = qkv.reshape(B, S, 3, sh.heads, hd).unbind(2)
            out, _ = paged_attend(q.contiguous(), k, v,
                                  sh.pool[li - st.start], tables, pos, valid)
            outs.append(out.reshape(B, S, sh.heads * hd))
        x = x + _row_parallel(outs, ws("attn.out_proj.weight"),
                              p0[pre + "attn.out_proj.bias"], view,
                              "out_proj")
        h = F.layer_norm(x, (H,), p0[pre + "ln2.weight"],
                         p0[pre + "ln2.bias"], LN_EPS)
        mids = [F.gelu(y, approximate="tanh") for y in _column_parallel(
            h, ws("mlp.fc1.weight"), ws("mlp.fc1.bias"), view, "fc1",
            st.columns.get("fc1"))]
        return x + _row_parallel(mids, ws("mlp.fc2.weight"),
                                 p0[pre + "mlp.fc2.bias"], view, "fc2")

    def _head(self, params, x):
        cfg = self._model.cfg
        p0 = params[0]
        h = F.layer_norm(x, (cfg.hidden_size,), p0["ln_f.weight"],
                         p0["ln_f.bias"], LN_EPS)
        key = "wte.weight" if cfg.tie_embeddings else "lm_head.weight"
        if len(params) == 1:
            return F.linear(h, p0[key])
        return torch.cat([F.linear(h, p[key]) for p in params], dim=-1)

    # -- weights: swap and numerics ------------------------------------------
    def _refresh_decode_params(self):
        """After a swap staged the masters: requantize the host decode set,
        then copy every shard's slice into its storage in place."""
        super()._refresh_decode_params()
        with torch.no_grad():
            for st in self._stages:
                for t, sh in enumerate(st.shards):
                    for n in st.names:
                        split = self._specs[n]
                        sh.params[n].copy_(self._shard(
                            self._params[n], split, t, sh.device))
                        v, dv = self._decode_params[n], sh.decode_params[n]
                        if dv is sh.params[n]:
                            continue
                        new = self._shard_decode(v, split, t, sh.device)
                        if isinstance(dv, dict):
                            dv["q"].copy_(new["q"])
                            dv["scale"].copy_(new["scale"])
                        else:
                            dv.copy_(new)

    def _apply_numerics_corruption(self, name, mode):
        """The damage lands in the shards' decode storage: nan / inf at
        element 0, which the first shard holding `name` holds (the forward
        reads shard 0's replicated copies); scale_zero in every shard's
        scales."""
        if not name:
            return
        for sh in self._shards:
            entry = sh.decode_params.get(name)
            if entry is None:
                continue
            self._corrupt_entry(entry, mode)
            if mode != "scale_zero":
                return

    def _tap_decode_inputs(self):
        """The paged engine's decode taps over the shards' tensors: int8
        pool scales and codes, int8 decode weights' scales and codes."""
        shards = self._shards
        if self.kv_quantized:
            _numerics.tap_tree("kv.scale", [x for sh in shards
                                            for l in sh.pool
                                            for x in (l.k_scale, l.v_scale)])
            _numerics.tap_tree("kv.codes", [x for sh in shards
                                            for l in sh.pool
                                            for x in (l.k, l.v)],
                               sat_threshold=127)
        quant = [v for sh in shards for v in sh.decode_params.values()
                 if isinstance(v, dict)]
        if quant:
            _numerics.tap_tree("weights.scale", [w["scale"] for w in quant])
            _numerics.tap_tree("weights.q", [w["q"] for w in quant],
                               sat_threshold=127)

    # -- introspection ---------------------------------------------------------
    def _resident_groups(self):
        out = []
        for sh in self._shards:
            weights = []
            for src in (sh.params, sh.decode_params):
                for v in src.values():
                    weights.extend((v["q"], v["scale"])
                                   if isinstance(v, dict) else (v,))
            out.append((sh.name, sh.device, weights,
                        [x for l in sh.pool for x in l]))
        return out

    def kv_shard_report(self):
        """{shard: {"device", "layers": [start, stop], "heads"}}: where
        each shard's KV pool lives and the heads it holds (heads/tp)."""
        return {sh.name: {"device": str(sh.device),
                          "layers": [st.start, st.stop],
                          "heads": int(sh.pool[0].k.shape[2])}
                for st in self._stages for sh in st.shards}


class TensorParallelPagedEngine(ShardedPagedEngine):
    """The paged engine with its weights and KV pools split over `tp`
    shards on the engine's device (module docstring). The public contract
    is the paged engine's: prefill / decode / adopt / extract / swap, one
    capture per executable (`decode`, `prefill[bucket]`), block
    accounting on the host."""

    _config_cls = TensorParallelEngineConfig

    def __init__(self, model, config=None, device="cuda", **kwargs):
        config = config or TensorParallelEngineConfig(**kwargs)
        if not isinstance(config, TensorParallelEngineConfig):
            raise TypeError("TensorParallelPagedEngine needs a "
                            "TensorParallelEngineConfig")
        self._tp = config.tp
        super().__init__(model, config, device=device)

    def _paged_forward(self, ids, tables, pos, valid=None, decode=False,
                       adapter_ids=None):
        return self._stage_forward(self._stages[0], ids, tables, pos, valid,
                                   decode=decode, op="block_head",
                                   adapter_ids=adapter_ids)
