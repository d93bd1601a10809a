"""Pipeline-parallel paged serving: stages of tp shards, one controller.

Counterpart of `paddle_tpu/serving/distributed/pp.py`. The model's blocks
split into `pp` contiguous stages (`text.models.gpt.gpt_stage_ranges`: the
embeddings ride the first stage, the final LayerNorm and the tied head the
last); stage s lives on `devices[s]` and holds its layers' weights and KV
pools as `tp` shards (`tp.py`: the same split, the same sharded forward).
The per-slot state the block math needs (tables, positions, allocator,
prefix cache, KV ledger) is host state shared by every stage: a block id
means the same thing in every stage's pool, so handoff, adopt, swap and
int8 compose per stage.

Executables, captured once each as CUDA graphs (`pp_executable_names`,
the JAX engine's set): `decode_stage[s]`, `prefill_stage[s][chunk]` and
`prefill_head[chunk]`; the speculative engine adds `verify_stage[s]`,
`draft_decode` and `draft_prefill[bucket]`. `capture_counts` mirrors the
JAX engine's per-stage trace counts (`decode_pp`, `prefill_pp`,
`verify_pp`).

DECODE is a ring over the slot microbatches: the slots split into M
contiguous microbatches and one `decode()` walks the
`build_serving_tables(M, pp)` tick table; microbatch g runs stage s at
tick g + s. The step's inputs (tokens, positions, tables, adapter ids of
every slot) are uploaded once; each stage's graph selects its
microbatch's rows through a device index the host sets before the replay.
Between replays the activation leaving stage s is copied into stage s+1's
static input buffer (the hop; `serving.pp_handoff` fires first, on every
hop), and the last stage's picks into the step's output buffer, read once
at the end. Within a tick the stages run from the last to the first, so
a hop's copy never overwrites an input its stage has not read yet. The
fill/drain triangles idle, so a call's bubble fraction is
(pp-1)/(M+pp-1): `serving_pp_bubble_fraction` and
`serving_pp_stage_busy{stage}` carry the engine's lifetime figures, and
the scheduler's step records `pp_bubble_fraction` and `pp_stage_busy`
(`tools/serve_report.py` renders them). Each row's math is the
single-device engine's, but a microbatch of slots/M rows may get another
cuBLAS algorithm than all the slots, so streams are held token-exact.

PREFILL streams the padded suffix through the stages in chunks
(`prefill_chunk`; default one chunk, the bucket) on the same forward tick
table: chunk c enters stage 0 at tick c, each stage writing its layers'
K/V into its own pools as the chunk passes. The first token comes from
`prefill_head[chunk]` over the final chunk's last-stage hidden state.

On one card every stage shares it, so nothing of the ring overlaps: a
one-card run proves the partition and the parity, not a multi-card
speed. Stages on different cards (`devices=` naming several) are placed
and copied between as written, but no host with more than one card has
run them.
"""
import functools
import time

import numpy as np
import torch

from ...core.device import resolve_device
from ...observability import faults as _faults
from ...observability import metrics as _metrics
from ...observability import numerics as _numerics
from ...parallel import pipeline_schedule as _psched
from ...profiler import RecordEvent, TracerEventType
from ...text.models.gpt import gpt_stage_ranges
from .. import graphs
from .. import sampling
from .. import spec_decode as _spec
from ..engine import PagedEngineConfig, _quantize_weight
from .tp import ShardedPagedEngine

__all__ = ["PipelineParallelEngineConfig", "PipelineParallelPagedEngine",
           "PipelineParallelSpecConfig", "PipelineParallelSpeculativeEngine",
           "free_eager_device_copies", "pp_executable_names"]


def pp_executable_names(config, spec=False):
    """The pipeline engines' executable names, from the config alone: what
    `executable_names()` returns and a `.gencfg` record lists."""
    names = [f"decode_stage[{s}]" for s in range(config.pp)]
    for chunk in _chunk_sizes(config):
        names += [f"prefill_stage[{s}][{chunk}]" for s in range(config.pp)]
        names.append(f"prefill_head[{chunk}]")
    names = sorted(set(names))
    if spec:
        names += ["draft_decode"]
        names += [f"draft_prefill[{b}]" for b in config.prefill_buckets]
        names += [f"verify_stage[{s}]" for s in range(config.pp)]
    return names


def _chunk(config, bucket):
    """The prefill chunk of a bucket: `prefill_chunk`, or the bucket."""
    return min(config.prefill_chunk or bucket, bucket)


def _chunk_sizes(config):
    return sorted({_chunk(config, b) for b in config.prefill_buckets})


_M_BUBBLE = _metrics.gauge(
    "serving_pp_bubble_fraction",
    "Idle fraction of the pipeline-serving tick schedule since engine "
    "start (fill/drain triangles over all decode/prefill rotations; "
    "0 = every stage worked every tick). Growth is failure-class in "
    "tools/metrics_report.py --compare")
_M_STAGE_BUSY = _metrics.gauge(
    "serving_pp_stage_busy",
    "Per-stage busy fraction of the pipeline-serving tick schedule "
    "since engine start",
    labelnames=("stage",))


class PipelineParallelEngineConfig(PagedEngineConfig):
    """PagedEngineConfig plus the (tp, pp) shape.

    pp: pipeline stages (>= 2; one stage is the tp engine). tp: shards a
    stage (num_heads must divide by it). decode_microbatches: slot groups
    riding the decode ring (must divide `slots`; default the largest
    divisor of `slots` that is <= pp). prefill_chunk: tokens a pipelined
    prefill chunk (None: one chunk a bucket; a fixed size collapses the
    per-stage prefill executables to one each). stage_layers: explicit
    per-stage block counts (default the uniform split)."""

    def __init__(self, pp=2, tp=1, decode_microbatches=None,
                 prefill_chunk=None, stage_layers=None, **kwargs):
        super().__init__(**kwargs)
        self.pp = int(pp)
        self.tp = int(tp)
        if self.pp < 2:
            raise ValueError(f"pp must be >= 2 (got {pp}); a one-stage "
                             f"pipeline is the paged/tp engine")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if decode_microbatches:
            self.decode_microbatches = int(decode_microbatches)
            if self.slots % self.decode_microbatches:
                raise ValueError(
                    f"decode_microbatches={self.decode_microbatches} "
                    f"must divide slots={self.slots}")
        else:
            self.decode_microbatches = max(
                d for d in range(1, min(self.pp, self.slots) + 1)
                if self.slots % d == 0)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 or None")
        self.stage_layers = tuple(int(x) for x in stage_layers) \
            if stage_layers else None

    _DICT_FIELDS = PagedEngineConfig._DICT_FIELDS + (
        "pp", "tp", "decode_microbatches", "prefill_chunk",
        "stage_layers")


def _resolve_devices(devices, pp):
    """`devices` (None: the card for every stage) as pp torch devices; a
    CUDA device the host does not have raises (no index wraps round and
    nothing moves to the CPU)."""
    devs = [resolve_device(d) for d in devices]
    if len(devs) != pp:
        raise ValueError(f"devices names {len(devs)} devices for pp={pp} "
                         f"stages")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(
                f"stage device {d} is not on this host "
                f"({torch.cuda.device_count()} CUDA devices)")
    return devs


class PipelineParallelPagedEngine(ShardedPagedEngine):
    """The paged engine partitioned into pipeline stages of tp shards
    (module docstring). Public contract unchanged: prefill / decode /
    adopt / extract / reset / swap, one capture per stage executable,
    block accounting on the host and shared by the stages. `devices`: the
    pp stage devices (default: `device` for every stage)."""

    _config_cls = PipelineParallelEngineConfig

    def __init__(self, model, config=None, device="cuda", devices=None,
                 **kwargs):
        config = config or PipelineParallelEngineConfig(**kwargs)
        if not isinstance(config, PipelineParallelEngineConfig):
            raise TypeError("PipelineParallelPagedEngine needs a "
                            "PipelineParallelEngineConfig")
        if model.cfg.num_layers < config.pp:
            raise ValueError(f"pp={config.pp} exceeds num_layers="
                             f"{model.cfg.num_layers}")
        # the speculative engine's cooperative __init__ passes its stage
        # devices through the instance
        devices = devices or getattr(self, "_stage_devices", None)
        self._devices = _resolve_devices(devices or [device] * config.pp,
                                         config.pp)
        self._tp = config.tp
        super().__init__(model, config, device=self._devices[0])

    def _stage_plan(self):
        ranges = gpt_stage_ranges(self._model.cfg.num_layers, self.config.pp,
                                  self.config.stage_layers)
        return [(a, b, dev) for (a, b), dev in zip(ranges, self._devices)]

    # -- state ------------------------------------------------------------------
    def _prefill_fields(self):
        """The pipelined prefill's inputs: the padded suffix (long enough
        for every bucket's whole chunks), the slot's table row, each
        chunk's start position and real length, and the head's row in the
        last chunk."""
        c = self.config
        runs = [(-(-b // _chunk(c, b)), _chunk(c, b))
                for b in c.prefill_buckets]
        chunks = max(n for n, _ in runs)
        return dict(super()._prefill_fields(),
                    ids=(1, max(n * ch for n, ch in runs)),
                    pos=(chunks,), valid=(chunks,), head_idx=(1,))

    def _alloc_state(self):
        super()._alloc_state()
        c = self.config
        cfg = self._model.cfg
        H = cfg.hidden_size
        dtype = self._model.wte.weight.dtype
        mbs = c.slots // c.decode_microbatches
        self._mbs = mbs
        for st in self._stages:
            dev = st.device
            st.bufs["mb"] = torch.zeros((1,), dtype=torch.int64, device=dev)
            if not st.is_first:
                st.bufs["x"] = torch.zeros((mbs, 1, H), dtype=dtype,
                                           device=dev)
            for chunk in _chunk_sizes(c):
                st.bufs["ar", chunk] = torch.arange(chunk, device=dev)
                if not st.is_first:
                    st.bufs["px", chunk] = torch.zeros((1, chunk, H),
                                                       dtype=dtype,
                                                       device=dev)
        last = self._stages[-1].device
        self._head_x = {chunk: torch.zeros((1, chunk, H), dtype=dtype,
                                           device=last)
                        for chunk in _chunk_sizes(c)}
        self._picks = torch.zeros((c.slots,), dtype=torch.int32,
                                  device=last)
        self._logits_out = torch.zeros((c.slots, cfg.vocab_size),
                                       dtype=torch.float32, device=last) \
            if c.capture_logits or c.decode_strategy != "greedy" else None
        # a stage on another device than the engine's reads a mirror of
        # the uploaded inputs on its own device
        self._mirrors = {}
        for st in self._stages:
            key = str(st.device)
            if st.device != self.device and key not in self._mirrors:
                self._mirrors[key] = (
                    graphs.StaticInputs(self._decode_fields(), st.device),
                    graphs.StaticInputs(self._prefill_fields(), st.device))
        self._pp_ticks = 0
        self._pp_busy = np.zeros((c.pp,), np.int64)
        self._decode_tbl = _psched.build_serving_tables(
            c.decode_microbatches, c.pp)
        self._cell_sinks = []         # a step's packed sinks, cell by cell

    def _stage_inputs(self, st, prefill=False):
        """The decode (or prefill) inputs stage `st` reads: the engine's,
        or their mirror on the stage's device."""
        mirror = self._mirrors.get(str(st.device))
        if mirror is None:
            return self._pf if prefill else self._io
        return mirror[1 if prefill else 0]

    def _upload(self, prefill=False):
        """One upload of the step's decode (or prefill) inputs, copied on
        to the mirrors."""
        inputs = self._pf if prefill else self._io
        inputs.upload()
        for mirror in self._mirrors.values():
            mirror[1 if prefill else 0]._dev.copy_(inputs._dev)

    def _stage_adapter_tree(self, st):
        if st.device == self.device:
            return self._adapter_tree
        return self._stage_trees[str(st.device)]

    def _adapters_changed(self):
        super()._adapters_changed()
        self._stage_trees = {
            key: {"layers": tuple({t: (a.to(st_dev), b.to(st_dev))
                                   for t, (a, b) in layer.items()}
                                  for layer in self._adapter_tree["layers"])}
            for key, st_dev in ((str(st.device), st.device)
                                for st in self._stages
                                if st.device != self.device)}

    def _write_adapter_rows(self, rows):
        super()._write_adapter_rows(rows)
        with torch.no_grad():
            for tree in getattr(self, "_stage_trees", {}).values():
                for dst, src in zip(tree["layers"],
                                    self._adapter_tree["layers"]):
                    for t, (a, b) in dst.items():
                        a.copy_(src[t][0])
                        b.copy_(src[t][1])

    def _adapter_executables(self):
        return [f"decode_stage[{s}]" for s in range(self.config.pp)]

    # -- the executables ----------------------------------------------------------
    @staticmethod
    def _parse(name):
        """executable name -> (kind, stage or None, chunk or None)."""
        kind, _, rest = name.partition("[")
        idx = [int(x) for x in rest.rstrip("]").split("][")] if rest else []
        if kind == "prefill_head":
            return kind, None, idx[0]
        return kind, idx[0] if idx else None, idx[1] if len(idx) > 1 \
            else None

    def _executable(self, name):
        kind, s, chunk = self._parse(name)
        if kind == "decode_stage":
            st = self._stages[s]
            return (functools.partial(self._stage_decode_fn, s),
                    self._stage_inputs(st), self._safe_inputs())
        if kind == "prefill_stage":
            return (functools.partial(self._stage_prefill_fn, s, chunk),
                    self._stage_inputs(self._stages[s], prefill=True), None)
        if kind == "prefill_head":
            return (functools.partial(self._prefill_head_fn, chunk),
                    self._stage_inputs(self._stages[-1], prefill=True), None)
        return super()._executable(name)

    def _executable_device(self, name):
        kind, s, _ = self._parse(name)
        if kind == "prefill_head":
            return self._stages[-1].device
        if kind in ("decode_stage", "prefill_stage", "verify_stage"):
            return self._stages[s].device
        return self.device

    def _microbatch(self, st, io, name):
        """Rows of the current microbatch (the stage's `mb` index) of
        decode input `name`."""
        c = self.config
        t = io[name]
        return t.view(c.decode_microbatches, self._mbs,
                      *t.shape[1:]).index_select(0, st.bufs["mb"])[0]

    def _stage_decode_fn(self, s):
        """`decode_stage[s]`: stage s over one microbatch. Returns the
        hidden state for the next stage (last stage: the logits and the
        greedy picks), and the packed sink or None."""
        st = self._stages[s]
        io = self._stage_inputs(st).dev
        x = self._microbatch(st, io, "tokens")[:, None] if st.is_first \
            else st.bufs["x"]
        with self._numerics_scope() as sink:
            y = self._stage_forward(
                st, x, self._microbatch(st, io, "tables"),
                self._microbatch(st, io, "pos"), decode=True,
                op="block_head" if st.is_last else "block",
                adapter_ids=self._microbatch(st, io, "adapter"))
            if not st.is_last:
                _numerics.tap(f"stage{s}.act", y)
                return y, self._stack_sink(sink)
            logits = y[:, 0]
            picks = torch.argmax(logits, dim=-1).to(torch.int32) \
                if self.config.decode_strategy == "greedy" else None
            _numerics.tap("decode.logits", logits)
        return logits, picks, self._stack_sink(sink, picks)

    def _stage_prefill_fn(self, s, chunk):
        """`prefill_stage[s][chunk]`: stage s over one chunk (the stage's
        `mb` index) of the padded suffix; returns (its hidden state,
        None: prefill taps nothing)."""
        st = self._stages[s]
        pf = self._stage_inputs(st, prefill=True).dev
        g = st.bufs["mb"]
        if st.is_first:
            x = pf["ids"][0].index_select(
                0, g * chunk + st.bufs["ar", chunk])[None, :]
        else:
            x = st.bufs["px", chunk]
        return self._stage_forward(st, x, pf["row"],
                                   pf["pos"].index_select(0, g),
                                   valid=pf["valid"].index_select(0, g)), None

    def _prefill_head_fn(self, chunk):
        """`prefill_head[chunk]`: final LayerNorm and head over the last
        chunk's hidden state; returns the last real token's logits
        [1, V]."""
        st = self._stages[-1]
        pf = self._stage_inputs(st, prefill=True).dev
        logits = self._stage_forward(st, self._head_x[chunk], None, None,
                                     op="head")
        return logits[0].index_select(0, pf["head_idx"].to(torch.int64))

    def _decode_fn(self, io=None):
        """The whole model's decode forward over every slot, stage after
        stage outside the ring: what the numerics localizer's probes
        replay eagerly."""
        io = self._io.dev if io is None else io
        x = io["tokens"][:, None]
        with self._numerics_scope() as sink:
            for st in self._stages:
                dev = st.device
                x = self._stage_forward(
                    st, x.to(dev), io["tables"].to(dev), io["pos"].to(dev),
                    decode=True, op="block_head" if st.is_last else "block",
                    adapter_ids=io["adapter"].to(dev))
            logits = x[:, 0]
            picks = torch.argmax(logits, dim=-1).to(torch.int32) \
                if self.config.decode_strategy == "greedy" else None
            _numerics.tap("decode.logits", logits)
        return logits, picks, self._stack_sink(sink, picks)

    # -- the ring ------------------------------------------------------------------
    def _prepare(self, names):
        """Capture every executable a ring will replay before its one
        upload (a capture uploads its safe state into the inputs)."""
        if self._libraries is None:
            self._ensure_libraries()
        for name in names:
            self._capture(name)

    def _ride_ring(self, tbl, exe_name, take, hop_buffer):
        """Walk a forward tick table: for every busy (tick, stage) cell,
        set the stage's microbatch index, run its executable
        (`exe_name(s)`), and hand the output on: a non-last stage's hidden
        state to the next stage's buffer (`hop_buffer(st)`; the
        `serving.pp_handoff` site fires first), a last stage's to
        `take(g, out)`. 3-D (tokens-per-tick) tables walk the same cells,
        each cell's token slots collapsing to their microbatch. Stages run
        from the last to the first within a tick (module docstring)."""
        for t in range(tbl.shape[0]):
            for s in reversed(range(self.config.pp)):
                g = int(tbl[t, s] if tbl.ndim == 2 else tbl[t, s, 0])
                if g < 0:
                    continue
                if tbl.ndim == 3:
                    g //= tbl.shape[2]
                st = self._stages[s]
                st.bufs["mb"].fill_(g)
                self._pp_busy[s] += 1
                out = self._run(exe_name(s), upload=False)
                if st.is_last:
                    take(g, out)
                    continue
                y, packed = out
                if packed is not None:
                    self._cell_sinks.append((packed[0], packed[1].clone(),
                                             0))
                _faults.fire("serving.pp_handoff")
                hop_buffer(self._stages[s + 1]).copy_(y)
            self._pp_ticks += 1

    def decode(self):
        """Advance every slot one token by running the M-microbatch ring
        through the stages; returns np.int32 [slots]."""
        _faults.fire("serving.decode_step")
        self._fire_kv_quant_chaos()
        self._fire_numerics_chaos()
        self.ensure_decode_capacity()
        c = self.config
        mbs = self._mbs
        if self._numerics_armed:             # the localizer's replay
            self._last_decode_inputs = {n: a.copy()
                                        for n, a in self._io.host.items()}
        self._prepare([f"decode_stage[{s}]" for s in range(c.pp)])
        self._cell_sinks = []

        def take(g, out):
            logits, picks, packed = out
            rows = slice(g * mbs, (g + 1) * mbs)
            if picks is not None:
                self._picks[rows].copy_(picks)
            if self._logits_out is not None:
                self._logits_out[rows].copy_(logits)
            if packed is not None:
                self._cell_sinks.append(
                    (packed[0], packed[1].clone(),
                     0 if picks is None else mbs))

        with RecordEvent("serving::decode_step",
                         TracerEventType.UserDefined,
                         {"slots": c.slots, "paged": True, "pp": c.pp,
                          "tp": c.tp, "microbatches": c.decode_microbatches,
                          "kv_dtype": c.kv_dtype,
                          "attend": c.attention_impl}):
            self._upload()
            self._ride_ring(self._decode_tbl, lambda s: f"decode_stage[{s}]",
                            take, lambda st: st.bufs["x"])
        self._pos[:] = np.minimum(self._pos + 1, c.max_len - 1)
        if c.capture_logits:
            self.last_logits = self._logits_out.cpu().numpy()
        picks = self._picks.cpu().numpy() \
            if c.decode_strategy == "greedy" else None
        out = self._select_slots(self._logits_out, picks)
        self._ingest_cell_sinks()
        self._slot_gen += 1
        self._last_tokens[:] = out
        self._export_pp_stats()
        return out

    def _ingest_cell_sinks(self):
        for names, packed, n_head in self._cell_sinks:
            self._ingest_numerics(self._unstack_sink((names, packed),
                                                     n_head)[1])
        self._cell_sinks = []

    def _prefill_execute(self, row, suffix, start, bucket):
        """The pipelined prefill (module docstring): the suffix's whole
        chunks ride the forward tick table through the stages; returns
        the last real token's logits from the head executable."""
        c = self.config
        chunk = _chunk(c, bucket)
        length = int(suffix.size)
        n_run = max(1, -(-length // chunk))
        pf = self._pf.host
        pf["ids"][0] = 0
        pf["ids"][0, :length] = suffix
        pf["row"][0] = row
        g = np.arange(n_run)
        pf["pos"][:n_run] = start + g * chunk
        pf["valid"][:n_run] = np.clip(length - g * chunk, 0, chunk)
        pf["head_idx"][0] = (length - 1) - (n_run - 1) * chunk
        self._prepare([f"prefill_stage[{s}][{chunk}]" for s in range(c.pp)]
                      + [f"prefill_head[{chunk}]"])
        self._upload(prefill=True)

        def take(g, out):
            if g == n_run - 1:
                self._head_x[chunk].copy_(out[0])
        self._ride_ring(_psched.build_serving_tables(n_run, c.pp),
                        lambda s: f"prefill_stage[{s}][{chunk}]", take,
                        lambda st: st.bufs["px", chunk])
        last = self._run(f"prefill_head[{chunk}]", upload=False)
        self._export_pp_stats()
        return last

    # -- observability / introspection ------------------------------------------
    def _export_pp_stats(self):
        stats = self.pp_stats()
        _M_BUBBLE.set(stats["bubble_fraction"])
        for s, b in enumerate(stats["stage_busy"]):
            _M_STAGE_BUSY.labels(stage=str(s)).set(b)

    def pp_stats(self):
        """Lifetime tick accounting: {ticks, stage_busy[s],
        bubble_fraction}: what the gauges, the scheduler's step records
        and the serving worker's STAT carry."""
        t = max(self._pp_ticks, 1)
        work = int(self._pp_busy.sum())
        return {"ticks": int(self._pp_ticks),
                "stage_busy": [float(b) / t for b in self._pp_busy],
                "bubble_fraction": float(1.0 - work / (t * self.config.pp))}

    def reset_pp_stats(self):
        """Start a new accounting window: the ticks and busy cells counted
        so far are dropped (the gauges read the new window from the next
        ring on)."""
        self._pp_ticks = 0
        self._pp_busy[:] = 0

    def stage_report(self):
        """Per stage: its layer range, its device, and the heads each of
        its shards holds of the stage's layer-0 K pool."""
        return [{"layers": [st.start, st.stop], "device": str(st.device),
                 "heads_per_shard": {sh.name: int(sh.pool[0].k.shape[2])
                                     for sh in st.shards}}
                for st in self._stages]


class PipelineParallelSpecConfig(_spec.SpecDecodeConfig,
                                 PipelineParallelEngineConfig):
    """SpecDecodeConfig's speculative knobs (gamma, draft_layers,
    greedy-only) over PipelineParallelEngineConfig's shape (pp, tp,
    decode_microbatches, prefill_chunk, stage_layers)."""

    _DICT_FIELDS = PipelineParallelEngineConfig._DICT_FIELDS + (
        "gamma", "draft_layers")


class PipelineParallelSpeculativeEngine(_spec.SpeculativeEngine,
                                        PipelineParallelPagedEngine):
    """Speculative decode on the pipeline ring.

    The draft (the target's first `draft_layers` blocks, embeddings and
    final LayerNorm, or a draft model of its own) runs on the first
    stage's device against its dense cache, as on one device; its weights
    are a copy of their own there (the masters live on the host), a real
    stage-0 byte bill that `hbm_accounting` counts. The verify window
    [mbs, gamma+1] of every slot microbatch rides the same forward tick
    table as one-token decode (`build_serving_tables(M, pp,
    tokens_per_tick=gamma+1)`), one `verify_stage[s]` graph a stage: stage
    0 embeds the window, the last taps `spec.verify_logits` and applies
    `sampling.greedy_verify`. Each stage writes the window's K/V into its
    own pools through the shared tables, so a rejection is the host's
    position rollback on every stage at once. Greedy streams equal the
    one-token pp engine's."""

    def __init__(self, model, config=None, draft=None, device="cuda",
                 devices=None, **kwargs):
        config = config or PipelineParallelSpecConfig(**kwargs)
        if not isinstance(config, PipelineParallelSpecConfig):
            raise TypeError("PipelineParallelSpeculativeEngine needs a "
                            "PipelineParallelSpecConfig")
        self._stage_devices = devices
        _spec.SpeculativeEngine.__init__(self, model, config, draft=draft,
                                         device=device)
        c = self.config
        W = c.gamma + 1
        H = self._model.cfg.hidden_size
        dtype = self._model.wte.weight.dtype
        for st in self._stages[1:]:
            st.bufs["vx"] = torch.zeros((self._mbs, W, H), dtype=dtype,
                                        device=st.device)
        last = self._stages[-1].device
        self._verify_out = torch.zeros((c.slots, W + 2), dtype=torch.int32,
                                       device=last)
        self._window_last = self._window if last == self.device else \
            torch.zeros_like(self._window, device=last)
        self._verify_tbl = _psched.build_serving_tables(
            c.decode_microbatches, c.pp, tokens_per_tick=W)

    # -- the draft on the first stage's device ----------------------------------
    def _build_draft_decode_params(self):
        """The draft's tensors that are the target's (the truncated draft)
        get copies of their own on the first stage's device; an int8 draft
        quantizes them there. A swap refreshes both in place."""
        dev = self._stages[0].device
        if not hasattr(self, "_draft_shared"):
            self._draft_shared = {n for n, t in self._draft_params.items()
                                  if t is self._params.get(n)}
            self._draft_params = {
                n: (t.detach().to(dev, copy=True)
                    if n in self._draft_shared else t)
                for n, t in self._draft_params.items()}
        self._draft_decode_params = self._draft_params \
            if self.config.weight_dtype != "int8" \
            else self._quantize_params(self._draft_params)

    def _refresh_decode_params(self):
        super()._refresh_decode_params()
        with torch.no_grad():
            for n in self._draft_shared:
                self._draft_params[n].copy_(self._params[n])
            for n, v in self._draft_decode_params.items():
                if isinstance(v, dict):
                    codes, s_b = _quantize_weight(self._draft_params[n])
                    v["q"].copy_(codes)
                    v["scale"].copy_(s_b)

    def _resident_groups(self):
        """The shards', plus the draft's weights and dense caches on the
        first stage's device."""
        weights = []
        for src in (self._draft_params, self._draft_decode_params):
            for v in src.values():
                weights.extend((v["q"], v["scale"]) if isinstance(v, dict)
                               else (v,))
        kv = [x for cache in [self._draft_cache,
                              *self._draft_local.values()]
              for layer in cache.layers for x in (layer.k, layer.v)]
        return super()._resident_groups() + [
            ("draft", self._stages[0].device, weights, kv)]

    # -- the executables ----------------------------------------------------------
    def _adapter_executables(self):
        return super()._adapter_executables() + [
            f"verify_stage[{s}]" for s in range(self.config.pp)]

    def _executable(self, name):
        kind, s, _ = self._parse(name)
        if kind == "verify_stage":
            return (functools.partial(self._stage_verify_fn, s),
                    self._stage_inputs(self._stages[s]),
                    self._safe_inputs())
        return super()._executable(name)

    def _stage_verify_fn(self, s):
        """`verify_stage[s]`: stage s over one microbatch's window; the
        last stage returns [mbs, gamma+3] int32 (choices, n_accepted,
        last) and the packed sink."""
        st = self._stages[s]
        io = self._stage_inputs(st).dev
        W = self.config.gamma + 1
        if st.is_first:
            x = self._window.view(-1, self._mbs, W).index_select(
                0, st.bufs["mb"])[0]
        else:
            x = st.bufs["vx"]
        with self._numerics_scope() as sink:
            y = self._stage_forward(
                st, x, self._microbatch(st, io, "tables"),
                self._microbatch(st, io, "pos"), decode=True,
                op="block_head" if st.is_last else "block",
                adapter_ids=self._microbatch(st, io, "adapter"))
            if not st.is_last:
                _numerics.tap(f"stage{s}.act", y)
                return y, self._stack_sink(sink)
            window = self._window_last.view(-1, self._mbs, W).index_select(
                0, st.bufs["mb"])[0]
            choices, n_acc, last = sampling.greedy_verify(y, window)
            _numerics.tap("spec.verify_logits", y)
        res = torch.cat([choices, n_acc[:, None], last[:, None]], dim=1)
        return res, self._stack_sink(sink, res)

    # -- public compute API ---------------------------------------------------------
    def decode_many(self):
        """One speculative round over the stage ring: gamma draft decodes
        on the first stage's device, then every microbatch's verify
        window through the stages, then the host's position rollback.
        Returns (tokens [S, gamma+1], n_emit [S]) as the single-device
        speculative engine does."""
        _faults.fire("serving.decode_step")
        self._fire_kv_quant_chaos()
        self._fire_numerics_chaos()
        self.ensure_decode_capacity()
        c = self.config
        W = c.gamma + 1
        mbs = self._mbs
        self._prepare(["draft_decode"] + [f"verify_stage[{s}]"
                                          for s in range(c.pp)])
        self._cell_sinks = []
        t0 = time.perf_counter()
        with RecordEvent("serving::spec_draft", TracerEventType.UserDefined,
                         {"gamma": c.gamma, "slots": c.slots, "pp": c.pp,
                          "tp": c.tp}):
            self._upload()
            self._run("draft_decode", upload=False)
            if self._window_last is not self._window:
                self._window_last.copy_(self._window)
        draft_s = time.perf_counter() - t0
        _spec._M_DRAFT_SECONDS.observe(draft_s)
        t1 = time.perf_counter()

        def take(g, out):
            res, packed = out
            self._verify_out[g * mbs:(g + 1) * mbs].copy_(res)
            if packed is not None:
                self._cell_sinks.append((packed[0], packed[1].clone(),
                                         res.numel()))
        with RecordEvent("serving::spec_verify",
                         TracerEventType.UserDefined,
                         {"window": W, "slots": c.slots, "pp": c.pp,
                          "microbatches": c.decode_microbatches,
                          "attend": c.attention_impl}):
            self._ride_ring(self._verify_tbl,
                            lambda s: f"verify_stage[{s}]", take,
                            lambda st: st.bufs["vx"])
            res = self._verify_out.cpu().numpy()
        verify_s = time.perf_counter() - t1
        _spec._M_VERIFY_SECONDS.observe(verify_s)
        out = np.ascontiguousarray(res[:, :-2])
        n_emit, last = res[:, -2] + 1, res[:, -1]
        self._pos[:] = np.minimum(self._pos + n_emit, c.max_len - 1)
        self._draft_pos[:] = self._pos
        self._slot_gen += n_emit
        self._last_tokens[:] = last
        self.last_spec_stats = {"draft_s": draft_s, "verify_s": verify_s}
        self._ingest_cell_sinks()
        self._export_pp_stats()
        return out, n_emit


def free_eager_device_copies(model):
    """Move every parameter and buffer of `model` to the host in place,
    freeing the device memory the model held: the sharded engines keep
    their own copies on the stage devices and their masters on the host,
    so after an engine is built the model's device tensors are waste. The
    model stays usable (a `state_dict` swap source, eager forwards on the
    CPU). A truncated draft shares the target's parameters, so it moves
    with it. Returns (tensors moved, bytes freed)."""
    moved = freed = 0
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.device.type == "cpu":
                continue
            freed += t.numel() * t.element_size()
            t.data = t.data.cpu()
            moved += 1
    return moved, freed
