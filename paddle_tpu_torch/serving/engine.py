"""Prefill/decode engines over a GPT: the compute layer of serving.

Counterpart of `paddle_tpu/serving/engine.py` (`EngineConfig`,
`GenerationEngine`, `PagedEngineConfig`, `PagedGenerationEngine`).
Generation has two phases: prefill runs a whole prompt once per request,
right-padded to the nearest length bucket; decode advances every slot one
token per step. Slot lifecycle (who occupies which slot, retirement,
refill) belongs to `scheduler.Scheduler`; the engines only compute.

Every forward is functional: `torch.func.functional_call` runs the module
over a param dict. `_params` is the engine's own copy of the module's
weights and serves prefill; `_decode_params` serves decode and is the same
dict, or with `weight_dtype="int8"` int8 codes plus per-output-channel
scales that each decode forward dequantizes with plain torch before the
float matmuls. `swap_params` copies new weights into that storage in
place (weight hot-swap) and leaves the module untouched.

The paged engine's serving executables (`executable_names()`: `decode`
and `prefill[bucket]`) run on the card as CUDA graphs, captured once per
engine (`precompile()`, or on first use) and replayed (`graphs.py`): the
port's counterpart of the JAX engines' compile-once executables.
`capture_counts` counts captures as the JAX `trace_counts` count traces
(`trace_counts`, the serving worker's STAT field, answers with them),
and `kernel_launches` the paged-attention kernel launches the engine's
calls made (0 for the gather path and on the CPU). `make_engine` builds
an engine from a serving worker's kind and config: "dense", "paged",
"spec", and the multi-device "tp", "pp" and "spec_pp"
(`distributed/tp.py`, `pp.py`). `hbm_accounting()` gives the resident
bytes of weights and KV by shard and by device. The KV handoff
(`extract_kv`, `extract_kv_wire`, `adopt_kv`, `prefix_probe`,
`extract_prefix_kv`, `restore_prefix`) writes the pools in place, so the
graphs keep reading the KV it moves.

Fault sites, in the reference's order and each before any engine state
moves, so a raise leaves the positions, the tables, the packed inputs and
the weights as they were: `serving.decode_step` first in `decode()`,
`serving.kv_quant` next on int8 pools (truncate multiplies one in-use
block's layer-0 K and V scale rows by 64 in place, the storage the decode
graph reads), `serving.weight_swap` first in `swap_params`, and
`serving.kv_restore` in `restore_prefix` (raise or truncate restores
nothing and ticks `serving_kv_tier_corrupt_total`); `serving.block_alloc`
fires in the block pool. The `serving::prefill` and
`serving::decode_step` spans wrap the executables (`paddle_tpu_torch.
profiler.RecordEvent`, a `record_function` range while a torch profiler
records).

KV tiers (`PagedEngineConfig(enable_kv_tiers=True)`): a
`kv_tiers.TieredBlockStore` under the prefix cache. Eviction copies a
block's pool-native slabs to the host through page-locked buffers
(`_tier_read_block`) before the block goes back to the pool; a prefill
whose chain continues in a tier promotes the run back with one batched
in-place write (`_tier_write_blocks`: `index_copy_` over the run's block
ids, no padding, no new pool, no capture). `trace_counts["tier_restore"]`
reads 0 until the first restore and 1 after it, as the JAX engine counts
its one restore program's trace (the port's restore is eager: a run's
length varies and no graph needs a fixed shape); it is absent with the
tiers off. `last_prefill_stats` gains `tier_promoted_blocks` and
`tier_restore_s`.

LoRA adapters (`attach_adapters(tenancy.AdapterBank)`): the bank's
stacked per-slot `A`/`B` rows live in device tensors the engine owns and
writes in place (`swap_adapter`, `drop_adapter` copy one row), and each
slot's adapter id is an int32 field of the decode inputs, so a rebind
(`set_slot_adapter`) is a host write plus the upload every call makes.
Decode and verify forwards add the gathered delta; prefill runs the base
weights, as in the reference. Attaching a bank after the decode graph was
captured captures it once more (the JAX engine retraces once);
`set_slot_adapter`, `swap_adapter` and `drop_adapter` capture nothing.
Without a bank the decode graph is the adapter-free one. The
`serving.adapter_swap` site fires first in `swap_adapter`.

KV ledger (`observability.kvledger`, on unless `PTN_KV_LEDGER=0`): the
paged engine builds one `KVLedger` with its block pool, priced by
`_kv_block_bytes()`, attaches it to the pool, the prefix cache and the
tier store, and exposes it as `engine.kv_ledger`; the scheduler labels its
events and reconciles it every step. It is host bookkeeping only: streams
and capture counts are the same with it on or off.

Numerics taps (`EngineConfig(numerics_taps=True)`, off by default): the
executables open a `numerics.sink_scope` and compute one stats vector a
site inside the captured graph, `decode.logits` and `prefill.logits`
(`kv.scale` and `kv.codes` on int8 pools, `weights.scale` and `weights.q`
on int8 decode weights, `adapter.delta` with a bank; the speculative
engine adds `spec.verify_logits`). The stats are stacked in the graph and
read with the step's own host read (decode and verify pack them behind
the greedy picks; a prefill reads them once more); warm-ups and captures
are never read, so no safe-state step reaches `numerics_monitor`, which
classifies each step's sink (`last_numerics`). A disarmed engine captures
the graphs it captures without the plane. The first nonfinite anomaly
runs `localize_numerics`: the step's saved decode inputs replay eagerly,
outside any graph, through per-layer probes (`tap_layer`), and the blocks
the step wrote are put back as the live step left them; the probes count
under `trace_counts["numerics_probe"]`, never `decode`. The
`numerics.corrupt` site fires in `decode()` (and the speculative round)
and damages the named decode tensor in place. An armed engine gives every
float decode entry storage of its own (a copy of the float weights: the
whole model for float32 decode weights, the LayerNorms, biases and `wpe`
for int8 ones), so the damage reaches the captured decode graph and never
the prefill masters; a disarmed float engine's decode storage is the
masters themselves, so there it reaches prefill too.

Warm start (`framework/compile_cache.py`): `EngineConfig(
compile_cache_dir=)` gives the engine a private compile cache, through
which `precompile()` (and the first call) resolves the kernel libraries
its executables launch (`_kernels/build.py`: the private cache, else the
attached global one, else the default build directory). What a warm
process reuses is those libraries; the CUDA graphs are captured again in
every process. `save_for_generation` writes a servable artifact: the
weights in the JAX layout (`.pdiparams`, `framework.io`), and a `.gencfg`
record of the GPT config, the engine kind, its `as_dict()` and the
executable set, which `inference.Predictor` (and the JAX package's
`load_generation_model`) rebuild from. No `.pdmodel` is written: there is
no StableHLO program in the port.
"""
import functools
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import faults as _faults
from ..observability import flight_recorder as _flight_recorder
from ..observability import kvledger as _kvl
from ..observability import numerics as _numerics
from ..ops import paged_attention as _pa
from ..profiler import RecordEvent, TracerEventType
from . import blocks
from . import graphs
from . import kv_cache as kvc
from . import sampling
from .kv_tiers import TieredBlockStore, corrupt_counter
from .prefix_cache import PrefixCache, prefix_key

__all__ = ["EngineConfig", "GenerationEngine", "PagedEngineConfig",
           "PagedGenerationEngine", "DEFAULT_BUCKETS", "make_engine",
           "save_for_generation", "default_compile_cache_dir",
           "load_generation_model", "read_gencfg", "artifact_prefix",
           "GENCFG_SUFFIX", "COMPILE_CACHE_DIRNAME"]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)
GENCFG_SUFFIX = ".gencfg"
COMPILE_CACHE_DIRNAME = "_compile_cache"


def _quantize_weight(w):
    """One decode-matmul weight [out, in] -> (int8 codes, f32 scales
    [out, 1]) per output channel: abs-max over the input axis, clamped at
    1e-30, then `blocks.quantize_codes`. An `nn.Linear` weight's output
    channels are its axis 0 (the JAX `[in, out]` weights quantize the same
    channels on axis 1), and so are the tied head's vocab rows of
    `wte.weight`."""
    w = w.to(torch.float32)
    s_b = torch.clamp(torch.amax(torch.abs(w), dim=1, keepdim=True),
                      min=1e-30)
    return blocks.quantize_codes(w, s_b), s_b


class EngineConfig:
    """Slot, bucket and strategy knobs for one GenerationEngine.

    `compile_cache_dir` gives the engine a private compile cache for the
    kernel libraries its executables launch (see the module docstring).
    The path is machine-local and not part of `as_dict()`: an artifact
    records what to build, each loader decides where the libraries
    live."""

    def __init__(self, slots=4, max_len=256, prefill_buckets=None,
                 decode_strategy="greedy", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, seed=0,
                 compile_cache_dir=None, numerics_taps=False):
        self.slots = int(slots)
        self.max_len = int(max_len)
        # the ladder always ends in a max_len bucket so every prompt the
        # cache can hold has a prefill shape
        buckets = prefill_buckets or (
            [b for b in DEFAULT_BUCKETS if b < max_len] + [max_len])
        self.prefill_buckets = tuple(sorted(int(b) for b in buckets))
        self.decode_strategy = decode_strategy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        self.compile_cache_dir = compile_cache_dir
        # arms the numerics taps in the executables (see the module
        # docstring); decided when the engine is built
        self.numerics_taps = bool(numerics_taps)

    # the fields the `.gencfg` serving record round-trips, the JAX
    # package's: seed is in (it keeps a rebuilt engine's sampled streams
    # the saved one's), compile_cache_dir is out (machine-local)
    _DICT_FIELDS = ("slots", "max_len", "prefill_buckets",
                    "decode_strategy", "temperature", "top_k", "top_p",
                    "eos_token_id", "seed", "numerics_taps")

    def as_dict(self):
        """JSON-serializable ctor kwargs: `type(cfg)(**cfg.as_dict())`
        rebuilds the config, and the `.gencfg` record stores this."""
        out = {}
        for f in self._DICT_FIELDS:
            v = getattr(self, f)
            out[f] = list(v) if isinstance(v, tuple) else v
        return out


class GenerationEngine:
    """Dense engine: one preallocated [slots, max_len, heads, head_dim]
    K/V buffer per layer. The base class of the paged engine and its
    parity oracle."""

    def __init__(self, model, config=None, device="cuda", **kwargs):
        from ..text.models.gpt import GPT
        if not isinstance(model, GPT):
            raise TypeError("GenerationEngine serves GPT-family models; got "
                            f"{type(model).__name__}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 matmuls (qkv, out_proj, fc1, fc2, the tied head) stay
            # full float32 on the card, no TF32, as the JAX reference
            # computes them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"device is {self.device}; build the model "
                             f"with device={str(self.device)!r}")
        self.config = config or self._config_cls(**kwargs)
        if self.config.max_len > model.cfg.max_position_embeddings:
            raise ValueError(
                f"max_len={self.config.max_len} exceeds the model's "
                f"max_position_embeddings={model.cfg.max_position_embeddings}")
        self._model = model
        # the numerics plane: the monitor that classifies each step's
        # sink, the saved inputs of the last decode step (the localizer
        # replays them) and the localizer's probe state
        self.numerics_monitor = _numerics.NumericsMonitor(
            auto_bundle=False) if self._numerics_armed else None
        self.last_numerics = None
        self.last_localization = None
        self._last_decode_inputs = None
        self._numerics_probe_layers = None
        self._numerics_probes = 0
        # the engine's own copy of the weights: prefill serves this dict,
        # decode the derived `_decode_params`; a swap copies into it
        with torch.no_grad():
            self._params = {n: p.detach().clone()
                            for n, p in model.named_parameters()}
        self._build_decode_params()
        self._last_tokens = np.zeros((self.config.slots,), np.int32)
        # per-slot sampler state: slot s's next token is generation index
        # _slot_gen[s] of the request seeded _slot_seeds[s]
        self._slot_seeds = np.zeros((self.config.slots,), np.int64)
        self._slot_gen = np.zeros((self.config.slots,), np.int64)
        self._rng_nonce = 0
        self.kernel_launches = 0
        # per-tenant LoRA adapters: the attached bank, the engine's device
        # copy of its rows, and each slot's adapter id (0 = base)
        self._adapter_bank = None
        self._adapter_tree = None
        self._slot_adapter = np.zeros((self.config.slots,), np.int32)
        # the engine's private compile cache (None: the global or default
        # one) and how this process got the libraries it launches
        self._compile_cache = None
        if self.config.compile_cache_dir:
            from ..framework.compile_cache import CompileCache
            self._compile_cache = CompileCache(self.config.compile_cache_dir)
        self._libraries = None
        self.last_precompile_stats = {}
        self._alloc_state()

    _config_cls = EngineConfig

    def _alloc_state(self):
        cfg = self._model.cfg
        self._cache = kvc.alloc_cache(
            cfg.num_layers, self.config.slots, self.config.max_len,
            cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            self._model.wte.weight.dtype, self.device)

    # -- token selection ----------------------------------------------------
    def _generator(self, slot):
        """The generator for slot's next token, seeded from the request's
        (seed, generation index) alone."""
        g = torch.Generator(device=self.device)
        g.manual_seed(sampling.slot_generator_seed(self._slot_seeds[slot],
                                                   self._slot_gen[slot]))
        return g

    def _select(self, logits, slot):
        c = self.config
        gen = self._generator(slot) \
            if c.decode_strategy == "sampling" else None
        return sampling.select_tokens(
            logits, generator=gen, strategy=c.decode_strategy,
            temperature=c.temperature, top_k=c.top_k, top_p=c.top_p)

    def _select_slots(self, logits, picks=None):
        """[slots, V] -> np.int32 [slots]; sampling draws each row from its
        own slot's generator. `picks`: the greedy argmax when the caller
        computed it already (inside a decode graph)."""
        if self.config.decode_strategy == "greedy":
            if picks is None:
                picks = torch.argmax(logits, dim=-1)
            if isinstance(picks, np.ndarray):     # read with the stats
                return picks.astype(np.int32)
            return picks.to(torch.int32).cpu().numpy()
        return np.array([int(self._select(logits[s:s + 1], s)[0])
                         for s in range(logits.shape[0])], np.int32)

    def _default_slot_seed(self):
        self._rng_nonce += 1
        return (self.config.seed * 2654435761
                + self._rng_nonce * 40503) & 0x7FFFFFFF

    def set_slot_rng(self, slot, seed, gen):
        """Arm slot's sampler: its next token is generation index `gen` of
        the request seeded `seed`."""
        self._slot_seeds[int(slot)] = int(seed)
        self._slot_gen[int(slot)] = int(gen)

    def slot_rng(self, slot):
        """(seed, gen) with gen the generation index of the slot's NEXT
        token: what a KV-handoff bundle carries for the adopting engine
        to continue a sampled stream."""
        return (int(self._slot_seeds[int(slot)]),
                int(self._slot_gen[int(slot)]))

    # -- helpers --------------------------------------------------------------
    def bucket_for(self, length):
        for b in self.config.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"{self.config.prefill_buckets[-1]} (max_len="
            f"{self.config.max_len})")

    def _check_prompt(self, prompt_ids):
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if self.config.max_len - prompt.size < 1:
            raise ValueError(
                f"prompt length {prompt.size} leaves no decode headroom "
                f"(max_len={self.config.max_len})")
        return prompt

    def _padded(self, tokens, bucket):
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :tokens.size] = tokens
        return torch.from_numpy(padded).to(self.device)

    def _forward(self, ids, cache, params=None, adapters=None):
        """One functional model forward over `params` (default: the float
        serving dict), with the per-slot adapter view when given."""
        kwargs = {"cache": cache}
        if adapters is not None:
            kwargs["adapters"] = adapters
        with torch.no_grad():
            return torch.func.functional_call(
                self._model, self._params if params is None else params,
                (ids,), kwargs)

    def _tap_decode(self, logits):
        """The decode taps after the forward: its last-token logits and,
        with a bank attached, the adapter rows."""
        _numerics.tap("decode.logits", logits)
        if self._adapter_bank is not None:
            _numerics.tap_tree("adapter.delta", self._adapter_tree["layers"])

    def _decode_forward(self, ids, cache, adapter_ids=None):
        """A decode (or verify) forward: over `_decode_params`, int8
        entries dequantized first, plus each slot's adapter delta when a
        bank is attached (the slots' adapter ids: `adapter_ids`, default
        the engine's)."""
        params = self._dequant_params(self._decode_params)
        if self._adapter_bank is None:
            return self._forward(ids, cache, params)
        return self._forward(ids, cache, params, adapters={
            "slot": self._adapter_ids() if adapter_ids is None
            else adapter_ids,
            "layers": self._adapter_tree["layers"]})

    # -- per-tenant LoRA adapters -------------------------------------------
    def _adapter_ids(self):
        """The slots' adapter ids as the decode forward reads them."""
        return torch.from_numpy(self._slot_adapter).to(self.device)

    def attach_adapters(self, bank):
        """Attach a `tenancy.AdapterBank`: from the next decode step each
        slot adds its adapter row's delta. The engine copies the bank's
        rows into device tensors it owns; a later bank of the same
        geometry is copied into them in place, another geometry gets new
        tensors (and the paged engines capture their adapter graphs
        again, as the JAX engine retraces)."""
        same = self._adapter_bank is not None and \
            self._adapter_bank.geometry() == bank.geometry()
        self._adapter_bank = bank
        if same:
            self._write_adapter_rows(range(bank.n_adapters))
        else:
            self._adapter_tree = bank.device_tree(self.device)
            self._adapters_changed()

    def _adapters_changed(self):
        """Hook: the adapter tensors the decode forwards read were
        replaced (the paged engines drop their captured graphs)."""

    def _write_adapter_rows(self, rows):
        """Copy bank rows `rows` into the engine's device tensors in
        place (the storage a captured decode graph reads)."""
        bank = self._adapter_bank
        with torch.no_grad():
            for i, layer in enumerate(self._adapter_tree["layers"]):
                for t, (a, b) in layer.items():
                    ha, hb = bank.rows(i, t)
                    for r in rows:
                        a[r].copy_(torch.from_numpy(ha[r]))
                        b[r].copy_(torch.from_numpy(hb[r]))

    @property
    def adapter_bank(self):
        """The attached `tenancy.AdapterBank`, or None."""
        return self._adapter_bank

    def set_slot_adapter(self, slot, idx):
        """Bind engine slot `slot` to adapter row `idx` (0 = base): a host
        int32 write; the next decode gathers the new row."""
        self._slot_adapter[int(slot)] = np.int32(idx)

    def slot_adapter(self, slot):
        return int(self._slot_adapter[int(slot)])

    def swap_adapter(self, tenant, state):
        """Load or replace one tenant's adapter between decode steps.
        `serving.adapter_swap` fires first; the bank then validates every
        tensor before it writes a row, so any failure leaves every
        tenant's adapter serving as it was. The tenant's row is copied
        into the engine's tensors in place: nothing is captured again.
        Returns the tenant's adapter row."""
        if self._adapter_bank is None:
            raise ValueError("no adapter bank attached "
                             "(engine.attach_adapters)")
        _faults.fire("serving.adapter_swap")
        idx = self._adapter_bank.load(tenant, state)
        self._write_adapter_rows([idx])
        return idx

    def drop_adapter(self, tenant):
        """Zero a tenant's adapter row (its slots fall back to base)."""
        if self._adapter_bank is None:
            return None
        idx = self._adapter_bank.drop(tenant)
        if idx is not None:
            self._write_adapter_rows([idx])
        return idx

    # -- decode params and weight hot-swap ----------------------------------
    def _build_decode_params(self):
        """The param set decode runs on: the float dict itself here (its
        own copy when the numerics taps are armed); the paged engine
        quantizes it for weight_dtype="int8"."""
        self._decode_params = self._own_decode_storage(self._params)

    def _own_decode_storage(self, params):
        """Armed: every entry of `params` that is a master tensor gets a
        copy of its own, so the `numerics.corrupt` site damages what
        decode reads and never what prefill reads. Disarmed: `params`."""
        if not self._numerics_armed:
            return params
        with torch.no_grad():
            return {n: (v.detach().clone() if v is self._params.get(n)
                        else v) for n, v in params.items()}

    def _refresh_decode_params(self):
        """Re-derive the decode set from `_params` in place after a swap:
        int8 entries requantize, float entries with storage of their own
        take a copy (an entry that is `_params`' tensor needs nothing)."""
        with torch.no_grad():
            for name, v in self._decode_params.items():
                if isinstance(v, dict):
                    codes, s_b = _quantize_weight(self._params[name])
                    v["q"].copy_(codes)
                    v["scale"].copy_(s_b)
                elif v is not self._params[name]:
                    v.copy_(self._params[name])

    # -- the numerics plane ----------------------------------------------------
    @property
    def _numerics_armed(self):
        return self.config.numerics_taps

    def _numerics_scope(self):
        """A sink scope when the taps are armed (with the localizer's layer
        filter while it probes), else a null scope: the disarmed forward
        is the forward without the plane."""
        if not self._numerics_armed:
            return _numerics.null_scope()
        return _numerics.sink_scope(self._numerics_probe_layers)

    @staticmethod
    def _stack_sink(sink, head=None):
        """An executable's sink as (site names, one int32 tensor): `head`
        (the greedy picks, int32) first when given, then the [n, 4]
        float32 stats' bits, so the host reads both in one copy. None
        when the taps are disarmed."""
        if sink is None:
            return None
        names = tuple(sink)
        bits = torch.stack([sink[n] for n in names]).reshape(-1).view(
            torch.int32)
        return names, (bits if head is None else torch.cat(
            [head.to(torch.int32).reshape(-1), bits]))

    @staticmethod
    def _unstack_sink(packed, n_head=0):
        """The host side of `_stack_sink`: one copy to the host, then
        (head int32 [n_head] or None, {site: float32 [4]})."""
        names, t = packed
        host = t.cpu().numpy()
        stats = host[n_head:].view(np.float32).reshape(len(names), 4)
        return (host[:n_head] if n_head else None,
                dict(zip(names, stats)))

    def _host_sink(self, sink):
        """An eager sink on the host: {site: float32 [4]}."""
        return self._unstack_sink(self._stack_sink(sink))[1]

    def _ingest_numerics(self, sink):
        """Feed one step's sink ({site: [4]}) through the monitor. The
        first nonfinite anomaly runs the localizer over the saved decode
        inputs and then dumps the postmortem bundle, so detection,
        localization and the bundle land in the same step."""
        mon = self.numerics_monitor
        new = mon.observe_sink(sink)
        self.last_numerics = {site: _numerics.stats_dict(vec)
                              for site, vec in sink.items()}
        first_bad = next((site for site, kind in new
                          if kind == "nonfinite"), None)
        if first_bad is not None and mon.bundle_path is None:
            loc = self.localize_numerics()
            if loc is not None:
                self.last_localization = loc
                _flight_recorder.annotate("numerics_localization", loc)
            mon.bundle(f"numerics:{first_bad}:nonfinite")

    def localize_numerics(self, sat_frac_max=0.25):
        """NaN bisection localizer: replay the last decode step's saved
        inputs eagerly through per-layer probes (`sink_scope(layers=
        (k,))`) and name the first unhealthy layer. Corruption propagates
        forward through the stack, so O(log layers) probes suffice. Each
        probe counts under `trace_counts["numerics_probe"]`. Returns the
        localization record, or None before any decode step."""
        saved = self._last_decode_inputs
        if saved is None:
            return None
        n_layers = self._model.cfg.num_layers
        probe_sinks = {}

        def probe_sink(k):
            if k not in probe_sinks:
                self._numerics_probe_layers = (k,)
                try:
                    probe_sinks[k] = self._probe_decode(saved)
                finally:
                    self._numerics_probe_layers = None
                self._numerics_probes += 1
            return probe_sinks[k]

        def unhealthy_at(k):
            vec = probe_sink(k).get(f"layer{k}.act")
            if vec is None:
                return False
            return _numerics.stats_unhealthy(vec, sat_frac_max)

        first = _numerics.bisect_first_unhealthy(n_layers, unhealthy_at)
        rec = {"first_unhealthy_layer": first,
               "site": None if first is None else f"layer{first}.act",
               "stats": None, "probes": len(probe_sinks),
               "layers": n_layers}
        if first is not None:
            rec["stats"] = _numerics.stats_dict(
                probe_sink(first)[f"layer{first}.act"])
        return rec

    def _probe_decode(self, saved):
        """One localizer probe over the saved decode inputs (dense cache):
        an eager decode forward under the armed scope, the rows it wrote
        put back. Returns {site: float32 [4]}."""
        tokens, pos = saved
        rows = torch.arange(pos.shape[0], device=self.device)
        at = pos.to(torch.int64).clamp(
            0, self._cache.layers[0].k.shape[1] - 1)
        kept = [(l.k[rows, at].clone(), l.v[rows, at].clone())
                for l in self._cache.layers]
        cache = kvc.DecodeCache(self._cache.layers, pos.clone())
        try:
            with self._numerics_scope() as sink:
                logits, _ = self._decode_forward(tokens[:, None], cache)
                self._tap_decode(logits[:, 0])
            return self._host_sink(sink)
        finally:
            for l, (k, v) in zip(self._cache.layers, kept):
                l.k[rows, at] = k
                l.v[rows, at] = v

    def _fire_numerics_chaos(self):
        """The `numerics.corrupt` site (caller-interpreted, like truncate):
        nan / inf set one element of the decode tensor named by the spec's
        target (of an int8 entry's scale), scale_zero zeroes an int8
        entry's scale. In place, in the decode storage the captured graph
        reads, so nothing is captured again."""
        spec = _faults.fire("numerics.corrupt")
        if spec is None or spec.mode not in ("nan", "inf", "scale_zero"):
            return
        self._apply_numerics_corruption(spec.target, spec.mode)

    @staticmethod
    def _corrupt_entry(entry, mode):
        """Damage one decode entry in place per the mode (the scale of an
        int8 entry); scale_zero leaves a float entry alone."""
        if isinstance(entry, dict):
            target = entry["scale"]
        elif mode == "scale_zero":
            return
        else:
            target = entry
        with torch.no_grad():
            if mode == "scale_zero":
                target.zero_()
            else:
                target[(0,) * target.dim()] = \
                    float("nan") if mode == "nan" else float("inf")

    def _apply_numerics_corruption(self, name, mode):
        """Where the damage lands: the decode entry named `name`."""
        entry = self._decode_params.get(name) if name else None
        if entry is not None:
            self._corrupt_entry(entry, mode)

    @staticmethod
    def _dequant_params(params):
        """Quantized entries ({"q", "scale"}) dequantize through the one
        canonical expression (`blocks.dequant_codes`); float entries pass
        through."""
        return {n: (blocks.dequant_codes(v["q"], v["scale"])
                    if isinstance(v, dict) else v)
                for n, v in params.items()}

    def swap_params(self, new_params):
        """Replace the serving weights between steps. `new_params` maps
        every serving name to a tensor or array of the same shape; values
        are cast to the serving dtype and moved to the engine's device.
        Staged and atomic: a missing key or a wrong shape raises and the
        old weights keep serving. The commit copies every value into the
        engine's own storage in place (the storage the captured graphs
        read, so a swap captures nothing), so a caller that later updates
        its tensors in place (a trainer stepping the model it swapped in)
        cannot change what serves, as the reference's immutable arrays
        cannot. The module is left untouched. Returns the number of
        swapped tensors. `serving.weight_swap` fires before anything is
        staged, so a fault leaves the old weights bit for bit."""
        _faults.fire("serving.weight_swap")
        current = self._params
        missing = sorted(set(current) - set(new_params))
        if missing:
            raise ValueError(f"swap params missing {len(missing)} keys "
                             f"(first: {missing[:3]})")
        staged = {}
        for name, old in current.items():
            arr = torch.as_tensor(new_params[name])
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(
                    f"swap param {name!r} shape {tuple(arr.shape)} != "
                    f"serving shape {tuple(old.shape)}: a hot-swap can "
                    f"only replace values, never architecture")
            staged[name] = arr.detach().to(device=old.device,
                                           dtype=old.dtype)
        with torch.no_grad():                  # the commit point
            for name, arr in staged.items():
                current[name].copy_(arr)
        self._refresh_decode_params()
        return len(staged)

    # -- public compute API ---------------------------------------------------
    def prefill(self, slot, prompt_ids, rng=None):
        """Write `prompt_ids` into `slot`'s cache rows; returns the first
        generated token. `rng=(seed, gen)` arms the slot's sampler; None
        draws a fresh deterministic seed at gen 0."""
        slot = int(slot)
        prompt = self._check_prompt(prompt_ids)
        seed, gen = rng if rng is not None \
            else (self._default_slot_seed(), 0)
        self.set_slot_rng(slot, seed, gen)
        bucket = self.bucket_for(prompt.size)
        # run the prompt through a fresh one-slot cache sized to the
        # bucket, then copy its rows into the slot
        local = self._model.gen_cache(1, bucket)
        with RecordEvent("serving::prefill", TracerEventType.UserDefined,
                         {"bucket": bucket, "length": int(prompt.size),
                          "slot": slot}), self._numerics_scope() as sink:
            logits, local = self._forward(self._padded(prompt, bucket),
                                          local)
            _numerics.tap("prefill.logits", logits[:, prompt.size - 1])
        for glob, loc in zip(self._cache.layers, local.layers):
            glob.k[slot, :bucket] = loc.k[0]
            glob.v[slot, :bucket] = loc.v[0]
        self._cache.pos[slot] = int(prompt.size)
        if sink is not None:
            self._ingest_numerics(self._host_sink(sink))
        first = int(self._select(logits[:, prompt.size - 1], slot)[0])
        self._slot_gen[slot] += 1
        self._last_tokens[slot] = first
        return first

    def decode(self):
        """Advance every slot one token; returns np.int32 [slots]."""
        _faults.fire("serving.decode_step")
        self._fire_numerics_chaos()
        tokens = torch.from_numpy(
            self._last_tokens.astype(np.int64)).to(self.device)
        if self._numerics_armed:             # the localizer's replay
            self._last_decode_inputs = (tokens, self._cache.pos.clone())
        with RecordEvent("serving::decode_step",
                         TracerEventType.UserDefined,
                         {"slots": self.config.slots}), \
                self._numerics_scope() as sink:
            logits, cache = self._decode_forward(tokens[:, None],
                                                 self._cache)
            self._tap_decode(logits[:, 0])
        # free slots keep decoding garbage harmlessly; clamp so their
        # position stays in bounds forever
        pos = torch.clamp(self._cache.pos + 1, max=self.config.max_len - 1)
        self._cache = kvc.DecodeCache(cache.layers, pos)
        if sink is not None:
            self._ingest_numerics(self._host_sink(sink))
        out = self._select_slots(logits[:, 0])
        self._slot_gen += 1
        self._last_tokens = out.copy()
        return out

    def set_slot_token(self, slot, token):
        """Feed `token` as slot's next decode input (after prefill, or to
        teacher-force a stream)."""
        self._last_tokens[int(slot)] = np.int32(token)

    def reset_slot(self, slot):
        """Mark a slot free: pos=0 hides its stale rows; its adapter id
        goes back to base."""
        self._cache.pos[int(slot)] = 0
        self._last_tokens[int(slot)] = 0
        self.set_slot_rng(slot, 0, 0)
        self._slot_adapter[int(slot)] = 0

    def slot_positions(self):
        return self._cache.pos.cpu().numpy().astype(np.int32)

    @property
    def slots(self):
        return self.config.slots

    # -- the executables and their libraries -------------------------------
    def executable_names(self):
        """The serving executables, the JAX engine's list for the same
        config: what `save_for_generation` records and `precompile()`
        prepares (`_executable_set` of this engine's kind and config)."""
        return _executable_set(_engine_kind(self.config), self.config)

    def _executable_libraries(self, name):
        """The kernel libraries executable `name` launches (none: the dense
        engine runs plain PyTorch)."""
        return []

    def _ensure_libraries(self):
        """Resolve every kernel library this engine's executables launch
        through its compile cache (`_kernels.build.load`); returns {library:
        "miss" | "hit"} as this process got each."""
        if self._libraries is None:
            from .._kernels import build
            libs = sorted({lib for n in self.executable_names()
                           for lib in self._executable_libraries(n)})
            build.load_many(libs, cache=self._compile_cache)
            self._libraries = {lib: build.outcome(lib) for lib in libs}
        return self._libraries

    def _under_cache(self):
        """Whether a compile cache of the engine's own or the attached
        global one resolves its libraries."""
        from ..framework import compile_cache
        return self._compile_cache is not None or \
            compile_cache.active() is not None

    def precompile(self):
        """The dense engine runs eagerly: nothing to build or capture.
        Returns {executable: "eager"}."""
        self.last_precompile_stats = {"libraries_s": 0.0, "captures_s": 0.0,
                                      "libraries": {}}
        return dict.fromkeys(self.executable_names(), "eager")

    @property
    def capture_counts(self):
        """{executable: times captured as a CUDA graph}; the dense engine
        runs eagerly and captures none."""
        return {}

    @property
    def trace_counts(self):
        """The serving worker's STAT field: where the JAX engines report
        traces per executable, the port reports its captures (and the
        localizer's probes under `numerics_probe`)."""
        out = dict(self.capture_counts)
        if self._numerics_probes:
            out["numerics_probe"] = self._numerics_probes
        return out

    @property
    def max_prompt_len(self):
        """Longest prompt prefill can serve and still decode one token."""
        return min(self.config.prefill_buckets[-1], self.config.max_len - 1)

    # -- resident bytes -----------------------------------------------------
    def _weight_tensors(self):
        """The resident weight tensors: the float set (prefill serves it)
        and the decode set (int8 codes and scales with weight_dtype="int8",
        storage of its own when the taps are armed)."""
        out = []
        for src in (self._params, self._decode_params):
            for v in src.values():
                out.extend((v["q"], v["scale"]) if isinstance(v, dict)
                           else (v,))
        return out

    def _kv_tensors(self):
        """The resident KV tensors (the dense cache here)."""
        return [x for layer in self._cache.layers for x in (layer.k, layer.v)]

    def _resident_groups(self):
        """[(shard, device, weight tensors, KV tensors)] of the serving
        state: one shard, "engine", on the engine's device here; the
        sharded engines list each of theirs."""
        return [("engine", self.device, self._weight_tensors(),
                 self._kv_tensors())]

    def hbm_accounting(self):
        """Measured bytes of the resident serving state, from the tensors
        the engine holds (a storage two names share counts once, where it
        is first met): {"per_shard": {shard: {"device", "weights", "kv",
        "total"}}, "per_device": {device: {"weights", "kv", "total"}},
        "max_shard_total", "max_device_total", "weights_total",
        "kv_total"}. Every shard names its device, so shards that share a
        card add up on it in `per_device`. With weight_dtype="int8" the
        float set stays resident for prefill beside the int8 decode set:
        about 1.25x the float bytes, not a quarter of them. The model's
        own parameters are not counted: they are the caller's."""
        seen = set()
        per_shard, per_dev = {}, {}
        for name, dev, weights, kv in self._resident_groups():
            rec = {"device": str(dev), "weights": 0, "kv": 0}
            for kind, tensors in (("weights", weights), ("kv", kv)):
                for t in tensors:
                    key = (str(t.device), t.data_ptr(), t.numel())
                    if key not in seen:
                        seen.add(key)
                        rec[kind] += t.numel() * t.element_size()
            rec["total"] = rec["weights"] + rec["kv"]
            per_shard[name] = rec
            d = per_dev.setdefault(str(dev), {"weights": 0, "kv": 0,
                                              "total": 0})
            for k in ("weights", "kv", "total"):
                d[k] += rec[k]
        return {"per_shard": per_shard, "per_device": per_dev,
                "max_shard_total": max(r["total"]
                                       for r in per_shard.values()),
                "max_device_total": max(d["total"]
                                        for d in per_dev.values()),
                "weights_total": sum(r["weights"]
                                     for r in per_shard.values()),
                "kv_total": sum(r["kv"] for r in per_shard.values())}

    @property
    def decode_write_tokens(self):
        """KV positions one decode step writes per slot."""
        return 1


class PagedEngineConfig(EngineConfig):
    """EngineConfig plus the paged-pool knobs.

    block_size: tokens per KV block. num_blocks: pool size including the
    garbage block; defaults to full provisioning (every slot could hold
    max_len) plus it. attention_impl: "kernel" (the default: the CUDA
    kernel walks the block table; CPU tensors take its plain version) or
    "gather" (the plain dense-view path, the reference it is held to).
    kv_dtype: "float32" pools, or "int8" codes with per-block per-head
    scales. weight_dtype: "int8" runs the decode forwards from int8
    weights with per-output-channel scales (prefill stays float).
    capture_logits: decode keeps the [slots, vocab] f32 last-token logits
    in `engine.last_logits`. enable_kv_tiers: evicted prefix blocks demote
    to a host tier of `host_tier_blocks` blocks (`host_tier_dtype`
    "float32", or "int8" requantized), cascading to a disk tier of
    `disk_tier_blocks` in `disk_tier_dir` (None: no disk tier) compacted
    past `disk_tier_compact_threshold` dead bytes; off by default."""

    def __init__(self, block_size=16, num_blocks=None,
                 enable_prefix_cache=True, attention_impl="kernel",
                 kv_dtype="float32", weight_dtype="float32",
                 capture_logits=False, enable_kv_tiers=False,
                 host_tier_blocks=64, host_tier_dtype="float32",
                 disk_tier_dir=None, disk_tier_blocks=256,
                 disk_tier_compact_threshold=0.5, **kwargs):
        super().__init__(**kwargs)
        self.block_size = int(block_size)
        self.max_blocks_per_slot = -(-self.max_len // self.block_size)
        self.num_blocks = int(num_blocks) if num_blocks is not None else \
            1 + self.slots * self.max_blocks_per_slot
        if self.num_blocks < 2:
            raise ValueError("num_blocks must leave at least one "
                             "allocatable block beyond the garbage block")
        self.enable_prefix_cache = bool(enable_prefix_cache)
        if attention_impl not in ("gather", "kernel"):
            raise ValueError(f"attention_impl must be 'gather' or "
                             f"'kernel', got {attention_impl!r}")
        self.attention_impl = attention_impl
        for knob, val in (("kv_dtype", kv_dtype),
                          ("weight_dtype", weight_dtype)):
            if val not in ("float32", "int8"):
                raise ValueError(f"{knob} must be 'float32' or 'int8', "
                                 f"got {val!r}")
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.capture_logits = bool(capture_logits)
        self.enable_kv_tiers = bool(enable_kv_tiers)
        self.host_tier_blocks = int(host_tier_blocks)
        if host_tier_dtype not in ("float32", "int8"):
            raise ValueError(f"host_tier_dtype must be 'float32' or "
                             f"'int8', got {host_tier_dtype!r}")
        self.host_tier_dtype = host_tier_dtype
        self.disk_tier_dir = disk_tier_dir
        self.disk_tier_blocks = int(disk_tier_blocks)
        self.disk_tier_compact_threshold = float(disk_tier_compact_threshold)

    _DICT_FIELDS = EngineConfig._DICT_FIELDS + (
        "block_size", "num_blocks", "enable_prefix_cache", "attention_impl",
        "kv_dtype", "weight_dtype", "capture_logits", "enable_kv_tiers",
        "host_tier_blocks", "host_tier_dtype", "disk_tier_dir",
        "disk_tier_blocks", "disk_tier_compact_threshold")


class PagedGenerationEngine(GenerationEngine):
    """GenerationEngine over the paged block pool (`blocks.py`): block
    tables and positions live on the host, the pools on the device. Adds
    `block_pool` (refcounted allocator), `prefix_cache` (shared prompt
    blocks) and `ensure_slot_capacity` for the scheduler's preemption
    loop. Prefill runs only the suffix after a prefix-cache hit.

    The host state the executables read (each slot's next input token,
    position and block table) lives in the host views of one
    `graphs.StaticInputs`, uploaded in one copy before every call; the
    pools, the weights and those inputs are never reallocated."""

    _config_cls = PagedEngineConfig

    @property
    def kv_quantized(self):
        return self.config.kv_dtype == "int8"

    def _alloc_pools(self, num_layers=None, num_heads=None, device=None):
        """Zeroed K/V pools (int8 codes and scales with kv_dtype="int8"):
        the whole model's by default, or `num_layers` layers of
        `num_heads` heads on `device` (a shard's)."""
        cfg = self._model.cfg
        c = self.config
        head_dim = cfg.hidden_size // cfg.num_heads
        num_layers = cfg.num_layers if num_layers is None else num_layers
        num_heads = cfg.num_heads if num_heads is None else num_heads
        device = self.device if device is None else device
        if self.kv_quantized:
            return blocks.alloc_quant_pools(
                num_layers, c.num_blocks, c.block_size, num_heads, head_dim,
                device)
        return blocks.alloc_pools(
            num_layers, c.num_blocks, c.block_size, num_heads, head_dim,
            self._model.wte.weight.dtype, device)

    def _whole_pool(self):
        """The whole model's pool, one layer cache a layer: what the
        forwards, the handoff and the tiers index (here the pools
        themselves)."""
        return self._alloc_pools()

    def _alloc_state(self):
        cfg = self._model.cfg
        c = self.config
        head_dim = cfg.hidden_size // cfg.num_heads
        self._pool = self._whole_pool()
        self._io = graphs.StaticInputs(self._decode_fields(), self.device)
        self._last_tokens = self._io.host["tokens"]
        self._pos = self._io.host["pos"]
        self._tables = self._io.host["tables"]
        self._slot_adapter = self._io.host["adapter"]
        self._pf = graphs.StaticInputs(self._prefill_fields(), self.device)
        self._exe = graphs.Executables(self.device)
        self._slot_active = np.zeros((c.slots,), bool)
        self.kv_tiers = None
        self._tier_restores = None      # None: tiers off
        self._tier_staging = {}         # dtype -> page-locked buffer
        # each slot's prefix namespace, kept from its prefill so that its
        # decode-time block growth evicts under the same requester
        self._slot_namespace = {}
        self.block_pool = blocks.BlockPool(c.num_blocks, c.block_size)
        self.prefix_cache = PrefixCache(self.block_pool, c.block_size) \
            if c.enable_prefix_cache else None
        # the KV ledger, when enabled as the engine is built: every pool
        # and cache transition is mirrored into it (host bookkeeping only)
        self.kv_ledger = None
        if _kvl.enabled():
            self.kv_ledger = _kvl.KVLedger(
                c.num_blocks, block_bytes=self._kv_block_bytes())
            self.block_pool.attach_ledger(self.kv_ledger)
            if self.prefix_cache is not None:
                self.prefix_cache.attach_ledger(self.kv_ledger)
        if c.enable_kv_tiers and self.prefix_cache is not None:
            self.kv_tiers = TieredBlockStore(
                self._tier_read_block, self._tier_write_blocks,
                host_blocks=c.host_tier_blocks,
                host_dtype=c.host_tier_dtype, disk_dir=c.disk_tier_dir,
                disk_blocks=c.disk_tier_blocks,
                disk_compact_threshold=c.disk_tier_compact_threshold)
            if self.kv_ledger is not None:
                self.kv_tiers.attach_ledger(self.kv_ledger)
            self.prefix_cache.attach_tier(self.kv_tiers)
            self._tier_restores = 0
            # staging for the longest run a prefill can promote, made now
            # so that no restore pays for page-locking host memory
            kv = (2 * cfg.num_layers, c.max_blocks_per_slot)
            self._tier_stage(kv + (c.block_size, cfg.num_heads, head_dim),
                             torch.int8 if self.kv_quantized
                             else torch.float32)
            if self.kv_quantized:
                self._tier_stage(kv + (cfg.num_heads,), torch.float32)
        self.last_prefill_stats = {}
        self.last_logits = None

    def _kv_tensors(self):
        return [x for layer in self._pool for x in layer]

    def _kv_block_bytes(self):
        """Device bytes one pool block pins across every layer and both
        K/V sides, priced from the pool dtype (an int8 block carries a
        4-byte scale per head beside its codes): the ledger's per-tenant
        block counts times this are `serving_kv_bytes{tenant,kind}`."""
        cfg = self._model.cfg
        c = self.config
        heads = cfg.num_heads
        head_dim = cfg.hidden_size // heads
        if self.kv_quantized:
            per_side = c.block_size * heads * head_dim + 4 * heads
        else:
            itemsize = self._model.wte.weight.element_size()
            per_side = c.block_size * heads * head_dim * itemsize
        return 2 * per_side * cfg.num_layers

    def _decode_fields(self):
        """Inputs of the decode-step executables: each slot's next input
        token, position, block table and adapter id (read only with a
        bank attached)."""
        c = self.config
        return {"tokens": (c.slots,), "pos": (c.slots,),
                "tables": (c.slots, c.max_blocks_per_slot),
                "adapter": (c.slots,)}

    def _prefill_fields(self):
        """Inputs of `prefill[b]`: the bucket-padded suffix (bucket b reads
        its first b ids), the slot's table row, the suffix's start
        position and its real length."""
        c = self.config
        return {"ids": (1, max(c.prefill_buckets)),
                "row": (1, c.max_blocks_per_slot), "pos": (1,),
                "valid": (1,)}

    # -- int8 decode weights --------------------------------------------------
    @staticmethod
    def _is_matmul_weight(name, arr):
        """Whether a param quantizes for decode: every 2-D `.weight` but
        `wpe` (a position lookup, one row per slot)."""
        return arr.dim() == 2 and name.endswith(".weight") \
            and "wpe" not in name

    def _build_decode_params(self):
        """weight_dtype="int8": every decode-matmul weight becomes
        {"q": int8 codes, "scale": broadcast-ready f32 scales}; the float
        `_params` keep serving prefill. Armed, the float entries get
        storage of their own too (`_own_decode_storage`)."""
        params = self._params if self.config.weight_dtype != "int8" \
            else self._quantize_params(self._params)
        self._decode_params = self._own_decode_storage(params)

    def _quantize_params(self, params):
        """int8-quantize every decode-matmul weight of a param dict;
        other params pass through."""
        out = {}
        for name, arr in params.items():
            if self._is_matmul_weight(name, arr):
                codes, s_b = _quantize_weight(arr.detach())
                out[name] = {"q": codes, "scale": s_b}
            else:
                out[name] = arr
        return out

    # -- KV tier device I/O -----------------------------------------------------
    def _tier_stage(self, shape, dtype):
        """A page-locked staging view of `shape` for the tiers' copies,
        carved from one buffer per dtype that the engine keeps (sized at
        construction for a whole slot's blocks, grown if ever needed): a
        demotion or a restore allocates no page-locked memory. The copies
        through it are synchronous, so it is free again when they
        return."""
        n = int(np.prod(shape))
        buf = self._tier_staging.get(dtype)
        if buf is None or buf.numel() < n:
            buf = self._host_buffer((n,), dtype)
            self._tier_staging[dtype] = buf
        return buf[:n].view(shape)

    def _tier_read_block(self, blk):
        """The tier store's read callback: block `blk`'s whole-model KV as
        pool-native host arrays, {"k0", "v0", ...} [bs, h, d] (float pools
        as float32; int8 pools as their codes plus "ks0", "vs0", ... the
        per-head scale rows [h]), copied in one synchronous copy per kind
        through the page-locked staging buffer into host memory of the
        tier's own."""
        blk = int(blk)
        nl = len(self._pool)
        kinds = [("", [x[blk] for layer in self._pool
                       for x in (layer.k, layer.v)])]
        if self.kv_quantized:
            kinds.append(("s", [x[blk] for layer in self._pool
                                for x in (layer.k_scale, layer.v_scale)]))
        arrays = {}
        for suffix, slabs in kinds:
            slabs = torch.stack(slabs)
            if not self.kv_quantized:
                slabs = slabs.float()
            stage = self._tier_stage(slabs.shape, slabs.dtype)
            stage.copy_(slabs)
            host = stage.numpy().copy()
            arrays.update((f"{side}{suffix}{li}", host[2 * li + j])
                          for li in range(nl)
                          for j, side in enumerate(("k", "v")))
        return {"arrays": arrays, "quant": self.kv_quantized}

    def _tier_write_blocks(self, blks, arrays_list):
        """The tier store's batched writer: a promoted run's records
        (`_tier_read_block`'s layout, one per block of `blks`) gathered in
        the page-locked staging buffer, uploaded in one copy per kind and
        written in place into every pool with `index_copy_` over the run's
        block ids: no padding, no new pool, no capture."""
        n, nl = len(blks), len(self._pool)
        idx = torch.tensor([int(b) for b in blks], dtype=torch.int64,
                           device=self.device)
        kinds = [("", torch.int8 if self.kv_quantized else torch.float32)]
        if self.kv_quantized:
            kinds.append(("s", torch.float32))
        with torch.no_grad():
            for suffix, dtype in kinds:
                shape = arrays_list[0][f"k{suffix}0"].shape
                stage = self._tier_stage((2 * nl, n) + tuple(shape), dtype)
                host = stage.numpy()
                for li in range(nl):
                    for j, side in enumerate(("k", "v")):
                        name = f"{side}{suffix}{li}"
                        for r, arrays in enumerate(arrays_list):
                            host[2 * li + j, r] = arrays[name]
                dev = stage.to(self.device)
                for li, layer in enumerate(self._pool):
                    pools = (layer.k_scale, layer.v_scale) if suffix \
                        else (layer.k, layer.v)
                    for j, pool in enumerate(pools):
                        pool.index_copy_(0, idx,
                                         dev[2 * li + j].to(pool.dtype))
        self._tier_restores = 1

    @property
    def trace_counts(self):
        """The capture counts, plus `tier_restore` with the tiers on (0
        until the first restore, then 1) and `numerics_probe` once the
        localizer has probed (its eager probe forwards)."""
        out = dict(self.capture_counts)
        if self._tier_restores is not None:
            out["tier_restore"] = self._tier_restores
        if self._numerics_probes:
            out["numerics_probe"] = self._numerics_probes
        return out

    # -- block accounting -----------------------------------------------------
    def _alloc_blocks(self, n, requester=None):
        """Pool alloc with prefix-cache eviction as the pressure valve
        (`requester`: the allocating request's prefix namespace, whose own
        entries evict first); BlockAllocError escapes only when eviction
        cannot cover it."""
        try:
            return self.block_pool.alloc(n)
        except blocks.BlockAllocError:
            if self.prefix_cache is not None:
                short = n - self.block_pool.available
                if self.prefix_cache.evict(short,
                                           requester=requester) >= short:
                    return self.block_pool.alloc(n)
            raise

    def ensure_slot_capacity(self, slot, tokens=None):
        """Make sure `slot` owns the blocks its next decode write lands in
        (all or nothing); raises BlockAllocError under pressure. Positions
        past max_len need no block (they land in the garbage block)."""
        slot = int(slot)
        if not self._slot_active[slot]:
            return
        if tokens is None:
            tokens = self.decode_write_tokens
        bs = self.config.block_size
        first = int(self._pos[slot]) // bs
        last = min((int(self._pos[slot]) + int(tokens) - 1) // bs,
                   self.config.max_blocks_per_slot - 1)
        need = [lb for lb in range(first, last + 1)
                if self._tables[slot, lb] == blocks.GARBAGE_BLOCK]
        if need:
            requester = self._slot_namespace.get(slot)
            for lb, b in zip(need, self._alloc_blocks(len(need),
                                                      requester=requester)):
                self._tables[slot, lb] = b

    def ensure_decode_capacity(self):
        for s in range(self.config.slots):
            self.ensure_slot_capacity(s)

    # -- the executables ------------------------------------------------------
    def _executable_libraries(self, name):
        """The paged kernels' libraries (every build: the tile table picks
        one at capture), for every executable on the kernel path on the
        card (the gather path and the CPU launch none)."""
        if self.device.type == "cuda" and \
                self.config.attention_impl == "kernel":
            return list(_pa.LIBRARIES)
        return []

    @property
    def capture_counts(self):
        """{executable: times captured as a CUDA graph} (at most 1 each)."""
        return self._exe.capture_counts

    def _safe_inputs(self):
        """Values of the decode inputs whose writes land in scratch, beyond
        the zeros `StaticInputs.upload` puts everywhere else (None: zeros
        are safe: every table entry is the garbage block)."""
        return None

    def _executable(self, name):
        """(function, inputs, safe state) of executable `name`."""
        if name == "decode":
            return self._decode_fn, self._io, self._safe_inputs()
        if name.startswith("prefill["):
            bucket = int(name[len("prefill["):-1])
            return functools.partial(self._prefill_fn, bucket), self._pf, None
        raise KeyError(f"unknown executable {name!r}")

    def precompile(self):
        """Capture every serving executable as a CUDA graph without serving
        a request: the kernel libraries are resolved through the compile
        cache, each graph is warmed up and captured over the safe state,
        and no RNG is drawn and no engine state moves, so token streams are
        identical with or without it.

        Returns, for each executable, under a compile cache (the engine's
        own or the attached global one) the outcome of the libraries it
        launches: "miss" in the process that built them (any of them),
        "hit" in a later process that loaded them all from committed
        entries; otherwise, or for an executable that launches none,
        "captured". On the CPU, where the executables run eagerly,
        "eager". The graphs are this process's: `capture_counts` reads 1
        each after a warm start as after a cold one.
        `last_precompile_stats` holds the seconds of the library stage
        and of the captures, and the libraries' outcomes."""
        names = self.executable_names()
        if self.device.type != "cuda":
            self.last_precompile_stats = {"libraries_s": 0.0,
                                          "captures_s": 0.0, "libraries": {}}
            return dict.fromkeys(names, "eager")
        gc.collect()                  # free dead graphs' memory first
        t0 = time.perf_counter()
        libs = self._ensure_libraries()
        if libs:
            _pa.bind_library()
        t1 = time.perf_counter()
        for name in names:
            self._capture(name)
        torch.cuda.synchronize(self.device)
        self.last_precompile_stats = {
            "libraries_s": t1 - t0, "captures_s": time.perf_counter() - t1,
            "libraries": dict(libs)}
        cached = self._under_cache()
        out = {}
        for name in names:
            got = [libs[lib] for lib in self._executable_libraries(name)]
            out[name] = ("miss" if "miss" in got else "hit") \
                if cached and got else "captured"
        return out

    def _adapter_ids(self):
        """The decode inputs' adapter field, uploaded before every call."""
        return self._io.dev["adapter"]

    def _adapter_executables(self):
        """The executables whose forwards add the adapter delta."""
        return ["decode"]

    def _adapters_changed(self):
        """New adapter tensors: a captured adapter executable is dropped
        and captured again at its next call (counted), as the JAX engine
        retraces an executable it had traced."""
        for name in self._adapter_executables():
            self._exe.invalidate(name)

    def _executable_device(self, name):
        """The device executable `name` runs on: the engine's (a pipeline
        stage's executables run on the stage's)."""
        return self.device

    def _capture(self, name):
        """Capture executable `name` as a CUDA graph unless it was (a
        no-op on the CPU, where executables run eagerly)."""
        device = self._executable_device(name)
        if device.type == "cuda":
            self._exe.capture(name, *self._executable(name), device=device)

    def _run(self, name, upload=True):
        """Run executable `name` (a replay on the card) and count its
        paged-kernel launches."""
        if self._libraries is None:
            self._ensure_libraries()
        out, launches = self._exe.run(
            name, *self._executable(name), upload=upload,
            device=self._executable_device(name))
        self.kernel_launches += launches
        return out

    def _paged_forward(self, ids, tables, pos, valid=None, decode=False,
                       adapter_ids=None):
        """One forward through the block tables under `attention_impl`;
        decode (and verify) forwards run on `_decode_params`."""
        cache = blocks.PagedDecodeCache(self._pool, tables, pos, valid)
        with blocks.attention_impl(self.config.attention_impl):
            if decode:
                logits, _ = self._decode_forward(ids, cache, adapter_ids)
            else:
                logits, _ = self._forward(ids, cache)
        return logits

    def _decode_fn(self, io=None):
        """The `decode` executable: one token for every slot, over the
        decode inputs `io` (default: the static ones). Returns (last-token
        logits [slots, V], greedy argmax [slots] int32 or None, the packed
        sink or None: `_stack_sink`, the picks first)."""
        io = self._io.dev if io is None else io
        with self._numerics_scope() as sink:
            if sink is not None:
                self._tap_decode_inputs()
            logits = self._paged_forward(io["tokens"][:, None],
                                         io["tables"], io["pos"],
                                         decode=True,
                                         adapter_ids=io["adapter"])[:, 0]
            picks = torch.argmax(logits, dim=-1).to(torch.int32) \
                if self.config.decode_strategy == "greedy" else None
            self._tap_decode(logits)
        return logits, picks, self._stack_sink(sink, picks)

    def _tap_decode_inputs(self):
        """The decode taps before the forward: the whole int8 pool's
        scales and codes (codes at +-127 mean a clipped scale) and the
        int8 decode weights' scales and codes."""
        if self.kv_quantized:
            _numerics.tap_tree("kv.scale", [x for l in self._pool
                                            for x in (l.k_scale, l.v_scale)])
            _numerics.tap_tree("kv.codes", [x for l in self._pool
                                            for x in (l.k, l.v)],
                               sat_threshold=127)
        quant = [v for v in self._decode_params.values()
                 if isinstance(v, dict)]
        if quant:
            _numerics.tap_tree("weights.scale", [w["scale"] for w in quant])
            _numerics.tap_tree("weights.q", [w["q"] for w in quant],
                               sat_threshold=127)

    def _prefill_fn(self, bucket):
        """The `prefill[bucket]` executable: the padded suffix through the
        slot's table row; returns its logits [1, bucket, V] (armed: and
        the packed sink, whose `prefill.logits` are the last real
        token's)."""
        pf = self._pf.dev
        with self._numerics_scope() as sink:
            logits = self._paged_forward(pf["ids"][:, :bucket], pf["row"],
                                         pf["pos"], valid=pf["valid"])
            if sink is not None:
                # the safe state's length is 0: its row 0 is read
                last = logits[0].index_select(
                    0, (pf["valid"] - 1).clamp(min=0).to(torch.int64))
                _numerics.tap("prefill.logits", last)
        if sink is None:
            return logits
        return logits, self._stack_sink(sink)

    def _probe_decode(self, saved):
        """One localizer probe: the saved decode inputs through the decode
        function eagerly (outside any graph) under the armed scope. The
        forward writes its token's K/V into the pool in place, so the
        blocks the live step wrote (each slot's block at its position)
        are copied first and put back after: the pool stays as the live
        step left it."""
        io = {n: torch.from_numpy(a).to(self.device)
              for n, a in saved.items()}
        nb = self.config.max_blocks_per_slot
        lb = saved["pos"].astype(np.int64) // self.config.block_size
        rows = np.arange(lb.shape[0])
        touched = np.where(lb < nb, saved["tables"][rows,
                                                    np.minimum(lb, nb - 1)],
                           blocks.GARBAGE_BLOCK)
        idx = torch.from_numpy(np.unique(touched).astype(np.int64)).to(
            self.device)
        kept = [(t, t[idx].clone()) for layer in self._pool for t in layer]
        try:
            _, picks, packed = self._decode_fn(io)
            return self._unstack_sink(
                packed, 0 if picks is None else picks.shape[0])[1]
        finally:
            with torch.no_grad():
                for t, rows_kept in kept:
                    t.index_copy_(0, idx, rows_kept)

    # -- public compute API ---------------------------------------------------
    def prefill(self, slot, prompt_ids, rng=None, namespace=None):
        """Place `prompt_ids` into `slot`: match the prefix cache, allocate
        private blocks for the rest, run the suffix through its bucket
        (writes land in this slot's blocks) and return the first token.
        `namespace` salts the prefix-cache keys (chains of two namespaces
        never share a block). `last_prefill_stats` records the prefix
        hit."""
        slot = int(slot)
        prompt = self._check_prompt(prompt_ids)
        if self._slot_active[slot]:
            self.reset_slot(slot)
        plen = int(prompt.size)
        bs = self.config.block_size
        toks = [int(t) for t in prompt]
        need = blocks.blocks_for_tokens(plen, bs)
        # record=False: the hit counts only once this placement sticks;
        # reserve=need: a tier promotion never eats the suffix's blocks
        shared, nshared = ([], 0) if self.prefix_cache is None \
            else self.prefix_cache.match(toks, record=False,
                                         namespace=namespace, reserve=need)
        n_priv = need - nshared // bs
        try:
            priv = self._alloc_blocks(n_priv, requester=namespace) \
                if n_priv else []
        except Exception:
            # give back the matched refs, under pressure and after any
            # other allocation failure (the `serving.block_alloc` site)
            for b in shared:
                self.block_pool.unref(b)
            raise
        row = np.zeros((self.config.max_blocks_per_slot,), np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + n_priv] = priv
        self._tables[slot] = row
        self._slot_active[slot] = True
        self._slot_namespace[slot] = namespace
        seed, gen = rng if rng is not None \
            else (self._default_slot_seed(), 0)
        self.set_slot_rng(slot, seed, gen)

        suffix = prompt[nshared:]
        bucket = self.bucket_for(suffix.size)
        with RecordEvent("serving::prefill", TracerEventType.UserDefined,
                         {"bucket": bucket, "length": plen, "slot": slot,
                          "prefix_hit_tokens": nshared, "paged": True,
                          "kv_dtype": self.config.kv_dtype,
                          "attend": self.config.attention_impl}):
            last = self._prefill_execute(row, suffix, nshared, bucket)
        self._pos[slot] = nshared + suffix.size
        first = int(self._select(last, slot)[0])
        self._slot_gen[slot] += 1
        if self.prefix_cache is not None:
            # the prompt's fully written blocks become shareable
            self.prefix_cache.insert(toks, row, (plen // bs) * bs,
                                     namespace=namespace)
            self.prefix_cache.record_lookup(nshared > 0)
        tier = self.prefix_cache.last_tier_stats \
            if self.prefix_cache is not None \
            else {"promoted_blocks": 0, "restore_s": 0.0}
        self.last_prefill_stats = {
            "prefix_hit_tokens": nshared, "blocks_allocated": n_priv,
            "suffix_bucket": bucket,
            "tier_promoted_blocks": tier["promoted_blocks"],
            "tier_restore_s": tier["restore_s"]}
        self._last_tokens[slot] = first
        return first

    def _prefill_execute(self, row, suffix, start, bucket):
        """Run the suffix (positions start..) through the slot's table
        `row` in bucket `bucket`, writing its K/V; returns the last real
        token's logits [1, V] (armed: after ingesting the sink)."""
        pf = self._pf.host
        pf["ids"][0, :bucket] = 0
        pf["ids"][0, :suffix.size] = suffix
        pf["row"][0] = row
        pf["pos"][0] = start
        pf["valid"][0] = suffix.size
        logits = self._run(f"prefill[{bucket}]")
        if self._numerics_armed:
            logits, packed = logits
            self._ingest_numerics(self._unstack_sink(packed)[1])
        return logits[:, suffix.size - 1]

    def decode(self):
        """Advance every slot one token; returns np.int32 [slots]. Active
        slots get their next block first (BlockAllocError under pressure;
        the scheduler grows slots itself so it can preempt instead)."""
        _faults.fire("serving.decode_step")
        self._fire_kv_quant_chaos()
        self._fire_numerics_chaos()
        self.ensure_decode_capacity()
        if self._numerics_armed:             # the localizer's replay
            self._last_decode_inputs = {n: a.copy()
                                        for n, a in self._io.host.items()}
        with RecordEvent("serving::decode_step",
                         TracerEventType.UserDefined,
                         {"slots": self.config.slots, "paged": True,
                          "kv_dtype": self.config.kv_dtype,
                          "attend": self.config.attention_impl}):
            logits, picks, packed = self._run("decode")
        stats = None
        if packed is not None:
            # one host read: the greedy picks and the step's stats
            head, stats = self._unstack_sink(
                packed, 0 if picks is None else picks.shape[0])
            picks = picks if head is None else head
        self._pos[:] = np.minimum(self._pos + 1, self.config.max_len - 1)
        if self.config.capture_logits:
            self.last_logits = logits.float().cpu().numpy()
        out = self._select_slots(logits, picks)
        if stats is not None:
            self._ingest_numerics(stats)
        self._slot_gen += 1
        self._last_tokens[:] = out
        return out

    def _fire_kv_quant_chaos(self):
        """The `serving.kv_quant` chaos site (truncate mode: the caller
        does the damage): on int8 pools, multiply one in-use block's K
        and V scale rows of layer 0 by 64. The multiply is in place, on
        the scale tensors the captured decode graph reads, so the next
        replay dequantizes that block's codes against the wrong scale:
        the silent corruption the int8 quality gate exists to catch."""
        if not self.kv_quantized:
            return
        spec = _faults.fire("serving.kv_quant")
        if spec is None or spec.mode != "truncate":
            return
        victim = next((int(b) for b in range(1, self.block_pool.num_blocks)
                       if self.block_pool.refcount(b) > 0), None)
        if victim is None:
            return
        layer = self._pool[0]
        with torch.no_grad():
            layer.k_scale[victim] *= 64.0
            layer.v_scale[victim] *= 64.0

    def reset_slot(self, slot):
        """Free the slot: its table drops every reference (blocks return
        to the pool unless the prefix cache holds them), pos=0, its
        adapter id back to base."""
        slot = int(slot)
        for b in self._tables[slot]:
            if b != blocks.GARBAGE_BLOCK:
                self.block_pool.unref(int(b))
        self._tables[slot] = blocks.GARBAGE_BLOCK
        self._slot_active[slot] = False
        self._pos[slot] = 0
        self._last_tokens[slot] = 0
        self.set_slot_rng(slot, 0, 0)
        self._slot_adapter[slot] = 0
        self._slot_namespace.pop(slot, None)

    def slot_positions(self):
        return self._pos.copy()

    # -- KV handoff -----------------------------------------------------------
    def _head_shape(self):
        cfg = self._model.cfg
        return cfg.num_heads, cfg.hidden_size // cfg.num_heads

    def _extract_row(self, slot):
        """Validate `slot` for extraction; returns (its first nb table
        entries as a device index, resident tokens, nb)."""
        slot = int(slot)
        if not self._slot_active[slot]:
            raise ValueError(f"slot {slot} holds no request to extract")
        plen = int(self._pos[slot])
        if plen < 1:
            raise ValueError(f"slot {slot} has no resident tokens")
        nb = blocks.blocks_for_tokens(plen, self.config.block_size)
        row = torch.from_numpy(self._tables[slot, :nb].astype(np.int64))
        return row.to(self.device), plen, nb

    def _host_buffer(self, shape, dtype):
        """A host tensor for one device copy: page-locked when the engine
        runs on the card (PyTorch's caching host allocator hands it out,
        and the copies into and out of it are synchronous)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _to_host(self, arrays, tokens):
        """Per-layer [nb, bs, h, d] device blocks -> contiguous host
        [tokens, h, d] arrays (block padding stripped), in one copy."""
        stacked = torch.stack(arrays)
        host = self._host_buffer(stacked.shape, stacked.dtype)
        host.copy_(stacked)
        host = host.numpy()
        host = host.reshape(host.shape[0], -1, *host.shape[3:])[:, :tokens]
        return list(host)

    def extract_kv(self, slot):
        """The handoff source: the `pos[slot]` resident tokens of `slot`,
        per layer, as host [plen, heads, head_dim] arrays (int8 pools
        dequantized). Returns (ks, vs, plen)."""
        row, plen, _ = self._extract_row(slot)
        ks, vs = [], []
        for layer in self._pool:
            if self.kv_quantized:
                ks.append(blocks.dequant(layer.k[row], layer.k_scale[row]))
                vs.append(blocks.dequant(layer.v[row], layer.v_scale[row]))
            else:
                ks.append(layer.k[row])
                vs.append(layer.v[row])
        host = self._to_host(ks + vs, plen)
        return host[:len(ks)], host[len(ks):], plen

    def extract_kv_wire(self, slot):
        """What `kv_handoff.pack_kv_bundle` needs. Float pools return
        {"ks", "vs", "plen"}; int8 pools ship their codes and add the
        per-block per-head scales ("k_scales"/"v_scales", [nblocks, heads]
        f32 per layer) and "scale_block" (this pool's block size)."""
        if not self.kv_quantized:
            ks, vs, plen = self.extract_kv(slot)
            return {"ks": ks, "vs": vs, "plen": plen}
        row, plen, nb = self._extract_row(slot)
        codes = [layer.k[row] for layer in self._pool] + \
            [layer.v[row] for layer in self._pool]
        scales = torch.stack([layer.k_scale[row] for layer in self._pool]
                             + [layer.v_scale[row] for layer in self._pool])
        host = self._to_host(codes, plen)
        sc = [np.ascontiguousarray(a, np.float32)
              for a in scales.cpu().numpy()]
        n = len(self._pool)
        return {"ks": host[:n], "vs": host[n:], "plen": plen,
                "k_scales": sc[:n], "v_scales": sc[n:],
                "scale_block": self.config.block_size}

    def _check_bundle(self, ks, vs, plen, what):
        cfg = self._model.cfg
        shape = (int(plen),) + self._head_shape()
        if len(ks) != cfg.num_layers or len(vs) != cfg.num_layers:
            raise ValueError(
                f"{what} bundle has {len(ks)}/{len(vs)} layers, model has "
                f"{cfg.num_layers}")
        for arr in list(ks) + list(vs):
            if tuple(np.shape(arr)) != shape:
                raise ValueError(f"{what} layer shape "
                                 f"{tuple(np.shape(arr))} != {shape}")

    def _upload_bundle(self, ks, vs, tokens):
        """The first `tokens` rows of host K/V slices -> one device float32
        tensor [2, layers, tokens, h, d] (one copy)."""
        buf = self._host_buffer((2, len(ks), tokens) + self._head_shape(),
                                torch.float32)
        host = buf.numpy()
        for i, (k, v) in enumerate(zip(ks, vs)):
            host[0, i] = np.asarray(k, np.float32)[:tokens]
            host[1, i] = np.asarray(v, np.float32)[:tokens]
        return buf.to(self.device)

    def adopt_kv(self, slot, ks, vs, plen, first_token, rng=None):
        """The handoff sink: place a request whose prefill ran elsewhere.
        Allocates the blocks `plen` tokens need (all or nothing), scatters
        the per-layer K/V slices into them from position 0, padded to the
        prefill bucket as the JAX `adopt[bucket]` executable pads them
        (int8 pools requantize against this pool's blocks through
        `blocks.quant_write`), and arms the slot as a local prefill would:
        pos=plen, next decode input `first_token`. `rng=(seed, gen)` is a
        v3 bundle's sampler state; None arms a fresh local seed. Raises
        BlockAllocError under pressure (the scheduler's cue to preempt);
        any other failure frees the slot and raises."""
        slot = int(slot)
        plen = int(plen)
        self._check_bundle(ks, vs, plen, "adopt")
        if plen < 1:
            raise ValueError("empty adopt bundle")
        if plen > self.max_prompt_len or self.config.max_len - plen < 1:
            raise ValueError(
                f"adopted prefix ({plen} tokens) exceeds the engine "
                f"limits (max prompt {self.max_prompt_len}, max_len "
                f"{self.config.max_len})")
        if self._slot_active[slot]:
            self.reset_slot(slot)
        n = blocks.blocks_for_tokens(plen, self.config.block_size)
        priv = self._alloc_blocks(n)        # all-or-nothing; may raise
        row = np.zeros((self.config.max_blocks_per_slot,), np.int32)
        row[:n] = priv
        self._tables[slot] = row
        self._slot_active[slot] = True
        bucket = self.bucket_for(plen)
        try:
            new = torch.zeros((2, len(ks), bucket) + self._head_shape(),
                              dtype=torch.float32, device=self.device)
            new[:, :, :plen] = self._upload_bundle(ks, vs, plen)
            tables = torch.from_numpy(row[None]).to(self.device)
            zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
            for li, layer in enumerate(self._pool):
                k, v = new[0, li][None], new[1, li][None]
                if self.kv_quantized:
                    blocks.quant_write(layer.k, layer.k_scale, k, tables,
                                       zero)
                    blocks.quant_write(layer.v, layer.v_scale, v, tables,
                                       zero)
                else:
                    blocks.write(layer.k, k, tables, zero)
                    blocks.write(layer.v, v, tables, zero)
        except Exception:
            self.reset_slot(slot)           # never strand the blocks
            raise
        self._pos[slot] = plen
        self._last_tokens[slot] = np.int32(first_token)
        if rng is not None:
            self.set_slot_rng(slot, rng[0], rng[1])
        else:
            self.set_slot_rng(slot, self._default_slot_seed(), 0)
        self.last_prefill_stats = {"prefix_hit_tokens": 0,
                                   "blocks_allocated": n,
                                   "suffix_bucket": bucket,
                                   "adopted": True}
        return int(first_token)

    def prefix_probe(self, prompt_ids, namespace=None):
        """Tokens of `prompt_ids` the prefix cache could serve, with no
        side effect."""
        if self.prefix_cache is None:
            return 0
        toks = [int(t) for t in np.asarray(prompt_ids, np.int64).ravel()]
        return int(self.prefix_cache.probe(toks, namespace))

    def extract_prefix_kv(self, prompt_ids, namespace=None):
        """The prefix-restore source: this engine's servable chain for
        `prompt_ids`, the cached entries and their tiered continuation
        (records verified on the way: a corrupt one ends the chain), as
        per-layer [tokens, heads, head_dim] float32 host arrays, and the
        tokens it covers. The entries stay here; the peer registers a
        copy."""
        if self.prefix_cache is None:
            return [], [], 0
        toks = [int(t) for t in np.asarray(prompt_ids, np.int64).ravel()]
        bs = self.config.block_size
        chain = []                  # per block: a pool block id or a record
        for k in range((len(toks) - 1) // bs):
            key = prefix_key(toks[:(k + 1) * bs], namespace)
            blk = self.prefix_cache._entries.get(key)
            if blk is None and self.kv_tiers is not None \
                    and key in self.kv_tiers:
                blk = self.kv_tiers.peek(key)
            if blk is None:
                break
            chain.append(blk)
        if not chain:
            return [], [], 0
        nl = len(self._pool)
        ids = [b for b in chain if not isinstance(b, dict)]
        if ids:
            idx = torch.tensor(ids, dtype=torch.int64, device=self.device)
            ks, vs = [], []
            for layer in self._pool:
                if self.kv_quantized:
                    ks.append(blocks.dequant(layer.k[idx],
                                             layer.k_scale[idx]))
                    vs.append(blocks.dequant(layer.v[idx],
                                             layer.v_scale[idx]))
                else:
                    ks.append(layer.k[idx].float())
                    vs.append(layer.v[idx].float())
            host = self._to_host(ks + vs, len(ids) * bs)
        parts = [[] for _ in range(2 * nl)]
        r = 0                       # the next pooled block's row in `host`
        for b in chain:
            if isinstance(b, dict):
                arrays = b["arrays"]
                for li in range(nl):
                    for j, side in enumerate(("k", "v")):
                        a = arrays[f"{side}{li}"]
                        if b.get("quant"):
                            a = blocks.dequant_codes(
                                torch.from_numpy(np.ascontiguousarray(a)),
                                torch.from_numpy(np.ascontiguousarray(
                                    arrays[f"{side}s{li}"]))[None, :, None]
                            ).numpy()
                        parts[j * nl + li].append(np.asarray(a, np.float32))
            else:
                for i in range(2 * nl):
                    parts[i].append(host[i][r * bs:(r + 1) * bs])
                r += 1
        out = [np.ascontiguousarray(np.concatenate(p)) for p in parts]
        return out[:nl], out[nl:], len(chain) * bs

    def restore_prefix(self, prompt_ids, ks, vs, plen, namespace=None):
        """The prefix-restore sink: register another engine's exported
        chain for `prompt_ids` in this engine's prefix cache, so the next
        prefill of the prompt matches it like a warm local chain. Each
        missing block is allocated and written in place (an int8 pool
        quantizes it against its per-head abs-max with
        `blocks.quantize_codes`), then registered; blocks already cached
        are touched. Allocation pressure ends the walk early: the prefix
        registered so far still matches. Returns the tokens now servable
        from the chain (a multiple of block_size).

        `serving.kv_restore` fires once for the whole bundle: a raise or a
        truncate restores nothing (the prefill recomputes; never a
        partial registration) and ticks `serving_kv_tier_corrupt_total`."""
        if self.prefix_cache is None or int(plen) < 1:
            return 0
        try:
            spec = _faults.fire("serving.kv_restore")
        except Exception:
            corrupt_counter().inc()
            return 0
        if spec is not None and spec.mode == "truncate":
            corrupt_counter().inc()
            return 0
        self._check_bundle(ks, vs, plen, "restore")
        toks = [int(t) for t in np.asarray(prompt_ids, np.int64).ravel()]
        bs = self.config.block_size
        cache = self.prefix_cache
        chain, fresh = [], []          # (key, block or None); new indices
        for k in range(min(int(plen) // bs, (len(toks) - 1) // bs)):
            key = prefix_key(toks[:(k + 1) * bs], namespace)
            if key in cache._entries:
                chain.append((key, None))
                continue
            if self.kv_tiers is not None and key in self.kv_tiers:
                # the continuation is tiered here: registering past it
                # would orphan the chain (the prefill's match promotes it)
                break
            try:
                blk = int(self._alloc_blocks(1, requester=namespace)[0])
            except blocks.BlockAllocError:
                break
            chain.append((key, blk))
            fresh.append(k)
        if fresh:
            self._write_blocks([chain[k][1] for k in fresh], fresh, ks, vs,
                               len(chain) * bs)
        prev = None
        for key, blk in chain:
            if blk is None:
                cache._touch(key)
            else:
                cache.register_block(key, blk, namespace, prev)
            prev = key
        return len(chain) * bs

    def _write_blocks(self, blks, logical, ks, vs, tokens):
        """Write logical blocks `logical` of the per-layer slices `ks`/`vs`
        into physical blocks `blks` of every layer's pool, in place."""
        bs = self.config.block_size
        h, d = self._head_shape()
        new = self._upload_bundle(ks, vs, tokens).view(
            2, len(ks), tokens // bs, bs, h, d)
        src = torch.tensor(logical, dtype=torch.int64, device=self.device)
        dst = torch.tensor(blks, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for li, layer in enumerate(self._pool):
                for side, pool in ((0, layer.k), (1, layer.v)):
                    f = new[side, li][src]               # [n, bs, h, d]
                    if self.kv_quantized:
                        scale = torch.clamp(torch.amax(f.abs(), dim=(1, 3)),
                                            min=1e-30)     # [n, h]
                        pool[dst] = blocks.quantize_codes(
                            f, scale[:, None, :, None])
                        (layer.k_scale if side == 0
                         else layer.v_scale)[dst] = scale
                    else:
                        pool[dst] = f.to(pool.dtype)


def default_compile_cache_dir(path):
    """The compile cache that lives next to a serving artifact: what
    `save_for_generation(precompile=True)` fills and a Predictor loads
    from."""
    return os.path.join(os.path.dirname(os.path.abspath(path)),
                        COMPILE_CACHE_DIRNAME)


def _engine_kind(config):
    """"dense" | "paged" | "spec" | "tp" | "pp" | "spec_pp" for an
    EngineConfig-family instance (most-derived class first). The tp and
    pp checks consult `sys.modules` instead of importing: their configs
    exist only once their module is imported, so classifying another
    config never imports the multi-device tier."""
    from .spec_decode import SpecDecodeConfig
    pp_mod = sys.modules.get(__package__ + ".distributed.pp")
    if pp_mod is not None and \
            isinstance(config, pp_mod.PipelineParallelSpecConfig):
        return "spec_pp"
    if isinstance(config, SpecDecodeConfig):
        return "spec"
    if pp_mod is not None and \
            isinstance(config, pp_mod.PipelineParallelEngineConfig):
        return "pp"
    tp_mod = sys.modules.get(__package__ + ".distributed.tp")
    if tp_mod is not None and \
            isinstance(config, tp_mod.TensorParallelEngineConfig):
        return "tp"
    if isinstance(config, PagedEngineConfig):
        return "paged"
    if isinstance(config, EngineConfig):
        return "dense"
    raise TypeError(f"engine_config must be an EngineConfig, got "
                    f"{type(config).__name__}")


ENGINE_KINDS = ("dense", "paged", "spec", "tp", "pp", "spec_pp")


def _engine_classes(kind):
    """(engine class, config class) of `kind`; only the tp, pp and
    spec_pp kinds import the multi-device tier."""
    if kind == "dense":
        return GenerationEngine, EngineConfig
    if kind == "paged":
        return PagedGenerationEngine, PagedEngineConfig
    if kind == "spec":
        from .spec_decode import SpecDecodeConfig, SpeculativeEngine
        return SpeculativeEngine, SpecDecodeConfig
    if kind == "tp":
        from .distributed.tp import (TensorParallelEngineConfig,
                                     TensorParallelPagedEngine)
        return TensorParallelPagedEngine, TensorParallelEngineConfig
    if kind == "pp":
        from .distributed.pp import (PipelineParallelEngineConfig,
                                     PipelineParallelPagedEngine)
        return PipelineParallelPagedEngine, PipelineParallelEngineConfig
    if kind == "spec_pp":
        from .distributed.pp import (PipelineParallelSpecConfig,
                                     PipelineParallelSpeculativeEngine)
        return PipelineParallelSpeculativeEngine, PipelineParallelSpecConfig
    raise ValueError(f"unknown serving engine kind {kind!r}; want one of "
                     f"{list(ENGINE_KINDS)}")


def make_engine(model, kind, config_dict, device="cuda",
                compile_cache_dir=None):
    """An engine of `kind` (one of `ENGINE_KINDS`) over `model`, its
    config built from `config_dict` (a `.gencfg` record's config, or the
    ctor kwargs a serving worker is started with) plus a machine-local
    compile-cache dir."""
    engine_cls, cfg_cls = _engine_classes(kind)
    cfg = cfg_cls(compile_cache_dir=compile_cache_dir, **config_dict)
    return engine_cls(model, cfg, device=device)


_GPT_FIELDS = ("vocab_size", "max_position_embeddings", "hidden_size",
               "num_layers", "num_heads", "intermediate_size",
               "hidden_dropout", "attention_dropout", "initializer_range",
               "tie_embeddings")


def save_for_generation(model, path, input_spec=None, engine_config=None,
                        precompile=False, compile_cache_dir=None):
    """Write a servable artifact of a GPT at `path`: `path.pdiparams`
    ({"params", "buffers", "feed_names"} through `framework.io`, the
    weights in the JAX package's names and `[in, out]` layout) and
    `path.gencfg` (the GPT config; with `engine_config`, the serving
    record: the engine kind, `engine_config.as_dict()` and the executable
    set), the files the JAX `save_for_generation` writes but its
    `.pdmodel`. `input_spec` only names the feed (default "input_ids").

    With `precompile=True` the recorded engine is built now on the
    model's device, with the compile cache `compile_cache_dir` (default
    `default_compile_cache_dir(path)`), and `precompile()`d: the kernel
    libraries it launches are committed there, so a cold Predictor
    loads them instead of compiling. Returns that report, or None."""
    from ..framework import io as _io
    from ..text.models.convert import to_jax_params
    from ..text.models.gpt import GPT, GPTForGeneration
    if isinstance(model, GPTForGeneration):
        model = model.gpt
    if not isinstance(model, GPT):
        raise TypeError("save_for_generation expects a GPT/GPTForGeneration")
    if precompile and engine_config is None:
        raise ValueError("precompile=True needs an engine_config: the "
                         "executable set to prepare is derived from it")
    feed = [getattr(s, "name", None) or f"input_{i}"
            for i, s in enumerate(input_spec or [])] or ["input_ids"]
    _io.save({"params": to_jax_params(model), "buffers": {},
              "feed_names": feed}, path + ".pdiparams")
    meta = {"model_family": "gpt",
            "config": {k: getattr(model.cfg, k) for k in _GPT_FIELDS}}
    engine = None
    if engine_config is not None:
        kind = _engine_kind(engine_config)
        if precompile:
            engine = make_engine(
                model, kind, engine_config.as_dict(), device=model.device,
                compile_cache_dir=compile_cache_dir
                or default_compile_cache_dir(path))
        meta["serving"] = {"engine": kind, "config": engine_config.as_dict(),
                           "executables": _executable_set(kind,
                                                          engine_config)}
    with open(path + GENCFG_SUFFIX, "w") as f:
        json.dump(meta, f)
    if engine is not None:
        return engine.precompile()
    return None


def _executable_set(kind, config):
    """The executable names of an engine of `kind` and `config`: what
    every engine's `executable_names()` returns and a serving record
    lists, known without building the engine."""
    if kind in ("pp", "spec_pp"):
        # a pp-kind config exists only once its module is imported
        from .distributed.pp import pp_executable_names
        return pp_executable_names(config, spec=(kind == "spec_pp"))
    names = ["decode"] + [f"prefill[{b}]" for b in config.prefill_buckets]
    if kind == "spec":
        names += ["draft_decode", "spec_verify"]
        names += [f"draft_prefill[{b}]" for b in config.prefill_buckets]
    return names


def artifact_prefix(path):
    """An artifact's path without its suffix (`.pdmodel`, `.pdiparams` or
    `.gencfg`)."""
    for suffix in (".pdmodel", ".pdiparams", GENCFG_SUFFIX):
        if path.endswith(suffix):
            return path[:-len(suffix)]
    return path


def read_gencfg(path):
    """The `.gencfg` record of the artifact at `path` (its prefix, or any
    of its files), or None."""
    try:
        with open(artifact_prefix(path) + GENCFG_SUFFIX) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_generation_model(prog_file, params, device="cuda"):
    """The GPT of a `.gencfg` record (the artifact's prefix, `.pdmodel`,
    `.pdiparams` or `.gencfg` path) with `params` ({JAX name: array or
    tensor} in the JAX layout, as `framework.io.load` reads a
    `.pdiparams`) loaded, on `device`, in eval mode; None when the
    artifact has no record. bfloat16 weights give a bfloat16 model."""
    meta = read_gencfg(prog_file)
    if meta is None:
        return None
    from ..text.models.convert import load_jax_params
    from ..text.models.gpt import GPT, GPTConfig
    first = next(iter(params.values()))
    dtype = first.dtype if isinstance(first, torch.Tensor) and \
        first.is_floating_point() else torch.float32
    host = {n: v.detach().to("cpu", torch.float32).numpy()
            if isinstance(v, torch.Tensor) else v for n, v in params.items()}
    model = GPT(GPTConfig(**meta["config"]), device=device, dtype=dtype,
                init_weights=False)
    load_jax_params(model, host)
    model.eval()
    return model
