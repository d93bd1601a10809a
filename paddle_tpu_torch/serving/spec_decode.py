"""Speculative multi-token decode over the paged serving engine.

Counterpart of `paddle_tpu/serving/spec_decode.py` (`truncated_draft`,
`SpecDecodeConfig`, `SpeculativeEngine`). A cheap draft GPT proposes gamma
tokens one at a time; one target forward over the [slots, gamma+1] window
verifies them (`sampling.greedy_verify`). Under greedy decoding the
emitted stream is the one-token loop's: the draft only decides how many
tokens a round buys.

The verify forward goes through the block tables like every paged
forward, under `attention_impl`: with "kernel" on the card it is the
paged-attention kernel at T = gamma+1 and decode positions.

Executables (`executable_names()`, the JAX engine's list): the paged
engine's plus `draft_decode` (the gamma+1 draft decodes of a round, which
leave the window in a static buffer), `spec_verify` (the [slots, gamma+1]
verify forward and `greedy_verify`, up to the round's one host read) and
`draft_prefill[bucket]`; on the card each is a CUDA graph captured once.
The draft's executables launch no kernel library, so `precompile()`
reports them "captured" under a compile cache too.
The draft's dense cache, its positions and the per-bucket one-slot caches
of its prefill are static storage too.

Cache protocol: at every round boundary the draft's dense cache and the
target's paged pool hold the same committed tokens, and the draft's
positions equal the target's.
  1. the draft proposes d_1..d_gamma with gamma single-token decodes
     (writing t0, d_1..d_{gamma-1} into its cache), plus one extra feed of
     d_gamma so that a fully accepted window leaves its cache complete
     (that proposal is discarded). The window stays on the device: the
     round's only host read is the verify's result;
  2. the verify forward writes K/V for the whole window through the
     slot's block table (`decode_write_tokens = gamma+1`, so the
     scheduler provisions the blocks before the round, preempting under
     pressure as for one-token growth);
  3. rejection is a position rollback: both engines' positions advance by
     n_accepted+1. Rejected K/V past the new position stays in blocks the
     slot owns, masked by position and overwritten next round; no block
     reference moves.

With int8 KV pools the verify write cannot leave out the rejected tail
(it is not known before the forward), so those tokens ride the touched
block's abs-max scale for that one write, as in the JAX engine; the next
write recomputes the scale over real positions only.

A round fires `serving.decode_step` first, before the int8 KV chaos site
and before any block or position moves, so a fault leaves the draft and
the target at the same committed tokens. It observes the
`serving_spec_draft_seconds` and `serving_spec_verify_seconds`
histograms and runs under the `serving::spec_draft` and
`serving::spec_verify` spans.

Per-tenant adapters ride the verify forward (it decides every emitted
token, so an adapted slot's stream is the one-token adapted loop's); the
draft stays on the base weights and an adapted slot only pays in
acceptance.

Numerics taps (armed with `numerics_taps=True`): the verify graph taps
the window's logits as `spec.verify_logits` (where a corrupted target
first meets emitted tokens) and packs the stats behind the round's one
host read; the round fires `numerics.corrupt` after the KV chaos site.
The draft runs the masters for its float tensors, so a corruption of the
target's decode storage never reaches it; an int8 draft shares the
target's quantized entries, so a damaged int8 scale reaches both.

The pipeline-parallel speculative engine (`distributed/pp.py`) reuses
this engine's draft and round, and runs the verify window on the stage
ring.
"""
import dataclasses
import functools
import time

import numpy as np
import torch

from ..observability import faults as _faults
from ..observability import metrics as _metrics
from ..observability import numerics as _numerics
from ..profiler import RecordEvent, TracerEventType
from . import kv_cache as kvc
from . import sampling
from .engine import PagedEngineConfig, PagedGenerationEngine

__all__ = ["SpecDecodeConfig", "SpeculativeEngine", "truncated_draft"]

_M_DRAFT_SECONDS = _metrics.histogram(
    "serving_spec_draft_seconds",
    "Wall time of one speculative round's draft proposal loop")
_M_VERIFY_SECONDS = _metrics.histogram(
    "serving_spec_verify_seconds",
    "Wall time of one speculative round's target verify forward")


def truncated_draft(model, num_layers):
    """A draft GPT made of the target's first `num_layers` blocks, sharing
    the target's parameter tensors (embeddings, the kept blocks, the final
    LayerNorm): no second copy of any weight."""
    from ..text.models.gpt import GPT
    num_layers = int(num_layers)
    if not 1 <= num_layers <= model.cfg.num_layers:
        raise ValueError(
            f"draft_layers={num_layers} must be in 1..target layers "
            f"({model.cfg.num_layers})")
    draft = GPT(dataclasses.replace(model.cfg, num_layers=num_layers),
                device=model.device)
    own = dict(model.named_parameters())
    for name, _ in list(draft.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(draft.get_submodule(owner), leaf, own[name])
    return draft.eval()


class SpecDecodeConfig(PagedEngineConfig):
    """PagedEngineConfig plus the speculative knobs. gamma: draft tokens
    proposed a round (a round emits 1..gamma+1 tokens). draft_layers:
    depth of the truncated draft built when no draft model is given.
    Greedy only: the stochastic accept rule needs the draft's
    probabilities, which this pipeline never materializes."""

    def __init__(self, gamma=4, draft_layers=1, **kwargs):
        super().__init__(**kwargs)
        if self.decode_strategy != "greedy":
            raise ValueError(
                "speculative decode is greedy-only (got decode_strategy="
                f"{self.decode_strategy!r})")
        self.gamma = int(gamma)
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.draft_layers = int(draft_layers)
        if self.capture_logits:
            raise ValueError(
                "capture_logits is not supported on the speculative "
                "engine: its decode is the verify window; point quality "
                "checks at a PagedGenerationEngine")

    # the `.gencfg` record's fields: the paged engine's and the knobs
    _DICT_FIELDS = PagedEngineConfig._DICT_FIELDS + ("gamma", "draft_layers")


class SpeculativeEngine(PagedGenerationEngine):
    """PagedGenerationEngine whose decode step is a speculative round.

    `decode_many()` returns (tokens [slots, gamma+1], n_emit [slots]):
    slot s emitted tokens[s, :n_emit[s]]. `last_spec_stats` holds the last
    round's `draft_s` and `verify_s` (host clock: the draft's launches
    return before the card runs them, so `verify_s`, which ends in the
    round's host read, carries the draft's device time too). The
    inherited one-token `decode()` stays available."""

    def __init__(self, model, config=None, draft=None, device="cuda",
                 **kwargs):
        config = config or SpecDecodeConfig(**kwargs)
        if not isinstance(config, SpecDecodeConfig):
            raise TypeError("SpeculativeEngine needs a SpecDecodeConfig")
        super().__init__(model, config, device=device)
        from ..text.models.gpt import GPT, GPTForGeneration
        if draft is None:
            draft = truncated_draft(self._model, config.draft_layers)
        if isinstance(draft, GPTForGeneration):
            draft = draft.gpt
        if not isinstance(draft, GPT):
            raise TypeError("draft must be a GPT or GPTForGeneration")
        if draft.cfg.vocab_size != self._model.cfg.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary: "
                f"{draft.cfg.vocab_size} vs {self._model.cfg.vocab_size}")
        if config.max_len > draft.cfg.max_position_embeddings:
            raise ValueError(
                f"max_len={config.max_len} exceeds the draft's "
                f"max_position_embeddings="
                f"{draft.cfg.max_position_embeddings}")
        if draft.device != self.device:
            raise ValueError(f"draft lives on {draft.device}, engine "
                             f"device is {self.device}")
        self.draft_model = draft
        # the draft's tensors that are the target's read the engine's own
        # copy of them, so a swap reaches target and draft together
        own = dict(self._model.named_parameters())
        self._draft_params = {
            n: self._params[n] if t is own.get(n) else t
            for n, t in draft.named_parameters()}
        dcfg = draft.cfg
        self._draft_cache = kvc.alloc_cache(
            dcfg.num_layers, config.slots, config.max_len, dcfg.num_heads,
            dcfg.hidden_size // dcfg.num_heads, draft.wte.weight.dtype,
            self.device)
        self._draft_pos = self._io.host["draft_pos"]
        # the one-slot dense cache each draft prefill bucket runs through
        self._draft_local = {
            b: kvc.alloc_cache(dcfg.num_layers, 1, b, dcfg.num_heads,
                               dcfg.hidden_size // dcfg.num_heads,
                               draft.wte.weight.dtype, self.device)
            for b in config.prefill_buckets}
        self._window = torch.zeros((config.slots, config.gamma + 1),
                                   dtype=torch.int64, device=self.device)
        self._build_draft_decode_params()
        self.last_spec_stats = {}

    @property
    def decode_write_tokens(self):
        """A verify forward writes the whole gamma+1 window per slot."""
        return self.config.gamma + 1

    def _decode_fields(self):
        return dict(super()._decode_fields(), draft_pos=(self.config.slots,))

    def _prefill_fields(self):
        return dict(super()._prefill_fields(),
                    draft_ids=(1, max(self.config.prefill_buckets)))

    def _safe_inputs(self):
        """The draft's dense cache has no garbage block: its safe position
        is max_len - 1, a row no committed token ever occupies (positions
        clamp there)."""
        return {"draft_pos": self.config.max_len - 1}

    def _build_draft_decode_params(self):
        """The draft's decode params. int8 weights compose: a draft tensor
        that is the target's own (the truncated draft) reuses the target's
        codes, so a swap requantizes both at once; only the draft's own
        tensors quantize anew."""
        if self.config.weight_dtype != "int8":
            self._draft_decode_params = self._draft_params
            return
        out, fresh = {}, {}
        for name, t in self._draft_params.items():
            if t is self._params.get(name):
                q = self._decode_params[name]
                out[name] = q if isinstance(q, dict) else t
            else:
                fresh[name] = t
        out.update(self._quantize_params(fresh))
        self._draft_decode_params = out

    def _weight_tensors(self):
        """The target's, plus the draft's own tensors (the truncated draft
        shares the target's, which count once) and int8 codes."""
        out = super()._weight_tensors()
        for src in (self._draft_params, self._draft_decode_params):
            for v in src.values():
                out.extend((v["q"], v["scale"]) if isinstance(v, dict)
                           else (v,))
        return out

    def _kv_tensors(self):
        """The pools, plus the draft's dense cache and its per-bucket
        prefill caches."""
        return super()._kv_tensors() + [
            x for cache in [self._draft_cache, *self._draft_local.values()]
            for layer in cache.layers for x in (layer.k, layer.v)]

    # -- the executables ------------------------------------------------------
    def _adapter_executables(self):
        return super()._adapter_executables() + ["spec_verify"]

    def _executable_libraries(self, name):
        """The draft's executables run on its dense cache and launch no
        kernel library; the rest are the paged engine's."""
        if name.startswith("draft_"):
            return []
        return super()._executable_libraries(name)

    def _executable(self, name):
        if name == "draft_decode":
            return self._draft_fn, self._io, self._safe_inputs()
        if name == "spec_verify":
            return self._verify_fn, self._io, self._safe_inputs()
        if name.startswith("draft_prefill["):
            bucket = int(name[len("draft_prefill["):-1])
            return (functools.partial(self._draft_prefill_fn, bucket),
                    self._pf, None)
        return super()._executable(name)

    def _run_draft(self, params, cache, ids):
        with torch.no_grad():
            return torch.func.functional_call(self.draft_model, params,
                                              (ids,), {"cache": cache})

    def _draft_decode(self, params, cache, tokens):
        """One single-token draft decode over the dense cache: returns
        (next tokens [S] int64 on the device, cache with pos advanced)."""
        logits, new = self._run_draft(params, cache, tokens[:, None])
        nxt = torch.argmax(logits[:, 0], dim=-1)
        pos = torch.clamp(cache.pos + 1, max=self.config.max_len - 1)
        return nxt, kvc.DecodeCache(new.layers, pos)

    def _draft_fn(self):
        """The `draft_decode` executable: gamma draft decodes plus the
        cache-completing extra feed; leaves the window [S, gamma+1] (int64)
        in `_window`."""
        io = self._io.dev
        params = self._dequant_params(self._draft_decode_params)
        cache = kvc.DecodeCache(self._draft_cache.layers, io["draft_pos"])
        feed = io["tokens"].to(torch.int64)
        cols = [feed]
        for _ in range(self.config.gamma):
            feed, cache = self._draft_decode(params, cache, feed)
            cols.append(feed)
        self._draft_decode(params, cache, feed)  # writes d_gamma's K/V only
        self._window.copy_(torch.stack(cols, dim=1))

    def _verify_fn(self):
        """The `spec_verify` executable: the target's forward over the
        window and the greedy accept rule; returns [S, gamma+3] int32
        (choices, n_accepted, last), the round's one host read (armed: the
        packed sink, that result first)."""
        io = self._io.dev
        with self._numerics_scope() as sink:
            logits = self._paged_forward(self._window, io["tables"],
                                         io["pos"], decode=True)
            choices, n_acc, last = sampling.greedy_verify(logits,
                                                          self._window)
            _numerics.tap("spec.verify_logits", logits)
        res = torch.cat([choices, n_acc[:, None], last[:, None]], dim=1)
        if sink is None:
            return res
        return res, self._stack_sink(sink, res)

    def _draft_prefill_fn(self, bucket):
        """The `draft_prefill[bucket]` executable: the whole prompt through
        the draft into the bucket's one-slot dense cache."""
        ids = self._pf.dev["draft_ids"][:, :bucket]
        self._run_draft(self._draft_params, self._draft_local[bucket], ids)

    # -- public compute API ---------------------------------------------------
    def prefill(self, slot, prompt_ids, rng=None, namespace=None):
        """Target prefill (prefix cache, suffix bucket, first token), then
        the draft's prefill of the whole prompt into its dense cache (the
        draft shares no prefix, so its bucket is the whole prompt's). The
        draft moves only after the target's prefill stuck, so an
        allocation failure leaves both untouched."""
        first = super().prefill(slot, prompt_ids, rng=rng,
                                namespace=namespace)
        slot = int(slot)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        bucket = self.bucket_for(prompt.size)
        ids = self._pf.host["draft_ids"]
        ids[0, :bucket] = 0
        ids[0, :prompt.size] = prompt
        self._run(f"draft_prefill[{bucket}]")
        local = self._draft_local[bucket]
        for glob, loc in zip(self._draft_cache.layers, local.layers):
            glob.k[slot, :bucket] = loc.k[0]
            glob.v[slot, :bucket] = loc.v[0]
        self._draft_pos[slot] = prompt.size
        return first

    def reset_slot(self, slot):
        super().reset_slot(slot)
        self._draft_pos[int(slot)] = 0

    def decode_many(self):
        """One speculative round for every slot: gamma draft proposals, one
        target verify, the position rollback. Returns (tokens [S, gamma+1]
        np.int32, n_emit [S] np.int32); free slots round-trip garbage
        harmlessly, as in the one-token loop."""
        _faults.fire("serving.decode_step")
        self._fire_kv_quant_chaos()
        self._fire_numerics_chaos()
        self.ensure_decode_capacity()
        c = self.config
        t0 = time.perf_counter()
        with RecordEvent("serving::spec_draft", TracerEventType.UserDefined,
                         {"gamma": c.gamma, "slots": c.slots}):
            self._run("draft_decode")
        draft_s = time.perf_counter() - t0
        _M_DRAFT_SECONDS.observe(draft_s)
        t1 = time.perf_counter()
        with RecordEvent("serving::spec_verify",
                         TracerEventType.UserDefined,
                         {"window": c.gamma + 1, "slots": c.slots,
                          "attend": c.attention_impl}):
            # the draft's upload serves the verify too; the one host read
            res = self._run("spec_verify", upload=False)
            stats = None
            if self._numerics_armed:
                res, packed = res
                head, stats = self._unstack_sink(packed, res.numel())
                res = head.reshape(tuple(res.shape))
            else:
                res = res.cpu().numpy()
        verify_s = time.perf_counter() - t1
        _M_VERIFY_SECONDS.observe(verify_s)
        out = np.ascontiguousarray(res[:, :-2])
        n_emit, last = res[:, -2] + 1, res[:, -1]
        # the rollback: both caches advance to the committed position
        self._pos[:] = np.minimum(self._pos + n_emit,
                                  self.config.max_len - 1)
        self._draft_pos[:] = self._pos
        self._slot_gen += n_emit
        self._last_tokens[:] = last
        self.last_spec_stats = {"draft_s": draft_s, "verify_s": verify_s}
        if stats is not None:
            self._ingest_numerics(stats)
        return out, n_emit
