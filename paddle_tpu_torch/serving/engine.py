"""Prefill/decode engines over a GPT: the compute layer of serving.

Counterpart of `paddle_tpu/serving/engine.py` (`EngineConfig`,
`GenerationEngine`, `PagedEngineConfig`, `PagedGenerationEngine`).
Generation has two phases: prefill runs a whole prompt once per request,
right-padded to the nearest length bucket; decode advances every slot one
token per step. Slot lifecycle (who occupies which slot, retirement,
refill) belongs to `scheduler.Scheduler`; the engines only compute.

Every forward is functional: `torch.func.functional_call` runs the module
over a param dict. `_params` (the module's own tensors, no copy) serves
prefill; `_decode_params` serves decode and is the same dict, or with
`weight_dtype="int8"` int8 codes plus per-output-channel scales that each
decode forward dequantizes with plain torch before the float matmuls.
`swap_params` replaces the dict between steps (weight hot-swap) and leaves
the module untouched.

PyTorch runs eagerly, so the JAX engines' compile-once executables have no
counterpart here. What the port counts instead is kernel launches:
`kernel_launches` is the number of paged-attention kernel launches this
engine's calls made (0 for the gather path and on the CPU).

Left out of this port: the persistent compile cache, the numerics taps,
LoRA adapters, KV tiers and KV handoff (adopt/extract).
"""
import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import paged_attention as _pa
from . import blocks
from . import kv_cache as kvc
from . import sampling
from .prefix_cache import PrefixCache

__all__ = ["EngineConfig", "GenerationEngine", "PagedEngineConfig",
           "PagedGenerationEngine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


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
    """Slot, bucket and strategy knobs for one GenerationEngine."""

    def __init__(self, slots=4, max_len=256, prefill_buckets=None,
                 decode_strategy="greedy", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, seed=0):
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
        # the module's own tensors, no copy: prefill serves this dict,
        # decode the derived `_decode_params`
        self._params = dict(model.named_parameters())
        self._build_decode_params()
        self._last_tokens = np.zeros((self.config.slots,), np.int32)
        # per-slot sampler state: slot s's next token is generation index
        # _slot_gen[s] of the request seeded _slot_seeds[s]
        self._slot_seeds = np.zeros((self.config.slots,), np.int64)
        self._slot_gen = np.zeros((self.config.slots,), np.int64)
        self._rng_nonce = 0
        self.kernel_launches = 0
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

    def _select_slots(self, logits):
        """[slots, V] -> np.int32 [slots]; sampling draws each row from its
        own slot's generator."""
        if self.config.decode_strategy == "greedy":
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
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

    def _forward(self, ids, cache, params=None):
        """One functional model forward over `params` (default: the float
        serving dict), counting the kernel launches it made."""
        before = _pa.launches
        with torch.no_grad():
            out = torch.func.functional_call(
                self._model, self._params if params is None else params,
                (ids,), {"cache": cache})
        self.kernel_launches += _pa.launches - before
        return out

    def _decode_forward(self, ids, cache):
        """A decode (or verify) forward: over `_decode_params`, int8
        entries dequantized first."""
        return self._forward(ids, cache,
                             self._dequant_params(self._decode_params))

    # -- decode params and weight hot-swap ----------------------------------
    def _build_decode_params(self):
        """The param set decode runs on: the float dict itself here; the
        paged engine quantizes it for weight_dtype="int8". Rebuilt after
        every weight swap."""
        self._decode_params = self._params

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
        old weights keep serving. Every value is copied into storage of
        the engine's own, detached, so a caller that later updates its
        tensors in place (a trainer stepping the model it swapped in)
        cannot change what serves, as the reference's immutable arrays
        cannot. The module is left untouched. Returns the number of
        swapped tensors."""
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
                                           dtype=old.dtype, copy=True)
        self._params = staged                  # the commit point
        self._build_decode_params()
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
        logits, local = self._forward(self._padded(prompt, bucket), local)
        for glob, loc in zip(self._cache.layers, local.layers):
            glob.k[slot, :bucket] = loc.k[0]
            glob.v[slot, :bucket] = loc.v[0]
        self._cache.pos[slot] = int(prompt.size)
        first = int(self._select(logits[:, prompt.size - 1], slot)[0])
        self._slot_gen[slot] += 1
        self._last_tokens[slot] = first
        return first

    def decode(self):
        """Advance every slot one token; returns np.int32 [slots]."""
        tokens = torch.from_numpy(self._last_tokens.astype(np.int64))
        logits, cache = self._decode_forward(tokens.to(self.device)[:, None],
                                             self._cache)
        # free slots keep decoding garbage harmlessly; clamp so their
        # position stays in bounds forever
        pos = torch.clamp(self._cache.pos + 1, max=self.config.max_len - 1)
        self._cache = kvc.DecodeCache(cache.layers, pos)
        out = self._select_slots(logits[:, 0])
        self._slot_gen += 1
        self._last_tokens = out.copy()
        return out

    def set_slot_token(self, slot, token):
        """Feed `token` as slot's next decode input (after prefill, or to
        teacher-force a stream)."""
        self._last_tokens[int(slot)] = np.int32(token)

    def reset_slot(self, slot):
        """Mark a slot free: pos=0 hides its stale rows."""
        self._cache.pos[int(slot)] = 0
        self._last_tokens[int(slot)] = 0
        self.set_slot_rng(slot, 0, 0)

    def slot_positions(self):
        return self._cache.pos.cpu().numpy().astype(np.int32)

    @property
    def slots(self):
        return self.config.slots

    @property
    def max_prompt_len(self):
        """Longest prompt prefill can serve and still decode one token."""
        return min(self.config.prefill_buckets[-1], self.config.max_len - 1)

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
    in `engine.last_logits`."""

    def __init__(self, block_size=16, num_blocks=None,
                 enable_prefix_cache=True, attention_impl="kernel",
                 kv_dtype="float32", weight_dtype="float32",
                 capture_logits=False, **kwargs):
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


class PagedGenerationEngine(GenerationEngine):
    """GenerationEngine over the paged block pool (`blocks.py`): block
    tables and positions live on the host, the pools on the device. Adds
    `block_pool` (refcounted allocator), `prefix_cache` (shared prompt
    blocks) and `ensure_slot_capacity` for the scheduler's preemption
    loop. Prefill runs only the suffix after a prefix-cache hit."""

    _config_cls = PagedEngineConfig

    @property
    def kv_quantized(self):
        return self.config.kv_dtype == "int8"

    def _alloc_state(self):
        cfg = self._model.cfg
        c = self.config
        head_dim = cfg.hidden_size // cfg.num_heads
        if self.kv_quantized:
            self._pool = blocks.alloc_quant_pools(
                cfg.num_layers, c.num_blocks, c.block_size, cfg.num_heads,
                head_dim, self.device)
        else:
            self._pool = blocks.alloc_pools(
                cfg.num_layers, c.num_blocks, c.block_size, cfg.num_heads,
                head_dim, self._model.wte.weight.dtype, self.device)
        self._pos = np.zeros((c.slots,), np.int32)
        self._tables = np.zeros((c.slots, c.max_blocks_per_slot), np.int32)
        self._slot_active = np.zeros((c.slots,), bool)
        self.block_pool = blocks.BlockPool(c.num_blocks, c.block_size)
        self.prefix_cache = PrefixCache(self.block_pool, c.block_size) \
            if c.enable_prefix_cache else None
        self.last_prefill_stats = {}
        self.last_logits = None

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
        `_params` keep serving prefill."""
        if self.config.weight_dtype != "int8":
            self._decode_params = self._params
            return
        self._decode_params = self._quantize_params(self._params)

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

    # -- block accounting -----------------------------------------------------
    def _alloc_blocks(self, n):
        """Pool alloc with prefix-cache eviction as the pressure valve;
        BlockAllocError escapes only when eviction cannot cover it."""
        try:
            return self.block_pool.alloc(n)
        except blocks.BlockAllocError:
            if self.prefix_cache is not None:
                short = n - self.block_pool.available
                if self.prefix_cache.evict(short) >= short:
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
            for lb, b in zip(need, self._alloc_blocks(len(need))):
                self._tables[slot, lb] = b

    def ensure_decode_capacity(self):
        for s in range(self.config.slots):
            self.ensure_slot_capacity(s)

    def _paged_forward(self, ids, tables, pos, valid=None, decode=False):
        """One forward through the block tables under `attention_impl`;
        decode (and verify) forwards run on `_decode_params`."""
        cache = blocks.PagedDecodeCache(
            self._pool,
            torch.from_numpy(np.ascontiguousarray(tables)).to(self.device),
            torch.from_numpy(np.asarray(pos, np.int32)).to(self.device),
            None if valid is None else
            torch.tensor(valid, dtype=torch.int32, device=self.device))
        forward = self._decode_forward if decode else self._forward
        with blocks.attention_impl(self.config.attention_impl):
            logits, _ = forward(ids, cache)
        return logits

    # -- public compute API ---------------------------------------------------
    def prefill(self, slot, prompt_ids, rng=None):
        """Place `prompt_ids` into `slot`: match the prefix cache, allocate
        private blocks for the rest, run the suffix through its bucket
        (writes land in this slot's blocks) and return the first token.
        `last_prefill_stats` records the prefix hit."""
        slot = int(slot)
        prompt = self._check_prompt(prompt_ids)
        if self._slot_active[slot]:
            self.reset_slot(slot)
        plen = int(prompt.size)
        bs = self.config.block_size
        toks = [int(t) for t in prompt]
        need = blocks.blocks_for_tokens(plen, bs)
        # record=False: the hit counts only once this placement sticks
        shared, nshared = ([], 0) if self.prefix_cache is None \
            else self.prefix_cache.match(toks, record=False)
        n_priv = need - nshared // bs
        try:
            priv = self._alloc_blocks(n_priv) if n_priv else []
        except blocks.BlockAllocError:
            for b in shared:                # give back the matched refs
                self.block_pool.unref(b)
            raise
        row = np.zeros((self.config.max_blocks_per_slot,), np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + n_priv] = priv
        self._tables[slot] = row
        self._slot_active[slot] = True
        seed, gen = rng if rng is not None \
            else (self._default_slot_seed(), 0)
        self.set_slot_rng(slot, seed, gen)

        suffix = prompt[nshared:]
        bucket = self.bucket_for(suffix.size)
        logits = self._paged_forward(self._padded(suffix, bucket), row[None],
                                     [nshared], valid=[suffix.size])
        self._pos[slot] = nshared + suffix.size
        first = int(self._select(logits[:, suffix.size - 1], slot)[0])
        self._slot_gen[slot] += 1
        if self.prefix_cache is not None:
            # the prompt's fully written blocks become shareable
            self.prefix_cache.insert(toks, row, (plen // bs) * bs)
            self.prefix_cache.record_lookup(nshared > 0)
        self.last_prefill_stats = {"prefix_hit_tokens": nshared,
                                   "blocks_allocated": n_priv,
                                   "suffix_bucket": bucket}
        self._last_tokens[slot] = first
        return first

    def decode(self):
        """Advance every slot one token; returns np.int32 [slots]. Active
        slots get their next block first (BlockAllocError under pressure;
        the scheduler grows slots itself so it can preempt instead)."""
        self.ensure_decode_capacity()
        tokens = torch.from_numpy(self._last_tokens.astype(np.int64))
        logits = self._paged_forward(tokens.to(self.device)[:, None],
                                     self._tables, self._pos, decode=True)
        self._pos = np.minimum(self._pos + 1, self.config.max_len - 1) \
            .astype(np.int32)
        if self.config.capture_logits:
            self.last_logits = logits[:, 0].float().cpu().numpy()
        out = self._select_slots(logits[:, 0])
        self._slot_gen += 1
        self._last_tokens = out.copy()
        return out

    def reset_slot(self, slot):
        """Free the slot: its table drops every reference (blocks return
        to the pool unless the prefix cache holds them), pos=0."""
        slot = int(slot)
        for b in self._tables[slot]:
            if b != blocks.GARBAGE_BLOCK:
                self.block_pool.unref(int(b))
        self._tables[slot] = blocks.GARBAGE_BLOCK
        self._slot_active[slot] = False
        self._pos[slot] = 0
        self._last_tokens[slot] = 0
        self.set_slot_rng(slot, 0, 0)

    def slot_positions(self):
        return self._pos.copy()
