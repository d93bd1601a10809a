"""GPT decoder LM as PyTorch modules.

Counterpart of `paddle_tpu/text/models/gpt.py` (`GPTConfig`, `GPTAttention`,
`GPTMLP`, `GPTBlock`, `GPT`, `GPTForGeneration`): pre-LN blocks,
tanh-approximated GELU, LayerNorm epsilon 1e-5, learned positions, tied LM
head. The fused qkv projection splits q|k|v-major,
`reshape(B, S, 3, heads, head_dim)`, as the JAX model does, so weights
carry over unchanged (`convert.py`).

Linear weights are stored the PyTorch way, `[out, in]`; the JAX model's
`[in, out]` weights are transposed on load.

The cached forward writes K/V into a dense `kv_cache.DecodeCache` or a
paged `blocks.PagedDecodeCache` (in place) and attends through it; the
paged attention runs the plain gather path or the CUDA kernel according to
`blocks.attention_impl`. After each block the cached forward calls
`observability.numerics.tap_layer(i, "act", x)`, dormant unless a numerics
sink with a layer filter is open (the NaN localizer's probes). The
uncached forward is plain masked causal attention.

`GPTStage` is one pipeline stage of a GPT (embeddings on the first, blocks
[start, stop), the final LayerNorm and head on the last), built over the
parent's own submodules by `gpt_pipeline_stages` on the `gpt_stage_ranges`
split; the pipeline-parallel serving engines take their stage split from
it. `paged_attend` is the paged write-and-attend the cached attention runs,
which the tensor-parallel engines call once a shard.

`adapters` (cached forwards only; the engines pass it to decode and
verify forwards) is the per-slot LoRA view {"slot": ids [B], "layers":
per-layer {target: (A, B)}}: each of `qkv`, `out_proj`, `fc1` and `fc2`
it names adds its rows' delta (`serving/tenancy/adapters.py`), gathered
by slot so a batch mixing tenants is one forward.
"""
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...observability import numerics as _numerics
from ...serving import blocks as _blk
from ...serving import kv_cache as _kvc
from ...serving import sampling as _sampling
from ...serving.tenancy.adapters import lora_apply

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPT",
           "GPTForGeneration", "GPTStage", "gpt_stage_ranges",
           "gpt_pipeline_stages", "gpt_tiny", "gpt_125m", "gpt_350m",
           "gpt_1p3b", "gpt_6p7b"]

LN_EPS = 1e-5     # the JAX LayerNorm default


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = None
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x, cache=None, pos=None, tables=None, valid=None,
                adapters=None):
        """Uncached (cache None): causal attention over x. With a dense
        `kv_cache.LayerKV` cache and per-slot `pos`, or a paged
        `(Quant)PagedLayerKV` cache with `tables`, the new K/V are written
        in place and attention runs over the cache; returns
        (out, layer cache). `valid` (quantized pools) is the per-slot count
        of real tokens in this write; `adapters` this layer's per-slot
        LoRA view."""
        B, S, H = x.shape
        qkv = lora_apply(self.qkv(x), x, adapters, "qkv")
        qkv = qkv.reshape(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)                                # B,S,h,d
        if cache is None:
            zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
            out = _kvc.attend(q, k, v, zero)
            return self.out_proj(out.reshape(B, S, H))
        q = q.contiguous()
        if tables is not None:
            out, new = paged_attend(q, k, v, cache, tables, pos, valid)
        else:
            k_buf = _kvc.write(cache.k, k, pos)
            v_buf = _kvc.write(cache.v, v, pos)
            out = _kvc.attend(q, k_buf, v_buf, pos)
            new = _kvc.LayerKV(k_buf, v_buf)
        out = out.reshape(B, S, H)
        return lora_apply(self.out_proj(out), out, adapters, "out_proj"), new


def paged_attend(q, k, v, cache, tables, pos, valid=None):
    """Write this call's K/V [B, S, h, d] into a paged layer cache (a
    `(Quant)PagedLayerKV`, in place) through `tables` and attend `q` over
    it under `blocks.attention_impl`; returns (out [B, S, h, d], the
    layer cache). The heads are whatever the pool holds: all of them, or
    a tensor-parallel shard's (`serving/distributed/tp.py`)."""
    kernel = _blk.current_attention_impl() == "kernel"
    if isinstance(cache, _blk.QuantPagedLayerKV):
        k_pool, k_sc = _blk.quant_write(cache.k, cache.k_scale, k,
                                        tables, pos, valid)
        v_pool, v_sc = _blk.quant_write(cache.v, cache.v_scale, v,
                                        tables, pos, valid)
        attend = _blk.attend_kernel_quant if kernel else _blk.attend_quant
        out = attend(q, k_pool, v_pool, k_sc, v_sc, tables, pos)
        return out, _blk.QuantPagedLayerKV(k_pool, v_pool, k_sc, v_sc)
    k_pool = _blk.write(cache.k, k, tables, pos)
    v_pool = _blk.write(cache.v, v, tables, pos)
    attend = _blk.attend_kernel if kernel else _blk.attend
    return attend(q, k_pool, v_pool, tables, pos), \
        _blk.PagedLayerKV(k_pool, v_pool)


def cached_positions(pos, S, max_positions):
    """[B, S] int64 position ids pos + 0..S-1 of a cached forward.
    Right-padded prefill tails may run past the position table; their rows
    are discarded, so the lookup is clamped into range."""
    return (pos.to(torch.int64)[:, None]
            + torch.arange(S, device=pos.device)[None, :]).clamp(
        max=max_positions - 1)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, adapters=None):
        mid = F.gelu(lora_apply(self.fc1(x), x, adapters, "fc1"),
                     approximate="tanh")
        return lora_apply(self.fc2(mid), mid, adapters, "fc2")


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.mlp = GPTMLP(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, cache=None, pos=None, tables=None, valid=None,
                adapters=None):
        if cache is None:
            x = x + self.dropout(self.attn(self.ln1(x)))
            return x + self.dropout(self.mlp(self.ln2(x)))
        attn_out, new_cache = self.attn(self.ln1(x), cache=cache, pos=pos,
                                        tables=tables, valid=valid,
                                        adapters=adapters)
        x = x + self.dropout(attn_out)
        x = x + self.dropout(self.mlp(self.ln2(x), adapters=adapters))
        return x, new_cache


class GPT(nn.Module):
    """The GPT decoder. Parameters are drawn on the CPU from a
    `torch.Generator` seeded `seed` (Normal(0, initializer_range) for
    weights and embeddings, zero biases, unit LayerNorm scales, as the JAX
    model initializes) and then moved to `device`, so a seed gives the same
    weights on every device. `init_weights=False` skips that draw: the
    modules are made on `device` with PyTorch's default initialization,
    for a caller that loads every parameter (`serving.
    load_generation_model`)."""

    def __init__(self, cfg: GPTConfig, device="cuda", seed=0,
                 dtype=torch.float32, init_weights=True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("cpu" if init_weights else dev):
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                    cfg.hidden_size)
            self.drop = nn.Dropout(cfg.hidden_dropout)
            self.blocks = nn.ModuleList(GPTBlock(cfg)
                                        for _ in range(cfg.num_layers))
            self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
            if not cfg.tie_embeddings:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                         bias=False)
        if init_weights:
            self._init_weights(torch.Generator().manual_seed(int(seed)))
        self.to(device=dev, dtype=dtype)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen):
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @property
    def device(self):
        return self.wte.weight.device

    def gen_cache(self, batch, max_len, dtype=None):
        """Dense preallocated decode cache: one [batch, max_len, heads,
        head_dim] K/V pair per block, pos=0."""
        if max_len > self.cfg.max_position_embeddings:
            raise ValueError(
                f"gen_cache max_len={max_len} exceeds "
                f"max_position_embeddings={self.cfg.max_position_embeddings}")
        c = self.cfg
        return _kvc.alloc_cache(c.num_layers, batch, max_len, c.num_heads,
                                c.hidden_size // c.num_heads,
                                dtype or self.wte.weight.dtype, self.device)

    def forward(self, input_ids, cache=None, adapters=None):
        """input_ids [B, S] int -> logits [B, S, V] (uncached), or
        (logits, new cache) with a dense or paged cache (and the per-slot
        adapter view, `adapters`)."""
        B, S = input_ids.shape
        ids = input_ids.to(torch.int64)
        if cache is None:
            positions = torch.arange(S, device=ids.device)[None, :]
            x = self.drop(self.wte(ids) + self.wpe(positions))
            for blk in self.blocks:
                x = blk(x)
            return self._head(self.ln_f(x))
        tables = getattr(cache, "tables", None)
        valid = getattr(cache, "valid", None)
        pos = cache.pos
        positions = cached_positions(pos, S, self.cfg.max_position_embeddings)
        x = self.drop(self.wte(ids) + self.wpe(positions))
        new_layers = []
        for i, (blk, lkv) in enumerate(zip(self.blocks, cache.layers)):
            lv = None if adapters is None else \
                {"slot": adapters["slot"], **adapters["layers"][i]}
            x, new_lkv = blk(x, cache=lkv, pos=pos, tables=tables,
                             valid=valid, adapters=lv)
            new_layers.append(new_lkv)
            # dormant unless a numerics sink with a layer filter is open:
            # the bisection localizer's probe sites
            _numerics.tap_layer(i, "act", x)
        logits = self._head(self.ln_f(x))
        if tables is not None:
            return logits, _blk.PagedDecodeCache(tuple(new_layers), tables,
                                                 pos + S)
        return logits, _kvc.DecodeCache(tuple(new_layers), pos + S)

    def _head(self, x):
        if self.cfg.tie_embeddings:
            return F.linear(x, self.wte.weight)
        return self.lm_head(x)


class GPTStage(nn.Module):
    """One pipeline stage of a GPT for pipeline-parallel serving: the
    parent's embeddings (first stage), blocks [start, stop) and final
    LayerNorm and head (last stage), as the parent's own submodules (no
    second copy of a weight). The tied embedding is the first stage's
    input table and, as `head_wte`, the last stage's head matrix.

    `forward(x, cache=..., pos=..., tables=..., valid=..., op=...)` runs
    the cached paged path of `GPT.forward` over this stage's slice (the
    cache holds this stage's layers):
      op="block"       embed (first stage) + this stage's blocks
                       -> (hidden, new layer caches)
      op="block_head"  block + final LayerNorm + head -> (logits, caches)
      op="head"        x is a last-block output: LayerNorm + head -> logits
    The per-block localizer sites (`tap_layer`) carry global layer
    indices."""

    def __init__(self, gpt, start, stop):
        super().__init__()
        cfg = gpt.cfg
        self.cfg = cfg
        self.start, self.stop = int(start), int(stop)
        self.is_first = self.start == 0
        self.is_last = self.stop == cfg.num_layers
        if self.is_first:
            self.wte = gpt.wte
            self.wpe = gpt.wpe
            self.drop = gpt.drop
        self.blocks = nn.ModuleList(gpt.blocks[i]
                                    for i in range(self.start, self.stop))
        if self.is_last:
            self.ln_f = gpt.ln_f
            if not cfg.tie_embeddings:
                self.lm_head = gpt.lm_head
            elif not self.is_first:
                self.head_wte = gpt.wte
        self.eval()

    def _head(self, x):
        if not self.cfg.tie_embeddings:
            return self.lm_head(x)
        w = self.wte.weight if self.is_first else self.head_wte.weight
        return F.linear(x, w)

    def forward(self, x, cache=None, pos=None, tables=None, valid=None,
                op="block", adapters=None):
        if op == "head":
            return self._head(self.ln_f(x))
        if self.is_first:
            ids = x.to(torch.int64)
            positions = cached_positions(pos, ids.shape[1],
                                         self.cfg.max_position_embeddings)
            x = self.drop(self.wte(ids) + self.wpe(positions))
        new_layers = []
        for i, (blk, lkv) in enumerate(zip(self.blocks, cache.layers)):
            # `adapters["layers"]` is this stage's slice of the bank
            lv = None if adapters is None else \
                {"slot": adapters["slot"], **adapters["layers"][i]}
            x, new_lkv = blk(x, cache=lkv, pos=pos, tables=tables,
                             valid=valid, adapters=lv)
            new_layers.append(new_lkv)
            _numerics.tap_layer(self.start + i, "act", x)
        if op == "block_head":
            return self._head(self.ln_f(x)), tuple(new_layers)
        return x, tuple(new_layers)


def gpt_stage_ranges(num_layers, pp, stage_layers=None):
    """Contiguous [start, stop) block ranges of `pp` stages: the uniform
    split (the first `num_layers % pp` stages take one block more), or
    `stage_layers`, explicit per-stage block counts summing to
    num_layers."""
    pp = int(pp)
    if stage_layers is not None:
        counts = [int(c) for c in stage_layers]
        if len(counts) != pp or sum(counts) != num_layers \
                or min(counts) < 1:
            raise ValueError(
                f"stage_layers {counts} must be {pp} positive counts "
                f"summing to {num_layers}")
    else:
        if not 1 <= pp <= num_layers:
            raise ValueError(f"pp={pp} must be in 1..num_layers="
                             f"{num_layers}")
        base, rem = divmod(num_layers, pp)
        counts = [base + (1 if s < rem else 0) for s in range(pp)]
    ranges, at = [], 0
    for c in counts:
        ranges.append((at, at + c))
        at += c
    return ranges


def gpt_pipeline_stages(model, pp, stage_layers=None):
    """`model` (a GPT) as `pp` GPTStage modules sharing its submodules."""
    return [GPTStage(model, a, b)
            for a, b in gpt_stage_ranges(model.cfg.num_layers, pp,
                                         stage_layers)]


class GPTForGeneration(nn.Module):
    """Autoregressive decoding over a GPT. `use_cache=True` prefills the
    prompt's K/V into a dense cache once, then runs one single-token
    forward a step; `use_cache=False` recomputes the whole forward a token
    (the parity oracle)."""

    def __init__(self, gpt: GPT):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids, **kwargs):
        return self.generate(input_ids, **kwargs)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=20, decode_strategy="greedy",
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 use_cache=True, max_cache_len=None, generator=None):
        """input_ids [B, S] -> (generated ids [B, max_new_tokens] int32,
        lengths [B] int32), on the CPU. Rows that hit eos are padded with
        eos; lengths count tokens up to and including it. Stops early once
        every row is done. Sampling draws from `generator`, a
        torch.Generator on the model's device."""
        B, S = input_ids.shape
        limit = max_cache_len or S + max_new_tokens
        if S + max_new_tokens > limit or \
                S + max_new_tokens > self.gpt.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_position_embeddings="
                f"{self.gpt.cfg.max_position_embeddings}"
                + (f" / max_cache_len={max_cache_len}" if max_cache_len
                   else ""))

        def select(logits):
            return _sampling.select_tokens(
                logits, generator=generator, strategy=decode_strategy,
                temperature=temperature, top_k=top_k, top_p=top_p)
        ids = torch.as_tensor(input_ids).to(self.gpt.device, torch.int64)
        if use_cache:
            cache = self.gpt.gen_cache(B, limit)
            logits, cache = self.gpt(ids, cache=cache)
        else:
            logits = self.gpt(ids)
        nxt = select(logits[:, -1])
        picked = []
        done = torch.zeros((B,), dtype=torch.bool)
        for _ in range(max_new_tokens):
            step = nxt.cpu()
            if eos_token_id is not None:
                step = torch.where(done, torch.tensor(eos_token_id,
                                                      dtype=step.dtype),
                                   step)
                done |= step == eos_token_id
            picked.append(step)
            if len(picked) == max_new_tokens or \
                    (eos_token_id is not None and bool(done.all())):
                break
            tok = step.to(self.gpt.device, torch.int64)[:, None]
            if use_cache:
                logits, cache = self.gpt(tok, cache=cache)
                nxt = select(logits[:, 0])
            else:
                ids = torch.cat([ids, tok], dim=1)
                nxt = select(self.gpt(ids)[:, -1])
        out = torch.stack(picked, dim=1).to(torch.int32)
        if eos_token_id is None:
            lengths = torch.full((B,), out.shape[1], dtype=torch.int32)
        else:
            hit = out == eos_token_id
            first = torch.where(hit.any(1), hit.to(torch.int32).argmax(1) + 1,
                                torch.full((B,), out.shape[1]))
            lengths = first.to(torch.int32)
        return out, lengths


def gpt_tiny(device="cuda", seed=0, **kw):
    return GPT(GPTConfig(hidden_size=128, num_layers=2, num_heads=4,
                         max_position_embeddings=256, vocab_size=1024, **kw),
               device=device, seed=seed)


def gpt_125m(device="cuda", seed=0, **kw):
    """GPT-125M at full width: hidden 768, 12 layers, 12 heads, vocab
    50304, 1024 positions, tied head."""
    return GPT(GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw),
               device=device, seed=seed)


def gpt_350m(device="cuda", seed=0, **kw):
    """GPT-350M: hidden 1024, 24 layers, 16 heads (head dim 64)."""
    return GPT(GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw),
               device=device, seed=seed)


def gpt_1p3b(device="cuda", seed=0, **kw):
    """GPT-1.3B: hidden 2048, 24 layers, 16 heads (head dim 128), 2048
    positions."""
    return GPT(GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_position_embeddings=2048, **kw),
               device=device, seed=seed)


def gpt_6p7b(device="cuda", seed=0, **kw):
    """GPT-6.7B: hidden 4096, 32 layers, 32 heads (head dim 128), 2048
    positions."""
    return GPT(GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                         max_position_embeddings=2048, **kw),
               device=device, seed=seed)
