"""The single-device GPT training step: the port of
`paddle_tpu/parallel/gpt_spmd.py` under the plan `MeshPlan()`.

The JAX module shard_maps one jit-compiled step over a mesh of
(dp, pp, sharding, sp, mp). This slice ports the one-device plan, every
axis 1: embedding, pre-LN blocks (head-major qkv, causal flash attention,
tanh-GELU MLP) over stacked layer weights, the tied LM head with softmax
cross-entropy (unfused, or chunked by `ops/fused_ce.py`), a global-norm
clip, and AdamW with f32 master weights (the ZeRO-2 update at
sharding=1). The names, leaves, defaults and numerics are the JAX
module's, so its weights and optimizer state carry over (`convert.py`).
Plans with any axis above 1 wait for the multi-GPU slice (ROADMAP A.10).

Where the two differ:
  * PyTorch runs eagerly: the layer `lax.scan` is a Python loop over the
    stacked index (`scan_unroll` is accepted and has nothing to unroll),
    and `remat` False/True is none or one `torch.utils.checkpoint` per
    block. The policies "dots" and "dots+attn" are not ported yet.
  * JAX donates the step's buffers; here the step updates the parameter
    and optimizer-state tensors in place under `torch.no_grad()` and
    returns the same dictionaries.
  * The escape hatch `PADDLE_TPU_DISABLE_PALLAS_FLASH=1` of the JAX
    package is the keyword `attention="plain"`: dense attention with
    autograd (`reference_attention_bhsd`) instead of the kernels.
  * f32 policy: `make_train_step` turns TF32 off for the process, so f32
    products are full f32 on the card as on the CPU (the parity runs);
    bf16 steps do not depend on it.
  * The step's three parts run under the spans `train::forward`,
    `train::backward` and `train::optimizer` (the Profiler's Forward,
    Backward and Optimization phases; the device profile's modules).
"""
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..ops.flash_attention import (flash_attention_bhsd,
                                   reference_attention_bhsd)
from ..ops.fused_ce import fused_linear_cross_entropy, matmul_f32
from ..profiler import RecordEvent, TracerEventType

__all__ = ["GPTSpmdConfig", "MeshPlan", "init_gpt_params",
           "init_opt_state_leaf", "make_train_step", "make_forward_fn",
           "param_shapes"]

_BLOCK_LEAVES = ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                 "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class GPTSpmdConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = None
    param_dtype: str = "float32"     # storage dtype ("bfloat16" for bench)
    compute_dtype: str = "float32"   # activation dtype
    # remat: False = none, True = one checkpoint per block; "dots" and
    # "dots+attn" (the JAX policies) are not ported yet
    remat: object = True
    init_std: float = 0.02
    scan_unroll: int = 1             # no scan here; validated only
    # >1: the chunked fused linear-CE LM head (ops/fused_ce.py); must
    # divide vocab_size
    fused_ce_chunks: int = 0

    def __post_init__(self):
        if self.ffn is None:
            self.ffn = 4 * self.hidden
        if int(self.scan_unroll) < 1:
            raise ValueError(
                f"scan_unroll must be >= 1, got {self.scan_unroll}")
        if int(self.fused_ce_chunks) > 1 and \
                self.vocab_size % int(self.fused_ce_chunks):
            raise ValueError(
                f"fused_ce_chunks {self.fused_ce_chunks} must divide "
                f"vocab_size {self.vocab_size}")


@dataclass
class MeshPlan:
    """The JAX plan's fields. Only the one-device plan is ported: any axis
    above 1 (or vpp above 1) raises."""
    dp: int = 1
    pp: int = 1
    sharding: int = 1
    sp: int = 1
    mp: int = 1
    microbatches: int = 1
    schedule: str = "1f1b"
    vpp: int = 1
    sp_mode: str = "ring"

    def __post_init__(self):
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown sp_mode {self.sp_mode!r}; use 'ring' or 'ulysses'")
        big = {a: d for a, d in self.dims.items() if d != 1}
        if self.vpp != 1:
            big["vpp"] = self.vpp
        if big:
            raise NotImplementedError(
                f"MeshPlan {big}: only the single-device plan is ported; "
                "multi-GPU plans are ROADMAP item A.10")

    @property
    def dims(self):
        return {"dp": self.dp, "pp": self.pp, "sharding": self.sharding,
                "sp": self.sp, "mp": self.mp}


# ---------------------------------------------------------------------------
# Parameters and optimizer state
# ---------------------------------------------------------------------------

def param_shapes(cfg: GPTSpmdConfig):
    """{leaf name: shape}: the JAX pytree's leaves, stacked over layers,
    matrices stored [in, out] for `x @ W`."""
    L, H, Fd, V = cfg.layers, cfg.hidden, cfg.ffn, cfg.vocab_size
    return {"wte": (V, H), "wpe": (cfg.max_seq_len, H),
            "ln1_w": (L, H), "ln1_b": (L, H),
            "w_qkv": (L, H, 3 * H), "b_qkv": (L, 3 * H),
            "w_proj": (L, H, H), "b_proj": (L, H),
            "ln2_w": (L, H), "ln2_b": (L, H),
            "w_fc1": (L, H, Fd), "b_fc1": (L, Fd),
            "w_fc2": (L, Fd, H), "b_fc2": (L, H),
            "lnf_w": (H,), "lnf_b": (H,)}


def init_gpt_params(cfg: GPTSpmdConfig, generator, device="cuda"):
    """The JAX initialisation: normal(0, init_std) weights, the two
    residual projections at init_std / sqrt(2 * layers) (GPT-2), LayerNorm
    ones/zeros, zero biases. Draws in f32 with `generator` (on its own
    device), in the JAX key order, then casts to `param_dtype` on
    `device`. The JAX package's numbers are not reproduced: carry its
    weights with `convert.params_from_jax` to compare."""
    dev = resolve_device(device)
    dt = _DTYPES[cfg.param_dtype]
    shapes = param_shapes(cfg)
    std = cfg.init_std
    proj_std = std / math.sqrt(2 * cfg.layers)
    gdev = generator.device

    def nrm(name, s):
        x = torch.randn(shapes[name], generator=generator, device=gdev)
        return (x * s).to(dev, dt)
    drawn = {"wte": nrm("wte", std), "wpe": nrm("wpe", std),
             "w_qkv": nrm("w_qkv", std), "w_proj": nrm("w_proj", proj_std),
             "w_fc1": nrm("w_fc1", std), "w_fc2": nrm("w_fc2", proj_std)}
    out = {}
    for name, shape in shapes.items():
        if name in drawn:
            out[name] = drawn[name]
        elif name.endswith("_w"):
            out[name] = torch.ones(shape, dtype=dt, device=dev)
        else:
            out[name] = torch.zeros(shape, dtype=dt, device=dev)
    return out


def init_opt_state_leaf(p):
    """AdamW state of one leaf at sharding=1: flat f32 m, v and master
    (the master adopts the parameter on the first step) and the step count
    t (int32)."""
    n = p.numel()
    return {"m": torch.zeros(n, dtype=torch.float32, device=p.device),
            "v": torch.zeros(n, dtype=torch.float32, device=p.device),
            "master": torch.zeros(n, dtype=torch.float32, device=p.device),
            "t": torch.zeros((), dtype=torch.int32, device=p.device)}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _ln(x, w, b, eps=1e-5):
    """LayerNorm with f32 statistics, cast back before `* w + b`."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _attention(h, blk, cfg, attend):
    B, S, _ = h.shape
    d = cfg.hidden // cfg.heads
    # w_qkv columns are head-major [h0:(q|k|v), h1:(q|k|v), ...]
    qkv = h @ blk["w_qkv"] + blk["b_qkv"]                 # (B,S,3H)
    qkv = qkv.reshape(B, S, cfg.heads, 3, d)
    q = qkv[:, :, :, 0].movedim(2, 1)                     # (B,heads,S,d)
    k = qkv[:, :, :, 1].movedim(2, 1)
    v = qkv[:, :, :, 2].movedim(2, 1)
    o = attend(q, k, v, causal=True)
    o = o.movedim(1, 2).reshape(B, S, cfg.hidden)
    return o @ blk["w_proj"] + blk["b_proj"]


def _mlp(h, blk):
    u = h @ blk["w_fc1"] + blk["b_fc1"]
    u = F.gelu(u, approximate="tanh")
    return u @ blk["w_fc2"] + blk["b_fc2"]


def _block(h, blk, cfg, attend):
    h = h + _attention(_ln(h, blk["ln1_w"], blk["ln1_b"]), blk, cfg, attend)
    h = h + _mlp(_ln(h, blk["ln2_w"], blk["ln2_b"]), blk)
    return h


def _stage_blocks(h, params, cfg, attend):
    """The layer stack: a loop over the stacked index. `unbind` hands each
    layer a view whose gradients stack back in one piece."""
    layers = {k: params[k].unbind(0) for k in _BLOCK_LEAVES}
    for i in range(cfg.layers):
        blk = {k: layers[k][i] for k in _BLOCK_LEAVES}
        if cfg.remat:
            h = checkpoint(_block, h, blk, cfg, attend, use_reentrant=False)
        else:
            h = _block(h, blk, cfg, attend)
    return h


def _embed(tokens, params, cfg):
    emb = params["wte"][tokens.long()]
    emb = emb + params["wpe"][:tokens.shape[-1]]
    return emb.to(_DTYPES[cfg.compute_dtype])


class _LogitsMatmul(torch.autograd.Function):
    """(B,S,H) x (V,H) -> f32 logits, with the cotangent cast to the
    operand dtype before the two backward products, as the JAX
    `_logits_matmul` does (bf16 rate for the model's largest products,
    f32 accumulation)."""

    @staticmethod
    def forward(ctx, h, wte):
        ctx.save_for_backward(h, wte)
        B, S, H = h.shape
        return matmul_f32(h.reshape(B * S, H), wte.t()).reshape(B, S, -1)

    @staticmethod
    def backward(ctx, g):
        h, wte = ctx.saved_tensors
        B, S, H = h.shape
        gl = g.reshape(B * S, -1).to(h.dtype)
        dh = matmul_f32(gl, wte).to(h.dtype).reshape(B, S, H)
        dw = matmul_f32(gl.t(), h.reshape(B * S, H)).to(wte.dtype)
        return dh, dw


def _lm_loss(h, labels, params, cfg):
    """Tied-embedding LM head + softmax CE (the JAX `_vocab_parallel_loss`
    at mp=1). Returns the mean NLL."""
    h = _ln(h, params["lnf_w"], params["lnf_b"])
    wte = params["wte"]
    if cfg.fused_ce_chunks > 1:
        B, S, H = h.shape
        nll = fused_linear_cross_entropy(h.reshape(B * S, H), wte,
                                         labels.reshape(B * S),
                                         cfg.fused_ce_chunks)
        return nll.mean()
    logits = _LogitsMatmul.apply(h, wte)
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    logz = torch.log(torch.exp(shifted).sum(-1))
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - picked).mean()


def _attend_fn(attention):
    if attention == "kernel":
        return flash_attention_bhsd
    if attention == "plain":
        return reference_attention_bhsd
    raise ValueError(f"attention must be 'kernel' or 'plain', got "
                     f"{attention!r}")


def _check_remat(cfg):
    if cfg.remat in ("dots", "dots+attn"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (ROADMAP A.3); use "
            "False or True")
    if cfg.remat not in (False, True):
        raise ValueError(f"unknown remat {cfg.remat!r}")


def _loss(params, tokens, labels, cfg, attend):
    h = _embed(tokens, params, cfg)
    h = _stage_blocks(h, params, cfg, attend)
    return _lm_loss(h, labels, params, cfg)


# ---------------------------------------------------------------------------
# AdamW with f32 master weights (ZeRO-2 at sharding=1)
# ---------------------------------------------------------------------------

def _adamw_update_(p, g, st, lr, clip, wd=0.1, b1=0.9, b2=0.95, eps=1e-8):
    """One AdamW step of leaf p in place. g is p's gradient, clip the
    global-norm scale (f32, applied to g in f32 as the JAX step does)."""
    gf = g.reshape(-1).float() * clip
    st["master"].copy_(torch.where(st["t"] == 0, p.reshape(-1).float(),
                                   st["master"]))
    st["t"].add_(1)
    t = st["t"].float()
    st["m"].mul_(b1).add_((1 - b1) * gf)
    st["v"].mul_(b2).add_((1 - b2) * gf * gf)
    mhat = st["m"] / (1 - b1 ** t)
    vhat = st["v"] / (1 - b2 ** t)
    master = st["master"]
    master.mul_(1 - lr * wd)
    master.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    p.copy_(master.view(p.shape))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: GPTSpmdConfig, plan: MeshPlan = None,
                    learning_rate=3e-4, weight_decay=0.1, grad_clip=1.0,
                    device="cuda", attention="kernel"):
    """Returns (step_fn, init_fn).

    step_fn(params, opt_state, tokens, labels, lr=None) -> (loss, params,
    opt_state): one AdamW step on the batch (tokens/labels int (B, S)), lr
    defaulting to `learning_rate`. The parameter and state tensors are
    updated in place and returned. init_fn(seed=0) -> (params, opt_state)
    draws the parameters with a generator seeded `seed`.

    attention="kernel" runs the flash-attention kernels (their plain
    versions on CPU tensors); "plain" runs dense attention with autograd.
    `plan` is accepted for the JAX signature: a MeshPlan other than the
    one-device plan raises when it is built."""
    dev = resolve_device(device)
    attend = _attend_fn(attention)
    _check_remat(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step_fn(params, opt_state, tokens, labels, lr=None):
        lr_t = torch.tensor(learning_rate if lr is None else lr,
                            dtype=torch.float32, device=dev)
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            with RecordEvent("train::forward", TracerEventType.Forward):
                loss = _loss(params, tokens.to(dev), labels.to(dev), cfg,
                             attend)
            with RecordEvent("train::backward", TracerEventType.Backward):
                loss.backward()
        with torch.no_grad(), RecordEvent("train::optimizer",
                                          TracerEventType.Optimization):
            clip = torch.ones((), device=dev)
            if grad_clip:
                sq = sum((p.grad.float() ** 2).sum() for p in params.values())
                gnorm = torch.sqrt(sq)
                clip = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-6),
                                   max=1.0)
            for name, p in params.items():
                _adamw_update_(p, p.grad, opt_state[name], lr_t, clip,
                               wd=weight_decay)
                p.grad = None
        return loss.detach(), params, opt_state

    def init_fn(seed=0):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = init_gpt_params(cfg, gen, dev)
        return params, {k: init_opt_state_leaf(p) for k, p in params.items()}

    return step_fn, init_fn


def make_forward_fn(cfg: GPTSpmdConfig, device="cuda", attention="kernel"):
    """Single-device forward: fwd(params, tokens) -> f32 logits (B, S, V)."""
    dev = resolve_device(device)
    attend = _attend_fn(attention)
    _check_remat(cfg)

    def fwd(params, tokens):
        h = _embed(tokens.to(dev), params, cfg)
        h = _stage_blocks(h, params, cfg, attend)
        h = _ln(h, params["lnf_w"], params["lnf_b"])
        return torch.matmul(h.float(), params["wte"].float().t())
    return fwd
