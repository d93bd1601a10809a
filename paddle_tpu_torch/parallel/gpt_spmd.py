"""The GPT training step: the port of `paddle_tpu/parallel/gpt_spmd.py`.

The JAX module shard_maps one jit-compiled step over a mesh of
(dp, pp, sharding, sp, mp): data parallelism, the GPipe / 1F1B /
interleaved pipeline, ZeRO-2 sharded AdamW, ring or Ulysses sequence
parallelism and Megatron tensor parallelism, each a few explicit
collectives inside one rank's body. Here one controller drives every rank
(`collectives.RankGrid`): each rank holds its own tensors (the JAX local
shards) on its own device, the ranks run in lockstep, and the collectives
are written out (`collectives.py`). The names, leaves, defaults and
numerics are the JAX module's, so its weights and optimizer state carry
over (`convert.py`) and its checkpoints load (`distributed/checkpoint.py`).

Layout. A rank's coordinates follow `AXES` as `MeshPlan.build_mesh`
reshapes devices; rank r lives on `devices[r]` (default: `device` for
every rank). Under a plan of one rank a leaf is a tensor, as the
single-device step always took it; under any other plan a leaf is a list
with one tensor a rank, of the JAX local shard's shape
(`param_specs`), and a leaf's optimizer state is a list of per-rank
dicts laid out as the JAX `state_spec` (the pp/mp axes that shard the
leaf, then `sharding`). `gather_params` / `gather_opt_state` return the
logical arrays. Matrices are stored [in, out] and `w_qkv` is head-major,
so an mp cut of its last dimension is whole heads.

Gradients. Every rank computes its own loss and the step
back-propagates their sum. The JAX step's two custom VJPs are ported
literally (`collectives.axis_psum`, `collectives.mp_copy`), and the other
collectives are plain differentiable ops whose autograd is the JAX
transpose, so each rank gets exactly its JAX gradient. Then, in the JAX
order: pmean over (dp, sp, sharding) of gradients and loss, psum over pp
of the pp-replicated leaves (wte, wpe, lnf_*), the global-norm clip
(`_global_grad_sq`: a leaf's square sum psummed only over the mp/pp axes
that shard it), and the ZeRO-2 AdamW update (reduce-scatter over
`sharding`, the f32 master adopting the parameter at t == 0, all-gather).

Attention. Without sp the flash kernels run at `heads / mp` heads a
rank; sp="ulysses" runs them at full length on `heads / (mp * sp)`
heads. The sp ring (`ring_attention.py`) and, under pp x sp, the
all-gather route (`S / sp` queries over the gathered keys) are plain
PyTorch in the reference too: the JAX dispatch never sends cross-length
attention to Pallas, so the all-gather route calls
`reference_attention_bhsd`, and the flash wrapper keeps refusing
cross-length input.

Where the two differ:
  * PyTorch runs eagerly: the layer `lax.scan` is a Python loop over the
    stacked index (`scan_unroll` is accepted and has nothing to unroll),
    and remat is `torch.utils.checkpoint` a block: True recomputes the
    whole block; "dots" is a selective policy that saves the matmul
    outputs (`aten.mm` / `addmm`: the products without batch dims) and
    recomputes the rest; "dots+attn" also keeps the flash output, by
    running the attention between two checkpointed halves of the block
    (the flash Function then keeps its own inputs, output and lse).
  * The GPipe schedule runs its M + pp - 1 ticks eagerly, a stage only
    where its microbatch is valid (the JAX scan computes masked garbage
    there), and autograd through the ticks is the reverse schedule. The
    1F1B / eager-1F1B / interleaved schedules walk the tick tables of
    `pipeline_schedule.py`: stage inputs parked in circular buffers of
    `required_slots` entries, the forward under `no_grad`, the backward a
    recompute from the parked input under `enable_grad` with
    `torch.autograd.grad`; a slot is emptied by its backward, and parking
    over a live slot raises.
  * JAX donates the step's buffers; here the step updates the parameter
    and optimizer-state tensors in place under `torch.no_grad()` and
    returns the same containers.
  * The escape hatch `PADDLE_TPU_DISABLE_PALLAS_FLASH=1` of the JAX
    package is the keyword `attention="plain"`: dense attention with
    autograd (`reference_attention_bhsd`) instead of the kernels.
  * f32 policy: `make_train_step` turns TF32 off for the process, so f32
    products are full f32 on the card as on the CPU (the parity runs);
    bf16 steps do not depend on it.
  * Spans: `train::forward`, `train::backward` and `train::optimizer`
    (the Profiler's Forward, Backward and Optimization phases; the device
    profile's modules). On the 1F1B paths forward and backward interleave
    inside the ticks: each stage forward of a microbatch runs under
    `train::forward`, each backward (its recompute included) under
    `train::backward`.
  * Multi-process training (the JAX `_put_global` multi-controller path)
    is several controllers, each driving its block of ranks
    (`make_train_step`'s docstring); one controller drives every rank
    without a process group. The gradient mean over the data axes runs
    one axis at a time (dp, sp, sharding), where the JAX step psums over
    the axes at once.
"""
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..ops.flash_attention import (flash_attention_bhsd,
                                   reference_attention_bhsd)
from ..ops.fused_ce import fused_linear_cross_entropy, matmul_f32
from ..profiler import RecordEvent, TracerEventType
from . import collectives as C
from .collectives import AXES, RankGrid
from .pipeline_schedule import (arrival_tables, build_interleaved_tables,
                                build_tables, required_slots)
from .ring_attention import ring_attention, ulysses_attention

__all__ = ["AXES", "GPTSpmdConfig", "MeshPlan", "init_gpt_params",
           "init_opt_state_leaf", "make_train_step", "make_forward_fn",
           "param_shapes", "param_specs", "state_specs",
           "interleave_permutation", "gather_params", "gather_opt_state",
           "shard_leaf"]

_BLOCK_LEAVES = ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                 "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SCHEDULES = ("1f1b", "eager1f1b", "gpipe")
_REMAT = (False, True, "dots", "dots+attn")


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
    # remat: False = none, True = one checkpoint per block, "dots" = keep
    # the matmul outputs and recompute the rest, "dots+attn" = dots and
    # the flash attention output
    remat: object = True
    init_std: float = 0.02
    scan_unroll: int = 1             # no scan here; validated only
    # >1: the chunked fused linear-CE LM head (ops/fused_ce.py); must
    # divide vocab_size (and, under mp, the local vocab shard)
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
    """The JAX plan: axis sizes, pipeline microbatches and schedule
    ("1f1b", "eager1f1b" or "gpipe"), interleaved virtual stages `vpp`,
    and the sequence-parallel flavor `sp_mode` ("ring" or "ulysses")."""
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

    @property
    def dims(self):
        return {"dp": self.dp, "pp": self.pp, "sharding": self.sharding,
                "sp": self.sp, "mp": self.mp}

    @property
    def n_devices(self):
        return self.dp * self.pp * self.sharding * self.sp * self.mp


# ---------------------------------------------------------------------------
# Parameters, specs and optimizer state
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


def param_specs(cfg: GPTSpmdConfig = None):
    """The JAX PartitionSpec of each leaf, as a tuple a dimension: pp on
    the stacked-layer dim, mp Megatron-style (vocab-parallel wte, column
    qkv / fc1, row proj / fc2)."""
    return {"wte": ("mp", None), "wpe": (),
            "ln1_w": ("pp", None), "ln1_b": ("pp", None),
            "w_qkv": ("pp", None, "mp"), "b_qkv": ("pp", "mp"),
            "w_proj": ("pp", "mp", None), "b_proj": ("pp", None),
            "ln2_w": ("pp", None), "ln2_b": ("pp", None),
            "w_fc1": ("pp", None, "mp"), "b_fc1": ("pp", "mp"),
            "w_fc2": ("pp", "mp", None), "b_fc2": ("pp", None),
            "lnf_w": (), "lnf_b": ()}


def state_specs(cfg: GPTSpmdConfig = None):
    """The JAX `state_spec`: m / v / master are 1-D, their global dim 0
    sharded over the pp/mp axes that shard the leaf, then `sharding`
    (flattened in that order); t is replicated."""
    out = {}
    for name, spec in param_specs(cfg).items():
        axes = tuple(a for a in spec if a in ("pp", "mp"))
        v = (axes + ("sharding",),)
        out[name] = {"m": v, "v": v, "master": v, "t": ()}
    return out


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


def interleave_permutation(L, pp, vpp):
    """Stacked-layer storage order for interleaved pipelining: device s's
    contiguous local shard holds its vpp chunks back to back, chunk c of
    device s being virtual stage k = c*pp + s (logical layers
    [k*L/D, (k+1)*L/D), D = pp*vpp). perm[new_pos] = logical_layer. A
    storage layout only: the computed function is the unpermuted model's
    (checkpoints written under vpp > 1 store this layout)."""
    D = pp * vpp
    Lk = L // D
    perm = []
    for s in range(pp):
        for c in range(vpp):
            k = c * pp + s
            perm.extend(range(k * Lk, (k + 1) * Lk))
    return np.asarray(perm)


def init_opt_state_leaf(p, plan=None):
    """AdamW state of one (local) leaf: flat f32 m, v and master of
    ceil(size / sharding) elements (the master adopts the parameter on the
    first step) and the step count t (int32)."""
    n = 1 if plan is None else plan.sharding
    shard = -(-p.numel() // n)
    return {"m": torch.zeros(shard, dtype=torch.float32, device=p.device),
            "v": torch.zeros(shard, dtype=torch.float32, device=p.device),
            "master": torch.zeros(shard, dtype=torch.float32,
                                  device=p.device),
            "t": torch.zeros((), dtype=torch.int32, device=p.device)}


def _spec_axes(part):
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _window(shape, spec, grid, rank):
    """Rank `rank`'s slices of a global array of `shape` under `spec`."""
    out = []
    for d, size in enumerate(shape):
        axes = _spec_axes(spec[d] if d < len(spec) else None)
        n = math.prod(grid.dims[a] for a in axes)
        if size % n:
            raise ValueError(f"dimension {d} of size {size} does not split "
                             f"{n} ways over {axes}")
        k = size // n
        i = grid.flat_index(rank, axes)
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def _global_shape(local_shape, spec, grid):
    return tuple(s * math.prod(grid.dims[a] for a in _spec_axes(
        spec[d] if d < len(spec) else None))
        for d, s in enumerate(local_shape))


def shard_leaf(x, spec, grid):
    """A global tensor -> one piece a rank this process drives
    (`grid.local_ranks`; `spec`), each a fresh contiguous copy on its
    rank's device."""
    out = []
    for r in grid.local_ranks:
        dev = grid.devices[r]
        piece = x[_window(tuple(x.shape), spec, grid, r)]
        out.append(torch.empty(piece.shape, dtype=x.dtype, device=dev)
                   .copy_(piece))
    return out


def _host(t):
    """A numpy copy (bf16 as its exact f32 values) that later in-place
    updates of `t` leave alone."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def _gather_leaf(pieces, spec, grid):
    """One piece a rank -> the global numpy array (the first rank of each
    window supplies it)."""
    shape = _global_shape(tuple(pieces[0].shape), spec, grid)
    first = _host(pieces[0])
    full = np.zeros(shape, dtype=first.dtype)
    seen = set()
    for r, t in enumerate(pieces):
        win = _window(shape, spec, grid, r)
        key = tuple((s.start, s.stop) for s in win)
        if key not in seen:
            seen.add(key)
            full[win] = first if r == 0 else _host(t)
    return full


def _grid_of(plan):
    plan = plan or MeshPlan()
    return RankGrid(plan.dims, [torch.device("cpu")] * plan.n_devices)


def _ranks(leaf):
    """A leaf as its list of pieces (a one-rank plan's leaf is the tensor
    or state dict itself)."""
    return leaf if isinstance(leaf, (list, tuple)) else [leaf]


def gather_params(params, plan=None):
    """{leaf: global numpy array} (bf16 as its exact f32 values), in the
    storage order (vpp > 1: `interleave_permutation`'s)."""
    grid, specs = _grid_of(plan), param_specs()
    return {k: _gather_leaf(_ranks(v), specs[k], grid)
            for k, v in params.items()}


def gather_opt_state(state, plan=None):
    """{leaf: {"m", "v", "master": the JAX global state arrays, "t": the
    step count}} as numpy."""
    grid, specs = _grid_of(plan), state_specs()
    out = {}
    for k, v in state.items():
        sts = _ranks(v)
        out[k] = {n: _gather_leaf([st[n] for st in sts], specs[k][n], grid)
                  for n in ("m", "v", "master")}
        out[k]["t"] = _host(sts[0]["t"])
    return out


# ---------------------------------------------------------------------------
# Forward pieces (lists with one value a rank of `ranks`)
# ---------------------------------------------------------------------------

def _ln(x, w, b, eps=1e-5):
    """LayerNorm with f32 statistics, cast back before `* w + b`."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


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


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The JAX `dots_with_no_batch_dims_saveable`: keep the 2-D products,
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _attend_fn(attention):
    if attention == "kernel":
        return flash_attention_bhsd
    if attention == "plain":
        return reference_attention_bhsd
    raise ValueError(f"attention must be 'kernel' or 'plain', got "
                     f"{attention!r}")


class _Program:
    """One rank's JAX body, run for a list of ranks in lockstep.

    `ranks` names the ranks a call runs (every rank, or one pipeline
    stage's); a collective over an axis runs on each group of that axis
    among them."""

    def __init__(self, cfg, plan, grid, attend):
        self.cfg, self.plan, self.grid, self.attend = cfg, plan, grid, attend
        self.cdt = _DTYPES[cfg.compute_dtype]
        # GPipe across processes: the sends' roots that join the step's
        # backward, and the backward's sends still in flight
        self.roots, self.pending = [], []

    def mp_copy(self, ranks, xs):
        return self.grid.over(ranks, "mp", C.mp_copy, xs)

    def psum_mp(self, ranks, xs):
        return self.grid.over(ranks, "mp", C.axis_psum, xs)

    # -- embedding ---------------------------------------------------------
    def embed(self, ranks, toks, eps):
        """Vocab-parallel lookup (masked per mp rank, psummed) plus the
        position rows of this sp rank's sequence block."""
        mp, sp = self.plan.mp, self.plan.sp
        embs = []
        for r, tok, ep in zip(ranks, toks, eps):
            wte = ep["wte"]
            if mp > 1:
                per = wte.shape[0]
                ids = tok.long() - C.axis_index(self.grid, r, "mp") * per
                ok = (ids >= 0) & (ids < per)
                emb = torch.where(ok[..., None],
                                  wte[ids.clamp(0, per - 1)], 0)
            else:
                emb = wte[tok.long()]
            embs.append(emb)
        if mp > 1:
            embs = self.psum_mp(ranks, embs)
        out = []
        for r, tok, ep, emb in zip(ranks, toks, eps, embs):
            S_loc = tok.shape[-1]
            pos0 = C.axis_index(self.grid, r, "sp") * S_loc if sp > 1 else 0
            emb = emb + ep["wpe"][pos0:pos0 + S_loc]
            out.append(emb.to(self.cdt))
        return out

    # -- attention ---------------------------------------------------------
    def pre_attn(self, ranks, hs, blks):
        """ln1, the mp input marker and the qkv product -> q, k, v
        (B, heads/mp, S_loc, d) a rank."""
        cfg = self.cfg
        heads_loc = cfg.heads // self.plan.mp
        d = cfg.hidden // cfg.heads
        xs = [_ln(h, b["ln1_w"], b["ln1_b"]) for h, b in zip(hs, blks)]
        xs = self.mp_copy(ranks, xs)
        qs, ks, vs = [], [], []
        for x, blk in zip(xs, blks):
            B, S, _ = x.shape
            # w_qkv columns are head-major [h0:(q|k|v), h1:(q|k|v), ...]
            qkv = x @ blk["w_qkv"] + blk["b_qkv"]        # (B,S,3H/mp)
            qkv = qkv.reshape(B, S, heads_loc, 3, d)
            qs.append(qkv[:, :, :, 0].movedim(2, 1))      # (B,h_loc,S,d)
            ks.append(qkv[:, :, :, 1].movedim(2, 1))
            vs.append(qkv[:, :, :, 2].movedim(2, 1))
        return qs, ks, vs

    def attend_sp(self, ranks, qs, ks, vs):
        """Causal attention of each rank's queries, by the plan's route."""
        plan, grid = self.plan, self.grid
        if plan.sp == 1:
            return [self.attend(q, k, v, causal=True)
                    for q, k, v in zip(qs, ks, vs)]
        across = grid.nproc > 1 and any(
            grid.process_of(r) != grid.proc
            for r in grid.whole_groups(ranks[:1], ("sp",))[0])
        if across and plan.sp_mode == "ulysses":
            # one all-to-all over the sp processes each way
            return ulysses_attention(
                qs, ks, vs, causal=True, size=plan.sp,
                attn_fn=lambda q, k, v: self.attend(q, k, v, causal=True),
                exchange=lambda xs, a, b: C.all_to_all_over(
                    grid, ranks, "sp", xs, a, b))
        if across and plan.pp == 1:
            # the K/V blocks go round the ring by send / recv
            return ring_attention(
                qs, ks, vs, causal=True, size=plan.sp,
                index=[grid.coords[r]["sp"] for r in ranks],
                shift=lambda xs: C.shift_over(grid, ranks, "sp", xs))
        if plan.sp_mode == "ulysses":
            def fn(g):
                return ulysses_attention(
                    *map(list, zip(*g)), causal=True,
                    attn_fn=lambda q, k, v: self.attend(q, k, v,
                                                        causal=True))
        elif plan.pp > 1:
            # the JAX pp x sp route: a ppermute ring inside the stage-gated
            # tick body would deadlock the mesh, so K/V are all-gathered
            fn = _allgather_sp_attention
        else:
            def fn(g):
                return ring_attention(*map(list, zip(*g)), causal=True)
        return self.grid.over(ranks, "sp", fn, list(zip(qs, ks, vs)))

    def post_attn(self, ranks, hs, os, blks):
        """The attention's output projection (mp partials psummed) and
        residual, then the MLP block and its residual."""
        parts = []
        for h, o, blk in zip(hs, os, blks):
            B, S, _ = h.shape
            o = o.movedim(1, 2).reshape(B, S, -1)
            parts.append(o @ blk["w_proj"])              # partials over mp
        if self.plan.mp > 1:
            parts = self.psum_mp(ranks, parts)
        hs = [h + (p + blk["b_proj"]) for h, p, blk in zip(hs, parts, blks)]
        xs = [_ln(h, b["ln2_w"], b["ln2_b"]) for h, b in zip(hs, blks)]
        xs = self.mp_copy(ranks, xs)
        parts = []
        for x, blk in zip(xs, blks):
            u = x @ blk["w_fc1"] + blk["b_fc1"]
            u = F.gelu(u, approximate="tanh")
            parts.append(u @ blk["w_fc2"])
        if self.plan.mp > 1:
            parts = self.psum_mp(ranks, parts)
        return [h + (p + blk["b_fc2"]) for h, p, blk in zip(hs, parts, blks)]

    def block(self, ranks, hs, blks):
        os = self.attend_sp(ranks, *self.pre_attn(ranks, hs, blks))
        return self.post_attn(ranks, hs, os, blks)

    def apply_block(self, ranks, hs, blks):
        remat = self.cfg.remat
        if not remat or not torch.is_grad_enabled():
            return self.block(ranks, hs, blks)
        if remat is True:
            return checkpoint(self.block, ranks, hs, blks,
                              use_reentrant=False)
        if remat == "dots":
            return checkpoint(self.block, ranks, hs, blks,
                              use_reentrant=False, context_fn=_dots_contexts)
        # "dots+attn": the attention between two checkpointed halves, so
        # its output (and the flash Function's residuals) stays saved
        qkv = checkpoint(self.pre_attn, ranks, hs, blks, use_reentrant=False,
                         context_fn=_dots_contexts)
        os = self.attend_sp(ranks, *qkv)
        return checkpoint(self.post_attn, ranks, hs, os, blks,
                          use_reentrant=False, context_fn=_dots_contexts)

    def stage_blocks(self, ranks, hs, bps):
        """A rank's local stack of blocks: a loop over the stacked index.
        `unbind` hands each layer a view whose gradients stack back in one
        piece."""
        layers = [{k: bp[k].unbind(0) for k in _BLOCK_LEAVES} for bp in bps]
        for i in range(bps[0]["w_qkv"].shape[0]):
            blks = [{k: lay[k][i] for k in _BLOCK_LEAVES} for lay in layers]
            hs = self.apply_block(ranks, hs, blks)
        return hs

    # -- LM head -----------------------------------------------------------
    def head_loss(self, ranks, hs, labs, hps):
        """Tied-embedding LM head + vocab-parallel softmax CE (the JAX
        `_vocab_parallel_loss`): one mean NLL a rank over its tokens."""
        cfg, mp = self.cfg, self.plan.mp
        hs = [_ln(h, hp["lnf_w"], hp["lnf_b"]) for h, hp in zip(hs, hps)]
        hs = self.mp_copy(ranks, hs)
        wtes = [hp["wte"] for hp in hps]
        if cfg.fused_ce_chunks > 1:
            flat = [h.reshape(-1, h.shape[-1]) for h in hs]
            flab = [lab.reshape(-1) for lab in labs]
            if mp > 1:
                nll = self.grid.over(ranks, "mp", lambda g: (
                    fused_linear_cross_entropy(*map(list, zip(*g)),
                                               cfg.fused_ce_chunks)),
                    list(zip(flat, wtes, flab)))
            else:
                nll = [fused_linear_cross_entropy(h, w, lab,
                                                  cfg.fused_ce_chunks)
                       for h, w, lab in zip(flat, wtes, flab)]
            return [x.mean() for x in nll]
        logits = [_LogitsMatmul.apply(h, w) for h, w in zip(hs, wtes)]
        gmax = [lg.amax(-1, keepdim=True).detach() for lg in logits]
        if mp > 1:
            gmax = self.grid.over(ranks, "mp", C.pmax, gmax)
        shifted = [lg - m for lg, m in zip(logits, gmax)]
        sumexp = [torch.exp(s).sum(-1) for s in shifted]
        if mp > 1:
            sumexp = self.psum_mp(ranks, sumexp)
        picked = []
        for r, s, lab, w in zip(ranks, shifted, labs, wtes):
            li = lab.long()
            if mp > 1:
                per = w.shape[0]
                lid = li - C.axis_index(self.grid, r, "mp") * per
                ok = (lid >= 0) & (lid < per)
                pk = s.gather(-1, lid.clamp(0, per - 1)[..., None])[..., 0]
                picked.append(torch.where(ok, pk, 0.0))
            else:
                picked.append(s.gather(-1, li[..., None])[..., 0])
        if mp > 1:
            picked = self.psum_mp(ranks, picked)
        return [(torch.log(se) - pk).mean() for se, pk in zip(sumexp, picked)]

    # -- the loss over the pipeline ----------------------------------------
    def pipeline_loss(self, toks, labs, P, stats):
        """GPipe (and pp == 1): one loss a rank, differentiable."""
        grid, plan = self.grid, self.plan
        ranks = grid.local_ranks
        if plan.pp == 1:
            h = self.embed(ranks, toks, P)
            h = self.stage_blocks(ranks, h, P)
            return self.head_loss(ranks, h, labs, P)
        pp, M = plan.pp, plan.microbatches
        mine = set(ranks)
        full_stage = [grid.ranks_where(pp=s) for s in range(pp)]
        stage = [[r for r in rs if r in mine] for rs in full_stage]
        P = dict(zip(ranks, P))
        tok_mb = {r: t.reshape(M, -1, t.shape[-1])
                  for r, t in zip(ranks, toks)}
        lab_mb = {r: t.reshape(M, -1, t.shape[-1])
                  for r, t in zip(ranks, labs)}
        loss_sum = {r: torch.zeros((), device=grid.devices[r])
                    for r in ranks}
        held = [0] * pp
        chan = [None] * pp
        hop = _Hops(grid, self.cdt, M)
        for t in range(M + pp - 1):
            # last stage first: stage s reads what s-1 sent last tick
            for s in reversed(range(pp)):
                mb = t - s
                if not 0 <= mb < M or not stage[s]:
                    continue
                rs = stage[s]
                if s == 0:
                    x = self.embed(rs, [tok_mb[r][mb] for r in rs],
                                   [P[r] for r in rs])
                else:
                    x = chan[s]
                held[s] += 1
                y = self.stage_blocks(rs, x, [P[r] for r in rs])
                if s == pp - 1:
                    ls = self.head_loss(rs, y, [lab_mb[r][mb] for r in rs],
                                        [P[r] for r in rs])
                    for r, lv in zip(rs, ls):
                        loss_sum[r] = loss_sum[r] + lv
                elif stage[s + 1]:
                    chan[s + 1] = [v.to(grid.devices[r2], copy=True)
                                   for v, r2 in zip(y, stage[s + 1])]
                else:       # the next stage lives in other processes
                    hop.send(mb, s, y, full_stage)
            # what a remote stage s sent this tick, for stage s + 1 here
            for s in range(pp - 1):
                mb = t - s
                if 0 <= mb < M and stage[s + 1] and not stage[s]:
                    chan[s + 1] = hop.recv(
                        mb, s, full_stage, stage[s + 1],
                        {r: tuple(tok_mb[r].shape[1:]) + (self.cfg.hidden,)
                         for r in stage[s + 1]})
            hop.wait()
        stats.update(schedule="gpipe", ticks=M + pp - 1, peak_live=held)
        self.roots = hop.roots
        self.pending = hop.pending
        last = set(stage[pp - 1])
        losses = [loss_sum[r] / M if r in last else loss_sum[r]
                  for r in ranks]
        return self.grid.over(ranks, "pp", C.axis_psum, losses)

    # -- 1F1B / interleaved --------------------------------------------------
    def _hop(self, hops, mine, act_shape, V):
        """The values of this tick's hops (kind 0 an activation, 1 a
        cotangent; chunk, source rank, destination rank, the source's
        per-chunk list or None) that land on this process's ranks: a
        local source hands its value over; a remote one sends it with
        `torch.distributed` point to point (under gloo through the host),
        one message a hop, tagged by its ranks."""
        import torch.distributed as dist
        grid = self.grid
        out = [None] * len(hops)
        reqs, recvd = [], []
        for i, (kind, c, src, dst, vals) in enumerate(hops):
            local_src, local_dst = src in mine, dst in mine
            if not (local_src or local_dst):
                continue
            # above every tag `collectives.shift_over` uses
            tag = (1 + kind * V + c) * grid.size ** 2 \
                + src * grid.size + dst
            if local_src and local_dst:
                out[i] = vals[c]
            elif local_src:
                v = vals[c].to(self.cdt).contiguous()
                if v.is_cuda and dist.get_backend() == "gloo":
                    v = v.cpu()
                reqs.append(dist.isend(v, grid.process_of(dst), tag=tag))
                recvd.append(v)          # kept alive until sent
            else:
                dev = grid.devices[dst]
                on_host = dev.type == "cuda" and dist.get_backend() == "gloo"
                b = torch.empty(act_shape[dst], dtype=self.cdt,
                                device="cpu" if on_host else dev)
                reqs.append(dist.irecv(b, grid.process_of(src), tag=tag))
                out[i] = b
        for q in reqs:
            q.wait()
        return out

    @staticmethod
    def _vjp(fn, leaves, outs_grads):
        """Recompute `fn(leaves)` under enable_grad and pull `outs_grads`
        back: the gradients of every leaf (zeros where unused)."""
        flat = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            outs, grads_out = outs_grads(fn(flat))
            got = torch.autograd.grad(outs, flat, grad_outputs=grads_out,
                                      allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for t, g in zip(flat, got)]

    def pipeline_manual(self, toks, labs, P, stats):
        """The 1F1B / eager-1F1B / interleaved step over the tick tables:
        (one loss a rank, one f32 gradient dict a rank), gradients already
        divided by M."""
        grid, plan, cfg = self.grid, self.plan, self.cfg
        pp, M, V = plan.pp, plan.microbatches, plan.vpp
        if V > 1:
            ftbl, btbl, _ = build_interleaved_tables(M, pp, V)
        else:
            f_t, b_t, _ = build_tables(M, pp, plan.schedule)
            ftbl, btbl = f_t[:, :, None], b_t[:, :, None]
        farr, garr = arrival_tables(ftbl, btbl, pp, V)
        W = required_slots(ftbl, btbl, farr, garr, M, pp, V)
        T = ftbl.shape[0]
        local = grid.local_ranks
        mine = set(local)
        full_stage = [grid.ranks_where(pp=s) for s in range(pp)]
        stage = [[r for r in rs if r in mine] for rs in full_stage]
        P = dict(zip(local, P))
        tok_mb = {r: t.reshape(M, -1, t.shape[-1])
                  for r, t in zip(local, toks)}
        lab_mb = {r: t.reshape(M, -1, t.shape[-1])
                  for r, t in zip(local, labs)}
        Lk = P[local[0]]["w_qkv"].shape[0] // V
        hp_keys, ep_keys = ("lnf_w", "lnf_b", "wte"), ("wte", "wpe")
        nb = len(_BLOCK_LEAVES)

        def chunk(r, c):
            return [P[r][k][c * Lk:(c + 1) * Lk] for k in _BLOCK_LEAVES]

        def as_blocks(flat, n):
            return [dict(zip(_BLOCK_LEAVES, flat[i * nb:(i + 1) * nb]))
                    for i in range(n)]

        f32 = torch.float32
        g_bp = {r: {k: torch.zeros(P[r][k].shape, dtype=f32,
                                   device=grid.devices[r])
                    for k in _BLOCK_LEAVES} for r in local}
        g_hp = {r: {k: torch.zeros(P[r][k].shape, dtype=f32,
                                   device=grid.devices[r])
                    for k in hp_keys} for r in local}
        g_ep = {r: {k: torch.zeros(P[r][k].shape, dtype=f32,
                                   device=grid.devices[r])
                    for k in ep_keys} for r in local}
        loss_sum = {r: torch.zeros((), device=grid.devices[r])
                    for r in local}
        buf = {r: [[None] * W for _ in range(V)] for r in local}
        gbuf = {r: [[None] * W for _ in range(V)] for r in local}
        fchan = {r: [None] * V for r in local}
        gchan = {r: [None] * V for r in local}
        act_shape = {r: tuple(tok_mb[r].shape[1:]) + (cfg.hidden,)
                     for r in local}
        peak = [0] * pp

        def park(slots, i, x, what):
            if x is None:
                raise RuntimeError(f"pipeline: no {what} arrived for slot "
                                   f"{i}")
            if slots[i] is not None:
                raise RuntimeError(f"pipeline: {what} slot {i} of {W} "
                                   "overwritten while live")
            slots[i] = x

        def backward(rs, c, bi, first, seed_from_loss, new_g):
            """One stage chunk's backward of microbatch `bi`: recompute from
            the parked input, pull the parked cotangent (or the loss, on the
            last virtual stage) back, accumulate in f32."""
            n = len(rs)
            xs = [buf[r][c][bi % W] for r in rs]
            bps = sum((chunk(r, c) for r in rs), [])
            if seed_from_loss:
                hps = [P[r][k] for r in rs for k in hp_keys]
                mb_labs = [lab_mb[r][bi] for r in rs]
                box = {}

                def fn(flat):
                    bl = as_blocks(flat[:n * nb], n)
                    hl = [dict(zip(hp_keys, flat[n * nb + 3 * i:
                                                 n * nb + 3 * i + 3]))
                          for i in range(n)]
                    y = self.stage_blocks(rs, flat[n * nb + 3 * n:], bl)
                    return self.head_loss(rs, y, mb_labs, hl)

                def seed(losses):
                    box["losses"] = losses
                    return losses, [torch.ones_like(lv) for lv in losses]
                got = self._vjp(fn, bps + hps + xs, seed)
                for r, lv in zip(rs, box["losses"]):
                    loss_sum[r] = loss_sum[r] + lv.detach()
                ghs = got[n * nb:n * nb + 3 * n]
                for i, r in enumerate(rs):
                    for j, k in enumerate(hp_keys):
                        g_hp[r][k] += ghs[3 * i + j].float()
            else:
                gins = [gbuf[r][c][bi % W] for r in rs]

                def fn(flat):
                    return self.stage_blocks(rs, flat[n * nb:],
                                             as_blocks(flat[:n * nb], n))
                got = self._vjp(fn, bps + xs, lambda ys: (ys, gins))
            gxs = got[-n:]
            for i, r in enumerate(rs):
                for j, k in enumerate(_BLOCK_LEAVES):
                    g_bp[r][k][c * Lk:(c + 1) * Lk] += \
                        got[i * nb + j].float()
                new_g[r][c] = gxs[i]
                buf[r][c][bi % W] = None
                gbuf[r][c][bi % W] = None
            if c == 0 and first:
                eps = [P[r][k] for r in rs for k in ("wte", "wpe")]
                mb_toks = [tok_mb[r][bi] for r in rs]

                def efn(flat):
                    return self.embed(rs, mb_toks, [
                        {"wte": flat[2 * i], "wpe": flat[2 * i + 1]}
                        for i in range(n)])
                ge = self._vjp(efn, eps, lambda ys: (ys, gxs))
                for i, r in enumerate(rs):
                    g_ep[r]["wte"] += ge[2 * i].float()
                    g_ep[r]["wpe"] += ge[2 * i + 1].float()

        for t in range(T):
            new_y = {r: [None] * V for r in local}
            new_g = {r: [None] * V for r in local}
            for s in range(pp):
                rs = stage[s]
                if not rs:
                    continue
                first, last = s == 0, s == pp - 1
                for c in range(V):
                    fi, bi = int(ftbl[t, s, c]), int(btbl[t, s, c])
                    # park arrivals first: the channels are overwritten
                    # every tick, whenever this stage runs them
                    a_f, a_g = int(farr[t, s, c]), int(garr[t, s, c])
                    if a_f >= 0:
                        src = c - 1 if first and c > 0 else c
                        for r in rs:
                            park(buf[r][c], a_f % W, fchan[r][src],
                                 "activation")
                    if a_g >= 0:
                        src = c + 1 if last and c < V - 1 else c
                        for r in rs:
                            park(gbuf[r][c], a_g % W, gchan[r][src],
                                 "cotangent")
                    if fi >= 0:
                        with torch.no_grad(), RecordEvent(
                                "train::forward", TracerEventType.Forward):
                            if c == 0 and first:
                                xs = self.embed(rs, [tok_mb[r][fi]
                                                     for r in rs],
                                                [P[r] for r in rs])
                                for r, x in zip(rs, xs):
                                    park(buf[r][0], fi % W, x, "input")
                            # the last virtual stage's output is consumed
                            # nowhere: its backward recomputes it
                            if not (c == V - 1 and last):
                                ys = self.stage_blocks(
                                    rs, [buf[r][c][fi % W] for r in rs],
                                    as_blocks(sum((chunk(r, c) for r in rs),
                                                  []), len(rs)))
                                for r, y in zip(rs, ys):
                                    new_y[r][c] = y
                    if bi >= 0:
                        with RecordEvent("train::backward",
                                         TracerEventType.Backward):
                            backward(rs, c, bi, first, last and c == V - 1,
                                     new_g)
                live = max(sum(x is not None for x in buf[r][c])
                           for r in rs for c in range(V))
                peak[s] = max(peak[s], live)
            # the hops: activations to the next stage, cotangents back
            fchan = {r: [None] * V for r in local}
            gchan = {r: [None] * V for r in local}
            hops = []          # (kind, source rank, destination rank, value)
            for s in range(pp):
                nxt, prv = full_stage[(s + 1) % pp], full_stage[(s - 1) % pp]
                for i, r in enumerate(full_stage[s]):
                    for c in range(V):
                        # virtual stage 0's cotangent feeds its embedding
                        # only; the last virtual stage sends nothing on
                        if int(ftbl[t, s, c]) >= 0 and not (
                                c == V - 1 and s == pp - 1):
                            hops.append((0, c, r, nxt[i], new_y.get(r)))
                        if int(btbl[t, s, c]) >= 0 and (s, c) != (0, 0):
                            hops.append((1, c, r, prv[i], new_g.get(r)))
            got = self._hop(hops, mine, act_shape, V)
            for (kind, c, src, dst, _), v in zip(hops, got):
                if v is None:
                    continue
                if kind == 0:
                    fchan[dst][c] = v.to(grid.devices[dst], copy=True)
                else:
                    gchan[dst][c] = v.to(grid.devices[dst], self.cdt,
                                         copy=True)
        stats.update(schedule=plan.schedule if V == 1 else "interleaved",
                     ticks=T, slots=W, peak_live=peak)
        last = set(full_stage[pp - 1])
        losses = [loss_sum[r] / M if r in last else loss_sum[r]
                  for r in local]
        losses = grid.over(local, "pp", C.psum, losses)
        grads = []
        for r in local:         # in place: the f32 accumulators are large
            g = {k: v.div_(M) for k, v in g_bp[r].items()}
            g["wte"] = g_ep[r]["wte"].add_(g_hp[r]["wte"]).div_(M)
            g["wpe"] = g_ep[r]["wpe"].div_(M)
            g["lnf_w"] = g_hp[r]["lnf_w"].div_(M)
            g["lnf_b"] = g_hp[r]["lnf_b"].div_(M)
            grads.append(g)
        return losses, grads


class _SendAct(torch.autograd.Function):
    """Posts the send of a stage's activation to another process and
    returns a 0-d zero to join the step's backward; its backward receives
    the activation's cotangent from that process."""

    @staticmethod
    def forward(ctx, x, hops, proc, tag):
        ctx.hops, ctx.proc, ctx.tag = hops, proc, tag
        ctx.like = (x.shape, x.dtype, x.device)
        hops.post_send(proc, tag, x)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        got = C._p2p([], [(ctx.proc, ctx.tag + ctx.hops.back,
                           torch.empty(shape, dtype=dtype, device=device))])
        return got[0], None, None, None


class _RecvAct(torch.autograd.Function):
    """A received activation (`buf`) in the graph; its backward posts the
    send of the cotangent back to the process it came from."""

    @staticmethod
    def forward(ctx, anchor, buf, hops, proc, tag):
        ctx.hops, ctx.proc, ctx.tag = hops, proc, tag
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, g):
        ctx.hops.post_send(ctx.proc, ctx.tag + ctx.hops.back,
                           g.contiguous(), backward=True)
        return None, None, None, None, None


class _Hops:
    """The GPipe schedule's hops between processes: activations forward
    (tagged by microbatch, source and destination rank), cotangents back
    in the backward through `_SendAct` / `_RecvAct`. Forward sends are
    posted as a stage finishes and waited at the tick's end; the
    backward's sends are waited once the step's backward is done
    (`pending`)."""

    def __init__(self, grid, cdt, M):
        self.grid, self.cdt = grid, cdt
        self.size = grid.size
        self.back = M * grid.size * grid.size
        self.reqs, self.roots, self.pending = [], [], []

    def tag(self, mb, src, dst):
        # above every tag `collectives.shift_over` uses
        return (1 + mb) * self.size * self.size + src * self.size + dst

    def post_send(self, proc, tag, x, backward=False):
        w = C._wire(x)
        req = torch.distributed.isend(w, proc, tag=tag)
        (self.pending if backward else self.reqs).append((req, w))

    def send(self, mb, s, ys, full_stage):
        g = self.grid
        for y, r in zip(ys, [r for r in full_stage[s]
                             if r in g.local_ranks]):
            dst = full_stage[s + 1][full_stage[s].index(r)]
            self.roots.append(_SendAct.apply(
                y.to(self.cdt), self, g.process_of(dst),
                self.tag(mb, r, dst)))

    def recv(self, mb, s, full_stage, rs, shapes):
        g = self.grid
        recvs = []
        for r2 in rs:
            src = full_stage[s][full_stage[s + 1].index(r2)]
            recvs.append((g.process_of(src), self.tag(mb, src, r2),
                          torch.empty(shapes[r2], dtype=self.cdt,
                                      device=g.devices[r2])))
        got = C._p2p([], recvs)
        anchor = torch.zeros((), requires_grad=True)
        return [_RecvAct.apply(anchor, b, self, p, tag)
                for b, (p, tag, _) in zip(got, recvs)]

    def wait(self):
        for req, _ in self.reqs:
            req.wait()
        self.reqs = []


def _allgather_sp_attention(group):
    """The JAX `_allgather_sp_attention` over one sp group of (q, k, v):
    K and V gathered to the full sequence, each rank's S_loc queries
    attend over them with the causal mask offset by its rows (float32,
    -inf above the global diagonal). Cross-length attention: the plain
    dense route, as in the reference."""
    qs, ks, vs = map(list, zip(*group))
    k_full = C.all_gather(ks, 2)
    v_full = C.all_gather(vs, 2)
    S_loc, S = qs[0].shape[2], k_full[0].shape[2]
    out = []
    for i, (q, kf, vf) in enumerate(zip(qs, k_full, v_full)):
        rows = i * S_loc + torch.arange(S_loc, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        mask = torch.zeros((S_loc, S), device=q.device).masked_fill(
            rows < cols, float("-inf"))
        out.append(reference_attention_bhsd(q, kf, vf, causal=False,
                                            mask=mask[None, None]))
    return out


# ---------------------------------------------------------------------------
# AdamW with f32 master weights (ZeRO-2 over `sharding`)
# ---------------------------------------------------------------------------

def _adamw_shard_(st, g_sh, p_sh, lr, wd, b1=0.9, b2=0.95, eps=1e-8):
    """One AdamW step of a rank's state shard in place (its master
    adopting p_sh at t == 0)."""
    st["master"].copy_(torch.where(st["t"] == 0, p_sh, st["master"]))
    st["t"].add_(1)
    t = st["t"].float()
    st["m"].mul_(b1).add_((1 - b1) * g_sh)
    st["v"].mul_(b2).add_((1 - b2) * g_sh * g_sh)
    mhat = st["m"] / (1 - b1 ** t)
    vhat = st["v"] / (1 - b2 ** t)
    master = st["master"]
    master.mul_(1 - lr * wd)
    master.sub_(lr * mhat / (torch.sqrt(vhat) + eps))


def _zero2_update_(grid, ps, gs, sts, lrs, clips, wd):
    """Reduce-scatter the (clipped, f32) gradient over `sharding` and
    divide by its size, update each rank's shard of the f32 master,
    all-gather the masters and write the parameters in place. `ps`,
    `gs`, `sts`, `lrs`, `clips`: one a rank this process drives."""
    n = grid.dims["sharding"]
    size = ps[0].numel()
    shard = -(-size // n)
    pad = shard * n - size
    gfs = [g.reshape(-1).float() * clip for g, clip in zip(gs, clips)]
    ranks = grid.local_ranks
    if n > 1:
        gfs = [F.pad(g, (0, pad)) for g in gfs]
        g_sh = grid.over(ranks, "sharding",
                         functools.partial(C.psum_scatter, dim=0), gfs)
        g_sh = [g / n for g in g_sh]
        p_sh = []
        for r, p in zip(ranks, ps):
            i = grid.coords[r]["sharding"]
            p_sh.append(F.pad(p.reshape(-1).float(), (0, pad))
                        [i * shard:(i + 1) * shard])
    else:
        g_sh, p_sh = gfs, [p.reshape(-1).float() for p in ps]
    for st, g, p, lr in zip(sts, g_sh, p_sh, lrs):
        _adamw_shard_(st, g, p, lr, wd)
    if n > 1:
        full = grid.over(ranks, "sharding", lambda g: C.all_gather(g, 0),
                         [st["master"] for st in sts])
    else:
        full = [st["master"] for st in sts]
    for p, f in zip(ps, full):
        p.copy_(f[:size].view(p.shape))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _resolve_devices(devices, n):
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"devices names {len(devs)} devices for {n} ranks")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"rank device {d} is not on this host "
                             f"({torch.cuda.device_count()} CUDA devices)")
    return devs


def _check_plan(cfg, plan):
    """The JAX step's preconditions, raised when the step is built."""
    if cfg.remat not in _REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; use one of {_REMAT}")
    if plan.schedule not in _SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {plan.schedule!r}; "
                         "expected 1f1b | eager1f1b | gpipe")
    for a, d in plan.dims.items():
        if int(d) < 1:
            raise ValueError(f"MeshPlan.{a} must be >= 1, got {d}")
    if plan.microbatches < 1 or plan.vpp < 1:
        raise ValueError("microbatches and vpp must be >= 1")
    mp = plan.mp
    for what, n in (("heads", cfg.heads), ("vocab_size", cfg.vocab_size),
                    ("ffn", cfg.ffn)):
        if n % mp:
            raise ValueError(f"{what} {n} does not split over mp={mp}")
    if cfg.layers % (plan.pp * plan.vpp):
        raise ValueError(f"layers {cfg.layers} do not split over "
                         f"pp*vpp = {plan.pp * plan.vpp} stages")
    if plan.sp > 1 and plan.sp_mode == "ulysses" and \
            (cfg.heads // mp) % plan.sp:
        raise ValueError(f"ulysses_attention needs heads "
                         f"({cfg.heads // mp}) divisible by the sp axis "
                         f"size ({plan.sp})")
    if cfg.fused_ce_chunks > 1 and (cfg.vocab_size // mp) % \
            cfg.fused_ce_chunks:
        # an error, not a quiet fall back to the unfused head: the user
        # sized memory around this knob
        raise ValueError(
            f"(InvalidArgument) fused_ce_chunks={cfg.fused_ce_chunks} "
            f"must divide the vocab shard rows {cfg.vocab_size // mp} "
            f"(= vocab_size/mp); pick a chunk count that divides the "
            f"LOCAL shard")


def _split_batch(x, grid, plan):
    """Global (B, S) -> the block of each rank this process drives: batch
    over (dp, sharding), sequence over sp."""
    nb = plan.dp * plan.sharding
    B, S = x.shape
    if B % nb or S % plan.sp:
        raise ValueError(f"batch ({B}, {S}) does not split over "
                         f"dp*sharding={nb} and sp={plan.sp}")
    Bl, Sl = B // nb, S // plan.sp
    if Bl % plan.microbatches:
        raise ValueError(f"local batch {Bl} does not split into "
                         f"{plan.microbatches} microbatches")
    out = []
    for r in grid.local_ranks:
        dev = grid.devices[r]
        b = grid.flat_index(r, ("dp", "sharding"))
        s = grid.coords[r]["sp"]
        out.append(x[b * Bl:(b + 1) * Bl, s * Sl:(s + 1) * Sl].to(dev))
    return out


def _global_grad_sq(grid, grads):
    """Sum of squares over every logical gradient element, a leaf's local
    sum psummed over the mp / pp axes that shard it (a replicated leaf
    counted once)."""
    specs = param_specs()
    ranks = grid.local_ranks
    total = [torch.zeros((), device=grid.devices[r]) for r in ranks]
    for name in grads[0]:
        sq = [(g[name].float() ** 2).sum() for g in grads]
        for a in specs[name]:
            if a in ("mp", "pp") and grid.dims[a] > 1:
                sq = grid.over(ranks, a, C.psum, sq)
        total = [t + q for t, q in zip(total, sq)]
    return total


def _process_grid(plan, dev, devices, axis_order=None):
    """The rank grid of the step, split over the processes.

    One controller drives every rank. Under a `torch.distributed` process
    group of world W > 1 (the multi-controller step, in place of the JAX
    `_put_global`'s `jax.distributed` branch) the ranks are split into W
    blocks of device slots over `axis_order` (the axes slowest first, the
    reference's device-array transpose; default `AXES`), and this process
    drives its block (`grid.local_ranks`): the axis named first is the
    one whose groups span the processes. Every axis may cross them."""
    import torch.distributed as dist
    from ..distributed.env import new_mesh
    n = plan.n_devices
    world, me = 1, 0
    if n > 1 and dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
    if n % world:
        raise ValueError(f"{n} ranks do not split over {world} processes")
    local = _resolve_devices(devices or [dev] * (n // world), n // world)
    grid = new_mesh(plan.dims, local, world, me, axis_order)
    return grid


def make_train_step(cfg: GPTSpmdConfig, plan: MeshPlan = None,
                    learning_rate=3e-4, weight_decay=0.1, grad_clip=1.0,
                    device="cuda", attention="kernel", devices=None,
                    axis_order=None):
    """Returns (step_fn, init_fn).

    step_fn(params, opt_state, tokens, labels, lr=None) -> (loss, params,
    opt_state): one AdamW step on the global batch (tokens/labels int
    (B, S), split over (dp, sharding) and sp), lr defaulting to
    `learning_rate`. The parameter and state tensors are updated in place
    and returned. init_fn(seed=0) -> (params, opt_state) draws the global
    parameters with a generator seeded `seed` on the first rank's device
    (the same model for every plan), applies the vpp storage permutation
    and cuts each rank's piece. `step_fn.stats` holds the last step's
    pipeline record (schedule, ticks, buffer slots, peak live stage
    inputs a stage).

    Rank r runs on `devices[r]` (default `device` for each of the
    plan's ranks); a CUDA device the host lacks raises. attention="kernel"
    runs the flash-attention kernels (their plain versions on CPU
    tensors); "plain" runs dense attention with autograd.

    Under a process group of world W > 1 the plan runs as W controllers
    (`_process_grid`, its ranks over `axis_order`): each process passes
    the same global batch and drives its block of ranks, `devices` names
    its block's devices, a leaf holds one tensor a local rank, and
    init_fn builds the local ranks' leaves from the same seed in every
    process. A sum, mean or reduce-scatter whose group spans the
    processes adds each process's members and runs one all-reduce or
    reduce-scatter of those partial sums (`RankGrid.over`); the data
    axes' gradients are averaged one axis at a time, so a group of one
    member a process sums exactly as one controller does. Other
    collectives gather the group's members. Every pipeline schedule
    (GPipe, 1F1B, eager-1F1B, interleaved) sends its activations and
    cotangents between processes point to point; sp's ring sends its K/V
    blocks round the processes and Ulysses runs one all-to-all over them
    each way."""
    plan = plan or MeshPlan()
    _check_plan(cfg, plan)
    dev = resolve_device(device)
    grid = _process_grid(plan, dev, devices, axis_order)
    ranks = grid.local_ranks
    devs = [grid.devices[r] for r in ranks]
    prog = _Program(cfg, plan, grid, _attend_fn(attention))
    specs = param_specs(cfg)
    manual = plan.pp > 1 and (plan.vpp > 1 or plan.schedule != "gpipe")
    sync_axes = tuple(a for a in ("dp", "sp", "sharding")
                      if plan.dims[a] > 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step_fn(params, opt_state, tokens, labels, lr=None):
        single = not isinstance(next(iter(params.values())), (list, tuple))
        if single:
            P, S = [params], [opt_state]
        else:
            P = [{k: v[i] for k, v in params.items()}
                 for i in range(len(ranks))]
            S = [{k: v[i] for k, v in opt_state.items()}
                 for i in range(len(ranks))]
        if len(P) != len(ranks) and not (single and grid.size == 1):
            raise ValueError(f"params hold {len(P)} ranks, this process "
                             f"drives {len(ranks)}")
        lr_v = learning_rate if lr is None else lr
        lrs = [torch.tensor(lr_v, dtype=torch.float32, device=d)
               for d in devs]
        if grid.size == 1:
            toks, labs = [tokens.to(devs[0])], [labels.to(devs[0])]
        else:
            toks = _split_batch(tokens, grid, plan)
            labs = _split_batch(labels, grid, plan)
        step_fn.stats = {}
        if manual:
            losses, grads = prog.pipeline_manual(toks, labs, P,
                                                 step_fn.stats)
        else:
            for p in (t for d in P for t in d.values()):
                p.requires_grad_(True)
                p.grad = None
            with torch.enable_grad():
                with RecordEvent("train::forward", TracerEventType.Forward):
                    losses = prog.pipeline_loss(toks, labs, P, step_fn.stats)
                with RecordEvent("train::backward",
                                 TracerEventType.Backward):
                    total = losses[0]
                    for lv in losses[1:] + prog.roots:
                        total = total + lv.to(total.device)
                    if total.requires_grad:
                        total.backward()
                    for req, _ in prog.pending:
                        req.wait()
                    prog.roots, prog.pending = [], []
            grads = [{k: torch.zeros_like(p) if p.grad is None else p.grad
                      for k, p in d.items()} for d in P]
            losses = [lv.detach() for lv in losses]
        with torch.no_grad(), RecordEvent("train::optimizer",
                                          TracerEventType.Optimization):
            if sync_axes:
                # grad sync over every data axis BEFORE the clip, so the
                # global norm sees the true batch gradient; one axis at a
                # time (dp, sp, sharding), so a group that spans the
                # processes one member a process sums exactly as one
                # controller does
                for k in specs:
                    col = [g[k] for g in grads]
                    for a in sync_axes:
                        col = grid.over(ranks, a, C.pmean, col)
                    for g, v in zip(grads, col):
                        g[k] = v
                for a in sync_axes:
                    losses = grid.over(ranks, a, C.pmean, losses)
            if plan.pp > 1:
                # pp-replicated leaves: stage-disjoint parts, summed
                for k, spec in specs.items():
                    if "pp" not in spec:
                        col = grid.over(ranks, "pp", C.psum,
                                        [g[k] for g in grads])
                        for g, v in zip(grads, col):
                            g[k] = v
            clips = [torch.ones((), device=d) for d in devs]
            if grad_clip:
                if plan.mp > 1 or plan.pp > 1:
                    sq = _global_grad_sq(grid, grads)
                else:
                    sq = [sum((g.float() ** 2).sum() for g in gd.values())
                          for gd in grads]
                clips = [torch.clamp(grad_clip / torch.clamp(
                    torch.sqrt(q), min=1e-6), max=1.0) for q in sq]
            for k in specs:
                _zero2_update_(grid, [d[k] for d in P],
                               [g[k] for g in grads], [st[k] for st in S],
                               lrs, clips, weight_decay)
            for p in (t for d in P for t in d.values()):
                p.grad = None
        return losses[0], params, opt_state

    step_fn.stats = {}
    step_fn.grid = grid

    def init_fn(seed=0):
        gen = torch.Generator(device=devs[0]).manual_seed(int(seed))
        full = init_gpt_params(cfg, gen, devs[0])
        if plan.vpp > 1:
            perm = torch.from_numpy(interleave_permutation(
                cfg.layers, plan.pp, plan.vpp)).to(devs[0])
            full = {k: (v[perm] if k in _BLOCK_LEAVES else v)
                    for k, v in full.items()}
        if grid.size == 1:
            return full, {k: init_opt_state_leaf(p, plan)
                          for k, p in full.items()}
        params = {k: shard_leaf(v, specs[k], grid) for k, v in full.items()}
        del full
        state = {k: [init_opt_state_leaf(p, plan) for p in v]
                 for k, v in params.items()}
        return params, state

    return step_fn, init_fn


def _loss(params, tokens, labels, cfg, attend):
    """The single-device loss of `params` (a dict of tensors)."""
    grid = RankGrid(MeshPlan().dims, [tokens.device])
    prog = _Program(cfg, MeshPlan(), grid, attend)
    return prog.pipeline_loss([tokens], [labels], [params], {})[0]


def make_forward_fn(cfg: GPTSpmdConfig, device="cuda", attention="kernel"):
    """Single-device forward: fwd(params, tokens) -> f32 logits (B, S, V)."""
    dev = resolve_device(device)
    if cfg.remat not in _REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; use one of {_REMAT}")
    prog = _Program(cfg, MeshPlan(), RankGrid(MeshPlan().dims, [dev]),
                    _attend_fn(attention))

    def fwd(params, tokens):
        h = prog.embed([0], [tokens.to(dev)], [params])
        h = prog.stage_blocks([0], h, [params])[0]
        h = _ln(h, params["lnf_w"], params["lnf_b"])
        return torch.matmul(h.float(), params["wte"].float().t())
    return fwd
