"""Flash attention: the wrappers of the hand-written CUDA kernels
`csrc/flash_attention.cu`, their plain PyTorch versions, and the public
contract of `paddle_tpu/ops/flash_attention.py`.

Replaces the three Pallas TPU kernels of
`paddle_tpu/ops/pallas/flash_attention.py`: `_fwd_kernel` (online-softmax
forward, writes O and a per-row logsumexp), `_dq_kernel` and `_dkv_kernel`
(the backward, recomputing P from the logsumexp). The semantics are the
TPU kernels', to the places where values are rounded:

  * scores are `(q . k) * scale` in f32; an additive mask is added and the
    sum clamped at -1e30; causal positions above the diagonal are filled
    with -1e30; `p = 0` wherever the score is at or below -0.5e30;
  * a row that sees no key (l == 0) outputs exact zeros, and its lse is
    m + log(1);
  * dropout keeps an element where the murmur3 hash of its absolute
    (row, col), the seed and the flattened (batch * H + head) index clears
    the threshold (`dropout_keep`, bit for bit the TPU kernel's); kept
    values are scaled by 1 / (1 - rate) in PV, in dP, and in P^T for dV,
    while dS uses the undropped P;
  * bf16 and float16 inputs round P to V's dtype before PV, dS to K's
    (Q's) dtype before dS.K (dS^T.Q), and the dropped P to dO's dtype
    before P^T.dO; every product accumulates in f32;
  * GQA: query head b reads KV row (b // H) * Hk + (b % H) // (H / Hk); dK
    and dV come out per query head and are summed over the group here.

Dispatch is by the device of the tensors and nothing else: CPU tensors
run the plain versions (`fwd_plain`, `dq_plain`, `dkv_plain`), CUDA
tensors launch the kernels or raise. The kernels take any S >= 1 (the
ragged last tile is masked inside), head dims 64, 128 and 256 (the JAX
dispatch's), and float32, bfloat16 and float16: at 64 and 128, f32 runs
on the CUDA cores and the 16-bit types on the tensor cores (`wgmma`); at
256 every dtype runs on the CUDA cores (a simple build, ROADMAP B).

The kernels read contiguous [B*H, S, D] rows: `flash_attention_bhsd`
copies q, k and v to contiguous memory before the call (the GPT's
head-major qkv split hands it strided views), and the ops copy any
operand that is still strided or misaligned (a program traced over
dynamic shapes decides at run time whether a reshape copies) before
the checks the launch makes.

`launches_fwd`, `launches_dq` and `launches_dkv` count kernel launches
(CPU calls do not count), so a run can show that its main path went
through the kernels; `launches_by_build` counts them by build,
{(kernel, block_q, block_k): launches}.

Tiles. Each kernel is built at the tiles of `BUILDS` (query rows, key
rows), all compiled into the library at first use: the 16-bit forward at
(128, 128) and (128, 64), the default first, dQ at (128, 64) (a (128,
128) build spilled), dK/dV at (64, 128); the CUDA-core kernels (f32, and
every dtype at D = 256) at (64, 64) alone. Every CUDA launch looks its geometry (H,
S, D, causal) up in the tile table (`incubate/autotune.py`) and runs the
table's pair where the kernel has a build at it, its default otherwise.
`tiled_fwd`, `tiled_dq` and `tiled_dkv` take the pair from the caller
instead (the tuner, the checks).

The three launches are `torch.library` custom ops,
`torch.ops.paddle_tpu_torch.flash_fwd`, `.flash_dq` and `.flash_dkv`,
registered when this module is imported. `make_fx` and `torch.export`
record each as one node (their fake implementations give the output
shapes), so a traced or exported program calls the kernels, and a saved
program that holds them loads wherever `paddle_tpu_torch` is imported.
`Meta`'s fields are the ops' scalar arguments; the dropout seed is a
0-d int64 CPU tensor (or None), which the op reads on the host: drawn
inside a traced program, it is drawn anew at every run.
"""
import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["flash_attention_bhsd", "flash_attention_bshd",
           "reference_attention_bhsd", "dropout_keep",
           "fwd_plain", "dq_plain", "dkv_plain", "flash_fwd", "flash_dq",
           "flash_dkv", "tiled_fwd", "tiled_dq", "tiled_dkv", "builds",
           "build_pairs", "resolve_build", "SUPPORTED_HEAD_DIMS", "BUILDS",
           "CORE_BUILD", "DEFAULT_PAIR", "TUNE_PAIRS", "launches_fwd",
           "launches_dq", "launches_dkv", "launches_by_build"]

launches_fwd = 0
launches_dq = 0
launches_dkv = 0
launches_by_build = {}         # (kernel, block_q, block_k) -> launches

SUPPORTED_HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WHICH = {"fwd": 0, "dq": 1, "dkv": 2}
_lib = None
_autotune = None

# The 16-bit (wgmma) builds at head dims 64 and 128, (query rows, key
# rows) of a tile, the default first; `csrc/flash_attention.cu`
# `wgmma_built` lists the same (checked when the library is bound).
BUILDS = {"fwd": ((128, 128), (128, 64)),
          "dq": ((128, 64),),
          "dkv": ((64, 128),)}
# the CUDA-core kernels' one build (f32 at D 64 and 128, every dtype at 256)
CORE_BUILD = (64, 64)
# the pair that runs every 16-bit kernel's default (the forward's; dQ and
# dK/dV have no build there): the tuner's fallback, and a candidate
DEFAULT_PAIR = (128, 128)
TUNE_PAIRS = (DEFAULT_PAIR, (128, 64))


def builds(which, D, dtype):
    """The tiles kernel `which` ("fwd", "dq", "dkv") is built at for head
    dim D and `dtype`, the default first."""
    if dtype in (torch.bfloat16, torch.float16) and D in (64, 128):
        return BUILDS[which]
    return (CORE_BUILD,)


def build_pairs():
    """Every (block_q, block_k) some flash build has."""
    return frozenset({CORE_BUILD}.union(*BUILDS.values()))


def resolve_build(which, D, dtype, pair):
    """The build a launch of `which` runs for a table `pair` (or None):
    the pair where the kernel has a build at it, its default otherwise."""
    have = builds(which, D, dtype)
    return pair if pair in have else have[0]


@dataclass(frozen=True)
class Meta:
    """What the kernels need besides the tensors: heads, mask broadcast,
    causal flag, scale and dropout. `seed` is an int or a 0-d int64 CPU
    tensor."""
    H: int
    Hk: int
    Bm: int = 1
    Hm: int = 1
    causal: bool = False
    scale: float = 1.0
    rate: float = 0.0
    seed: object = 0


# ------------------------------------------------------------------ dropout
def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors x < 2**32 and a 32-bit constant,
    without leaving int64 (the multiplier is split into 16-bit halves)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _threshold(rate):
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep(seed, b, row, col, rate):
    """Keep mask of `pallas/flash_attention.py:_dropout_keep` in int64
    arithmetic masked to 32 bits: bit-identical to the TPU kernel's uint32
    hash. seed is an int (int32 range, wrapped as the TPU kernel's cast
    does) or a 0-d integer tensor (a seed drawn inside a traced program);
    b, row and col are integer tensors that broadcast."""
    b, row, col = (t.to(torch.int64) & _M32 for t in (b, row, col))
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=b.device, dtype=torch.int64)
    else:
        seed = int(seed)
    x = (_mul32(row, 0x9E3779B9) + _mul32(col, 0x85EBCA6B)) & _M32
    x = x ^ (((seed & _M32) + _mul32(b, 0xC2B2AE35)) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _threshold(rate)


# ----------------------------------------------------------- plain versions
def _kv_rows(BH, meta, device):
    b = torch.arange(BH, device=device)
    return (b // meta.H) * meta.Hk + (b % meta.H) // (meta.H // meta.Hk)


def _mask_rows(BH, meta, device):
    b = torch.arange(BH, device=device)
    return ((b // meta.H) if meta.Bm > 1 else 0) * meta.Hm + \
        ((b % meta.H) if meta.Hm > 1 else 0)


def _scores(q, kx, mask, meta):
    """Masked f32 scores [BH, S, S] as the TPU kernels form them."""
    BH, S, _ = q.shape
    s = torch.matmul(q.float(), kx.float().transpose(1, 2)) * meta.scale
    neg = torch.tensor(NEG_INF, device=q.device)
    if mask is not None:
        s = torch.maximum(s + mask[_mask_rows(BH, meta, q.device)].float(),
                          neg)
    if meta.causal:
        idx = torch.arange(S, device=q.device)
        s = torch.where(idx[:, None] >= idx[None, :], s, neg)
    return s


def _keep(q, meta):
    BH, S, _ = q.shape
    idx = torch.arange(S, device=q.device)
    b = torch.arange(BH, device=q.device)[:, None, None]
    return dropout_keep(meta.seed, b, idx[None, :, None], idx[None, None, :],
                        meta.rate)


def _drop(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _round(x, dtype):
    """Round f32 values to `dtype`'s precision and back to f32."""
    return x.to(dtype).float()


def fwd_plain(q, k, v, mask, meta):
    """Plain version of the forward kernel (`_fwd_kernel`), over the whole
    row at once. q [BH,S,D], k/v [BH/H*Hk,S,D], mask [Bm*Hm,S,S] or None.
    Returns (O [BH,S,D] in q's dtype, lse [BH,S] f32)."""
    kv = _kv_rows(q.shape[0], meta, q.device)
    s = _scores(q, k[kv], mask, meta)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)   # m starts at
    p = torch.exp(s - m)                                     # -1e30
    p = torch.where(s <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(-1, keepdim=True)
    if meta.rate > 0:
        p = _drop(p, _keep(q, meta), meta.rate)
    acc = torch.matmul(_round(p, v.dtype), v[kv].float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = (m + torch.log(l_safe))[..., 0]
    return (acc / l_safe).to(q.dtype), lse


def _recompute_p(q, kx, mask, lse, meta):
    s = _scores(q, kx, mask, meta)
    p = torch.exp(s - lse[..., None])
    return torch.where(s <= NEG_INF * 0.5, torch.zeros_like(p), p)


def _ds(p, do, vx, delta, keep, meta):
    dp = torch.matmul(do.float(), vx.float().transpose(1, 2))
    if keep is not None:
        dp = _drop(dp, keep, meta.rate)
    return p * (dp - delta[..., None]) * meta.scale


def dq_plain(q, k, v, do, lse, delta, mask, meta):
    """Plain version of `_dq_kernel`: dQ [BH,S,D] in q's dtype."""
    kv = _kv_rows(q.shape[0], meta, q.device)
    kx = k[kv]
    p = _recompute_p(q, kx, mask, lse, meta)
    keep = _keep(q, meta) if meta.rate > 0 else None
    ds = _ds(p, do, v[kv], delta, keep, meta)
    return torch.matmul(_round(ds, k.dtype), kx.float()).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, mask, meta):
    """Plain version of `_dkv_kernel`: (dK, dV) [BH,S,D] per query head,
    in k's and v's dtypes (the GQA group sum is the caller's)."""
    kv = _kv_rows(q.shape[0], meta, q.device)
    kx = k[kv]
    p = _recompute_p(q, kx, mask, lse, meta)
    keep = _keep(q, meta) if meta.rate > 0 else None
    p_drop = p if keep is None else _drop(p, keep, meta.rate)
    dv = torch.matmul(_round(p_drop, do.dtype).transpose(1, 2), do.float())
    ds = _ds(p, do, v[kv], delta, keep, meta)
    dk = torch.matmul(_round(ds, q.dtype).transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def _kernel_lib():
    global _lib
    if _lib is None:
        from .._kernels import build
        lib = build.load("flash_attention")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        # BH H Hk S D Bm Hm, scale flags threshold keep_div seed dtype,
        # block_q block_k stream
        shape = [ci] * 7 + [cf, ci, cu, cf, cu, ci, ci, ci, vp]
        lib.flash_attention_fwd.argtypes = [vp] * 6 + shape
        lib.flash_attention_dq.argtypes = [vp] * 8 + shape
        lib.flash_attention_dkv.argtypes = [vp] * 9 + shape
        for fn in (lib.flash_attention_fwd, lib.flash_attention_dq,
                   lib.flash_attention_dkv):
            fn.restype = ci
        lib.flash_attention_has_build.argtypes = [ci] * 5
        lib.flash_attention_has_build.restype = ci
        lib.flash_attention_wgmma_smem.argtypes = [ci] * 4
        lib.flash_attention_wgmma_smem.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _check_builds(lib)
        _lib = lib
    return _lib


def _check_builds(lib):
    """The library's builds are `builds()`'s, for every kernel, head dim
    and dtype."""
    for which, w in _WHICH.items():
        for D in SUPPORTED_HEAD_DIMS:
            for dtype, code in _DTYPES.items():
                have = set(builds(which, D, dtype))
                for pair in build_pairs():
                    if bool(lib.flash_attention_has_build(w, D, code,
                                                          *pair)) \
                            != (pair in have):
                        raise RuntimeError(
                            f"flash_attention: the library's {which} "
                            f"builds at D={D} {dtype} are not {have}")


def _check_kernel_args(name, q, k, v, mask, extra):
    """Everything a launch needs, checked before the library is touched."""
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention {name}: head_dim {D} is not "
                         f"built (have {SUPPORTED_HEAD_DIMS})")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention {name}: unsupported device "
                         f"{q.device}; the kernels run on CUDA, CPU tensors "
                         "take the plain version")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention {name}: unsupported dtype "
                        f"{q.dtype}")
    tensors = [q, k, v] + list(extra)
    if any(t.dtype != q.dtype for t in (k, v) + tuple(extra[:1])):
        raise TypeError(f"flash_attention {name}: q, k, v and dO must "
                        "share one dtype")
    if any(t.dtype != torch.float32 for t in extra[1:]):
        raise TypeError(f"flash_attention {name}: lse and delta must be "
                        "float32")
    if mask is not None:
        tensors.append(mask)
        if mask.dtype != torch.float32:
            raise TypeError(f"flash_attention {name}: mask must be float32")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_attention {name}: every operand must "
                             f"be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: operands must be "
                             "contiguous and 16-byte aligned")


def _table_pair(q, meta):
    """The tile table's pair for this launch's geometry, or None."""
    global _autotune
    if _autotune is None:
        from ..incubate import autotune
        _autotune = autotune
    return _autotune.lookup_flash_blocks(None, meta.H, q.shape[1],
                                         q.shape[2], meta.causal, "cuda")


def _run(which, ptrs, q, meta, pair):
    """Launch kernel `which` at the build `pair` resolves to (the table's
    pair when `pair` is None) and count it."""
    BH, S, D = q.shape
    if pair is None:
        pair = _table_pair(q, meta)
    bq, bk = resolve_build(which, D, q.dtype, pair)
    rate = float(meta.rate)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _kernel_lib()
    fn_name = f"flash_attention_{which}"
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn_name)(
            *[ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in ptrs],
            BH, meta.H, meta.Hk, S, D, meta.Bm, meta.Hm, meta.scale,
            int(meta.causal) | (2 if rate > 0 else 0), _threshold(rate),
            float(1.0 - rate), int(meta.seed) & _M32, _DTYPES[q.dtype],
            bq, bk, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (cudaError {rc})")
    build = (which, bq, bk)
    launches_by_build[build] = launches_by_build.get(build, 0) + 1


# ------------------------------------------------------------ custom ops
def _seed_arg(meta):
    """Meta.seed as the ops take it: None without dropout, else a 0-d
    int64 CPU tensor."""
    if meta.rate <= 0.0:
        return None
    s = meta.seed
    if isinstance(s, torch.Tensor):
        return s
    return torch.tensor(int(s), dtype=torch.int64)


def _dense(t):
    """t as the kernels read it: contiguous and 16-byte aligned (copied
    if not). The Python wrappers hand the ops contiguous rows; a program
    traced over dynamic shapes may not, because whether a reshape copies
    is decided by the sizes it runs at (at batch 1 a head-major reshape
    is a strided view)."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _meta(H, Hk, Bm, Hm, causal, scale, rate, seed):
    """The ops' scalar arguments back as a Meta with an int seed (read on
    the host: the seed tensor lives on the CPU)."""
    if seed is not None and seed.device.type != "cpu":
        raise ValueError("flash_attention: the dropout seed must be a CPU "
                         "tensor (reading a device seed would sync)")
    return Meta(H=H, Hk=Hk, Bm=Bm, Hm=Hm, causal=causal, scale=scale,
                rate=rate, seed=0 if seed is None else int(seed))


def tiled_fwd(q, k, v, mask, meta, pair=None):
    """The forward on CUDA tensors at the build `pair` resolves to (the
    tile table's pair where `pair` is None); the plain version on CPU
    tensors. Returns (O, lse [BH,S] f32)."""
    global launches_fwd
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, mask, meta)
    q, k, v, mask = (_dense(t) for t in (q, k, v, mask))
    _check_kernel_args("fwd", q, k, v, mask, ())
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _run("fwd", [q, k, v, mask, o, lse], q, meta, pair)
    launches_fwd += 1
    return o, lse


def tiled_dq(q, k, v, do, lse, delta, mask, meta, pair=None):
    """dQ at the build `pair` resolves to (as `tiled_fwd`)."""
    global launches_dq
    if q.device.type == "cpu":
        return dq_plain(q, k, v, do, lse, delta, mask, meta)
    q, k, v, do, lse, delta, mask = (_dense(t) for t in
                                     (q, k, v, do, lse, delta, mask))
    _check_kernel_args("dq", q, k, v, mask, (do, lse, delta))
    dq = torch.empty_like(q)
    _run("dq", [q, k, v, do, lse, delta, mask, dq], q, meta, pair)
    launches_dq += 1
    return dq


def tiled_dkv(q, k, v, do, lse, delta, mask, meta, pair=None):
    """dK, dV per query head at the build `pair` resolves to (as
    `tiled_fwd`)."""
    global launches_dkv
    if q.device.type == "cpu":
        return dkv_plain(q, k, v, do, lse, delta, mask, meta)
    q, k, v, do, lse, delta, mask = (_dense(t) for t in
                                     (q, k, v, do, lse, delta, mask))
    _check_kernel_args("dkv", q, k, v, mask, (do, lse, delta))
    dk = torch.empty(q.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    _run("dkv", [q, k, v, do, lse, delta, mask, dk, dv], q, meta, pair)
    launches_dkv += 1
    return dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], H: int, Hk: int, Bm: int,
                  Hm: int, causal: bool, scale: float, rate: float,
                  seed: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return tiled_fwd(q, k, v, mask,
                     _meta(H, Hk, Bm, Hm, causal, scale, rate, seed))


@_flash_fwd_op.register_fake
def _(q, k, v, mask, H, Hk, Bm, Hm, causal, scale, rate, seed):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 mask: Optional[torch.Tensor], H: int, Hk: int, Bm: int,
                 Hm: int, causal: bool, scale: float, rate: float,
                 seed: Optional[torch.Tensor]) -> torch.Tensor:
    return tiled_dq(q, k, v, do, lse, delta, mask,
                    _meta(H, Hk, Bm, Hm, causal, scale, rate, seed))


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, mask, H, Hk, Bm, Hm, causal, scale, rate,
      seed):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  mask: Optional[torch.Tensor], H: int, Hk: int, Bm: int,
                  Hm: int, causal: bool, scale: float, rate: float,
                  seed: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return tiled_dkv(q, k, v, do, lse, delta, mask,
                     _meta(H, Hk, Bm, Hm, causal, scale, rate, seed))


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, mask, H, Hk, Bm, Hm, causal, scale, rate,
      seed):
    return (q.new_empty(q.shape, dtype=k.dtype),
            q.new_empty(q.shape, dtype=v.dtype))


def _scalars(name, q, k, v, mask, extra, meta):
    """The ops' scalar arguments. A tensor on neither the CPU nor CUDA
    (the meta device, whose calls would take the ops' fake versions) is
    refused here, before anything runs."""
    if q.device.type not in ("cpu", "cuda"):
        _check_kernel_args(name, q, k, v, mask, extra)
    return (meta.H, meta.Hk, meta.Bm, meta.Hm, bool(meta.causal),
            float(meta.scale), float(meta.rate), _seed_arg(meta))


def flash_fwd(q, k, v, mask, meta):
    """Forward: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors (the op `paddle_tpu_torch::flash_fwd`). Returns (O, lse [BH,S]
    f32)."""
    return torch.ops.paddle_tpu_torch.flash_fwd(
        q, k, v, mask, *_scalars("fwd", q, k, v, mask, (), meta))


def flash_dq(q, k, v, do, lse, delta, mask, meta):
    """dQ: the CUDA kernel on CUDA tensors, the plain version on CPU (the
    op `paddle_tpu_torch::flash_dq`)."""
    return torch.ops.paddle_tpu_torch.flash_dq(
        q, k, v, do, lse, delta, mask,
        *_scalars("dq", q, k, v, mask, (do, lse, delta), meta))


def flash_dkv(q, k, v, do, lse, delta, mask, meta):
    """dK, dV per query head: the CUDA kernel on CUDA tensors, the plain
    version on CPU (the op `paddle_tpu_torch::flash_dkv`)."""
    return torch.ops.paddle_tpu_torch.flash_dkv(
        q, k, v, do, lse, delta, mask,
        *_scalars("dkv", q, k, v, mask, (do, lse, delta), meta))


# ---------------------------------------------------------------- autograd
class _Flash(torch.autograd.Function):
    """O = attention(q, k, v) on flattened [B*H, S, D] rows; the backward
    runs dQ and dK/dV and sums dK/dV over the GQA group."""

    @staticmethod
    def forward(ctx, q, k, v, mask, meta):
        o, lse = flash_fwd(q, k, v, mask, meta)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.meta = meta
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        meta = ctx.meta
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, mask, meta)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, mask, meta)
        if meta.Hk != meta.H:
            g = meta.H // meta.Hk
            dk = dk.reshape(-1, meta.Hk, g, *dk.shape[1:]).sum(2) \
                .reshape(k.shape)
            dv = dv.reshape(-1, meta.Hk, g, *dv.shape[1:]).sum(2) \
                .reshape(v.shape)
        return dq, dk, dv, None, None


def _one(n):
    return isinstance(n, int) and n == 1


def _flatten_mask(mask, B, H, S):
    if mask is None:
        return None, 1, 1
    while mask.dim() < 4:
        mask = mask[None]
    Bm, Hm = mask.shape[0], mask.shape[1]
    # `_one` tests for a concrete 1 only: comparing a symbolic batch size
    # (a torch.export trace's dynamic dim) with 1 would pin its range
    if mask.dim() != 4 or not (_one(Bm) or Bm == B) \
            or not (_one(Hm) or Hm == H) \
            or any(not (_one(n) or n == S) for n in mask.shape[2:]):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not broadcast "
                         f"to (B={B}, H={H}, {S}, {S})")
    # a key-padding [B, 1, 1, S] or causal [S, S] mask is expanded over its
    # query and key axes only: one (S, S) plane per batch row, never per
    # head, in one copy (the cast, where there is one, writes it)
    mask = mask.detach().broadcast_to((Bm, Hm, S, S)).float()
    return mask.reshape(Bm * Hm, S, S).contiguous(), Bm, Hm


def flash_attention_bhsd(q, k, v, causal=False, scale=None, mask=None,
                         dropout_rate=0.0, dropout_seed=None):
    """q: (B, H, S, D); k/v: (B, Hk, S, D) with Hk dividing H. mask is
    additive and broadcasts from (B|1, H|1, S|1, S|1); dropout_rate > 0
    needs dropout_seed (an int32 value, or a 0-d int64 CPU tensor).
    Returns (B, H, S, D) in q's dtype. Without autograd (grad mode off,
    or no input requiring grad) the forward op is called directly, which
    is what `torch.export` records; otherwise `_Flash` wraps the three
    ops."""
    B, H, S, D = q.shape
    Hk = k.shape[1]
    if H % Hk:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hk}")
    if tuple(k.shape) != (B, Hk, S, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    mf, Bm, Hm = _flatten_mask(mask, B, H, S)
    if rate <= 0.0:
        seed = 0
    elif isinstance(dropout_seed, torch.Tensor):
        seed = dropout_seed
    else:
        seed = int(dropout_seed)
    meta = Meta(H=H, Hk=Hk, Bm=Bm, Hm=Hm, causal=bool(causal),
                scale=float(scale), rate=rate, seed=seed)
    args = (q.reshape(B * H, S, D).contiguous(),
            k.reshape(B * Hk, S, D).contiguous(),
            v.reshape(B * Hk, S, D).contiguous(), mf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = _Flash.apply(*args, meta)
    else:
        o = flash_fwd(*args, meta)[0]
    return o.reshape(B, H, S, D)


def reference_attention_bhsd(q, k, v, causal=False, scale=None, mask=None,
                             dropout_rate=0.0, dropout_seed=None):
    """Dense attention with autograd: the port of the JAX package's XLA
    path `_ref_attention_bhsd`, which runs where its kernels do not (its
    escape hatch `PADDLE_TPU_DISABLE_PALLAS_FLASH`). Softmax with -inf
    causal fill, NaN rows set to 0, P cast to q's dtype. Same layout and
    arguments as `flash_attention_bhsd`; no kernel is involved."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        while mask.dim() < 4:
            mask = mask[None]
        s = s + mask.float()
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        cm = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device) \
            .tril(Sk - Sq)
        s = s.masked_fill(~cm, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p).to(q.dtype)
    if dropout_rate > 0.0:
        B, H, Sq, Sk = p.shape
        keep = dropout_keep(
            dropout_seed,
            torch.arange(B * H, device=q.device).reshape(B, H, 1, 1),
            torch.arange(Sq, device=q.device)[:, None],
            torch.arange(Sk, device=q.device)[None, :], dropout_rate)
        p = _drop(p, keep, dropout_rate).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention_bshd(q, k, v, causal=False, scale=None, mask=None,
                         dropout_rate=0.0, dropout_seed=None):
    """q: (B, S, H, D); k/v: (B, S, Hk, D). Returns (B, S, H, D)."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal, scale=scale,
                               mask=mask, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    return out.transpose(1, 2)
