"""Paged attention: the wrapper of the hand-written CUDA kernel
`csrc/paged_attention.cu`.

Replaces `paddle_tpu/ops/pallas/paged_attention.py` (`paged_attention`,
the Pallas TPU kernel `_kernel`), float and int8 modes. The block table is
walked inside the kernel, so the dense per-slot K/V view of
`serving.blocks.attend` is never built.

Dispatch is by the device of the tensors and nothing else:
  * CPU tensors run the plain PyTorch version (`blocks.attend`, or
    `blocks.attend_quant` for int8 pools) — what the CPU tests compare
    against the JAX package;
  * CUDA tensors launch the kernel or raise. There is no fallback.

At T = 1 (decode) the kernel splits each slot's KV length into splits of
`decode_split_keys()` keys (a constant of the kernel), one thread block
each, and merges the splits' partial softmax states inside the same
launch. The grid follows the table's capacity, never `pos`, so no host
read of `pos` is needed.
`attend_split_plain` is a plain model of that split-and-merge arithmetic
for the tests; the main path never calls it.

At T > 1 (prefill tiles, and the speculative verify window at T =
gamma+1) the kernel runs one block per (slot, head, 16-row query tile).

`launches` counts kernel launches (CPU calls do not count), so a run can
show that its main path went through the kernel; `launches_window` counts
those of them at T > 1.
"""
import ctypes

import torch

__all__ = ["paged_attention", "attend_split_plain", "decode_split_keys",
           "launches", "launches_window", "SUPPORTED_HEAD_DIMS"]

launches = 0
launches_window = 0

SUPPORTED_HEAD_DIMS = (64,)
_MAX_SMEM = 232448             # bytes a block may use on sm_90
_MODES = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16): 1,
          (torch.float32, torch.int8): 2}
_lib = None
_split = None                  # keys of one decode split, read from _lib
_tickets = {}                  # (device, stream) -> int32 counters, zero
                               # between calls


def _kernel_lib():
    global _lib, _split
    if _lib is None:
        from .._kernels import build
        lib = build.load("paged_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp,        # q k v ks vs tables pos out
            vp, vp,                                # partials tickets
            ci, ci, ci, ci, ci, ci,                # S T H D bs nb
            cf, cf, ci, vp]                        # scale qmax mode stream
        lib.paged_attention_fwd.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ci
        lib.paged_attention_decode_split.argtypes = []
        lib.paged_attention_decode_split.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _split = lib.paged_attention_decode_split()
        _lib = lib
    return _lib


def _check_guards(k_pool, v_pool, k_scale, v_scale):
    """The JAX wrapper's guards: scales come in pairs, scales only with
    int8 pools, and int8 pools only with scales (attention over raw codes
    is finite, plausible and wrong)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized paged attention needs BOTH k_scale "
                         "and v_scale (or neither)")
    quant = k_scale is not None
    int8 = (k_pool.dtype == torch.int8, v_pool.dtype == torch.int8)
    if quant and not all(int8):
        raise ValueError(f"scales given but pool dtypes are "
                         f"{k_pool.dtype}/{v_pool.dtype}, want int8")
    if not quant and any(int8):
        raise ValueError("int8 pools need k_scale AND v_scale")
    return quant


def paged_attention(q, k_pool, v_pool, tables, pos, scale=None,
                    k_scale=None, v_scale=None, qmax=127.0):
    """Block-table attention without the dense gather.

    q [S, T, H, D]: query tokens at positions pos..pos+T-1 of their slot;
    k_pool/v_pool [N, bs, H, D]; tables [S, nb] int32 (0 = garbage block);
    pos [S] int32. With k_scale/v_scale ([N, H] f32) the pools are int8
    and dequantize in the kernel as `code * (scale / qmax)`. Returns
    [S, T, H, D] in q's dtype.

    On CUDA, decode calls (T = 1) merge their splits through ticket
    counters kept per (device, stream): calls on one stream run in
    order, so they may share them. A call captured in a CUDA graph takes
    the counters of the capturing stream, and every replay must then run
    in order on one stream too."""
    quant = _check_guards(k_pool, v_pool, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    operands = [q, k_pool, v_pool, tables, pos] + \
        ([k_scale, v_scale] if quant else [])
    if q.device.type == "cpu":
        if any(t.device.type != "cpu" for t in operands):
            raise ValueError("paged_attention: q is on the CPU but other "
                             "operands are not")
        from ..serving import blocks
        if quant:
            return blocks.attend_quant(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, pos, scale)
        return blocks.attend(q, k_pool, v_pool, tables, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, tables, pos, float(scale), k_scale,
                   v_scale, float(qmax), quant, operands)


def _launch(q, k_pool, v_pool, tables, pos, scale, k_scale, v_scale, qmax,
            quant, operands):
    global launches, launches_window
    if any(t.device != q.device for t in operands):
        raise ValueError("paged_attention: every operand must be on "
                         f"{q.device}")
    if any(not t.is_contiguous() for t in operands):
        raise ValueError("paged_attention: operands must be contiguous")
    mode = _MODES.get((q.dtype, k_pool.dtype))
    if mode is None or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: unsupported dtypes q={q.dtype} "
                        f"pools={k_pool.dtype}/{v_pool.dtype}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention: tables and pos must be int32")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError("paged_attention: scales must be float32")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("paged_attention: q [S,T,H,D] and pools "
                         "[N,bs,H,D] expected")
    S, T, H, D = q.shape
    N, bs = k_pool.shape[0], k_pool.shape[1]
    if tuple(k_pool.shape[2:]) != (H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q heads/dim "
                         f"({H}, {D})")
    if tables.dim() != 2 or tables.shape[0] != S or tuple(pos.shape) != (S,):
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} / "
                         f"pos {tuple(pos.shape)} do not match {S} slots")
    if quant and (tuple(k_scale.shape) != (N, H)
                  or tuple(v_scale.shape) != (N, H)):
        raise ValueError("paged_attention: scales must be [N, H]")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    out = torch.empty_like(q)
    nb = tables.shape[1]
    if S == 0 or T == 0 or nb == 0:
        return out.zero_()
    lib = _kernel_lib()
    smem = lib.paged_attention_smem_bytes(T, D, mode)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: head_dim {D} needs {smem} bytes "
                         "of shared memory")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials = tickets = None
    if T == 1:
        n_split = -(-nb * bs // _split)
        partials = torch.empty((S, H, n_split, D + 2), dtype=torch.float32,
                               device=q.device)
        tickets = _ticket_counters(q.device, stream, S * H)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_fwd(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale),
            ptr(tables), ptr(pos), ptr(out), ptr(partials), ptr(tickets),
            S, T, H, D, bs, nb, scale, qmax, mode,
            ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    if T > 1:
        launches_window += 1
    return out


def _ticket_counters(device, stream, n):
    """The decode kernel's per-(slot, head) tickets for launches on
    `stream` of `device`: zeroed once when made (or grown), and left at
    zero by every launch, so no call pays a memset. Keyed by stream, so
    the launches that share them run in stream order."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def decode_split_keys():
    """Keys of one decode split of the CUDA kernel (builds the kernel
    library on first use)."""
    _kernel_lib()
    return _split


def attend_split_plain(q, k_pool, v_pool, tables, pos, split, scale=None,
                       k_scale=None, v_scale=None, qmax=127.0):
    """Plain model of the decode kernel's split-and-merge arithmetic, for
    the tests (the main path never calls it), at T = 1 only, as the kernel
    splits only decode calls: the dense view of each slot is cut into
    splits of `split` keys; each split keeps its own softmax
    state (m, l, acc), with m = -1e30, l = 0, acc = 0 where it sees no key;
    the splits merge in split order with weight exp(m_i - m), exactly 0
    for a split that saw nothing. Same masking as `blocks.attend` (-1e30
    fill, p = 0 at or below -0.5e30, V rows past the last visible position
    selected to 0, rows with no visible key exact zeros). q [S, 1, H, D];
    int8 pools take k_scale/v_scale and dequantize as
    `code * (scale / qmax)`. Returns [S, 1, H, D] in f32."""
    from ..serving import blocks
    from ..serving.kv_cache import MASK_VALUE
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError("attend_split_plain models the decode kernel: "
                         f"q [S, 1, H, D] expected, got {tuple(q.shape)}")
    if _check_guards(k_pool, v_pool, k_scale, v_scale):
        k = blocks.gather_quant(k_pool, k_scale, tables)
        v = blocks.gather_quant(v_pool, v_scale, tables)
    else:
        k = blocks.gather(k_pool, tables).float()
        v = blocks.gather(v_pool, tables).float()
    S, _, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    L = k.shape[1]
    n_split = -(-L // split)
    pad = n_split * split - L
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cols = torch.arange(n_split * split, device=q.device)
    visible = (cols[None, :] <= pos.to(torch.int64)[:, None]) \
        & (cols < L)[None, :]                                    # [S, Lp]
    sc = torch.einsum("shd,slhd->shl", q[:, 0].float(), k) * scale
    sc = sc.masked_fill(~visible[:, None], MASK_VALUE)
    sc = sc.reshape(S, H, n_split, split)
    v = v.masked_fill(~visible[:, :, None, None], 0.0)
    v = v.reshape(S, n_split, split, H, D)
    m_i = sc.amax(-1)                                            # [S, H, n]
    p = torch.exp(sc - m_i[..., None]).masked_fill(
        sc <= 0.5 * MASK_VALUE, 0.0)
    l_i = p.sum(-1)
    acc_i = torch.einsum("shnk,snkhd->shnd", p, v)
    w = torch.exp(m_i - m_i.amax(-1, keepdim=True)).masked_fill(
        m_i <= 0.5 * MASK_VALUE, 0.0)
    l_sum = (l_i * w).sum(-1)
    acc = (acc_i * w[..., None]).sum(-2)
    out = acc / l_sum.masked_fill(l_sum == 0, 1.0)[..., None]
    return out[:, None]
