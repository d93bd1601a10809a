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

Three launch shapes, each a kernel of its own, all split over the KV
length with the splits' partial softmax states merged inside the same
launch; the grid follows the table's capacity, never `pos`, so no host
read of `pos` is needed:
  * T = 1 (decode): one block per (split of `decode_split_keys()` keys,
    head, slot);
  * T = 2..WINDOW_ROWS (speculative verify windows, T = gamma+1): the
    same split, with the window's T query rows in every block;
  * T > WINDOW_ROWS (prefill buckets): one block per (split, tile of 64
    query rows, head, slot).
`attend_split_plain` is a plain model of the split-and-merge arithmetic of
the first two, for the tests; the main path never calls it.

`launches` counts kernel launches (CPU calls do not count), so a run can
show that its main path went through the kernel; `launches_window` counts
those of them at T = 2..WINDOW_ROWS and `launches_prefill` those above.
"""
import ctypes

import torch

__all__ = ["paged_attention", "attend_split_plain", "decode_split_keys",
           "launches", "launches_window", "launches_prefill",
           "SUPPORTED_HEAD_DIMS", "WINDOW_ROWS"]

launches = 0
launches_window = 0
launches_prefill = 0

# most query rows of the window path (`kWindowRows` of the kernel source);
# longer calls run the tile path
WINDOW_ROWS = 16

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
        lib = bind(build.load("paged_attention"))
        _split = lib.paged_attention_decode_split()
        _lib = lib
    return _lib


def bind(lib):
    """Declare the C interface of a built `csrc/paged_attention.cu` on its
    ctypes library (also used to load variants of the source built with
    other constants); returns `lib`."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.paged_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp,        # q k v ks vs tables pos out
        vp, vp,                                # partials tickets
        ci, ci, ci, ci, ci, ci,                # S T H D bs nb
        cf, cf, ci, vp]                        # scale qmax mode stream
    lib.paged_attention_fwd.restype = ci
    lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci]
    lib.paged_attention_smem_bytes.restype = ci
    lib.paged_attention_partial_floats.argtypes = [ci] * 6
    lib.paged_attention_partial_floats.restype = ll
    lib.paged_attention_ticket_count.argtypes = [ci, ci, ci]
    lib.paged_attention_ticket_count.restype = ll
    lib.paged_attention_decode_split.argtypes = []
    lib.paged_attention_decode_split.restype = ci
    lib.paged_attention_window_rows.argtypes = []
    lib.paged_attention_window_rows.restype = ci
    lib.paged_attention_error_string.argtypes = [ci]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    if lib.paged_attention_window_rows() != WINDOW_ROWS:
        raise RuntimeError("paged_attention: the kernel's window limit "
                           f"{lib.paged_attention_window_rows()} is not "
                           f"WINDOW_ROWS = {WINDOW_ROWS}")
    return lib


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

    On CUDA, every call merges its splits through ticket counters kept
    per (device, stream): calls on one stream run in order, so they may
    share them. A call captured in a CUDA graph takes
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
    global launches, launches_window, launches_prefill
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
    partials = torch.empty(
        (lib.paged_attention_partial_floats(S, T, H, D, bs, nb),),
        dtype=torch.float32, device=q.device)
    tickets = _ticket_counters(q.device, stream,
                               lib.paged_attention_ticket_count(S, T, H))

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
    if T > WINDOW_ROWS:
        launches_prefill += 1
    elif T > 1:
        launches_window += 1
    return out


def _ticket_counters(device, stream, n):
    """The kernels' tickets (one per (slot, head), or per (slot, head,
    tile) on the tile path) for launches on `stream` of `device`: zeroed
    once when made (or grown), and left at zero by every launch, so no
    call pays a memset. Keyed by stream, so
    the launches that share them run in stream order."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def decode_split_keys():
    """Keys of one split of the CUDA decode and window kernels (builds
    the kernel library on first use)."""
    _kernel_lib()
    return _split


def attend_split_plain(q, k_pool, v_pool, tables, pos, split, scale=None,
                       k_scale=None, v_scale=None, qmax=127.0):
    """Plain model of the split-and-merge arithmetic of the decode and
    window kernels, for the tests (the main path never calls it), at T =
    1..WINDOW_ROWS: the dense view of each slot is cut into splits of
    `split` keys; each split keeps its own softmax state (m, l, acc) for
    every query row, with m = -1e30, l = 0, acc = 0 where the row sees no
    key of it; the splits merge in split order with weight exp(m_i - m),
    exactly 0 for a split that saw nothing. Same masking as
    `blocks.attend` (key j visible to row i iff j <= pos + i, -1e30 fill,
    p = 0 at or below -0.5e30, V rows past pos + T - 1 selected to 0,
    rows with no visible key exact zeros). q [S, T, H, D]; int8 pools
    take k_scale/v_scale and dequantize as `code * (scale / qmax)`.
    Returns [S, T, H, D] in f32."""
    from ..serving import blocks
    from ..serving.kv_cache import MASK_VALUE
    if q.dim() != 4 or not 1 <= q.shape[1] <= WINDOW_ROWS:
        raise ValueError("attend_split_plain models the decode and window "
                         f"kernels: q [S, T, H, D] with T <= {WINDOW_ROWS} "
                         f"expected, got {tuple(q.shape)}")
    if _check_guards(k_pool, v_pool, k_scale, v_scale):
        k = blocks.gather_quant(k_pool, k_scale, tables)
        v = blocks.gather_quant(v_pool, v_scale, tables)
    else:
        k = blocks.gather(k_pool, tables).float()
        v = blocks.gather(v_pool, tables).float()
    S, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    L = k.shape[1]
    n_split = -(-L // split)
    pad = n_split * split - L
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cols = torch.arange(n_split * split, device=q.device)
    limit = pos.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    visible = (cols[None, None, :] <= limit[:, :, None]) \
        & (cols < L)[None, None, :]                              # [S, T, Lp]
    ever = visible[:, -1]                                        # [S, Lp]
    sc = torch.einsum("sthd,slhd->shtl", q.float(), k) * scale
    sc = sc.masked_fill(~visible[:, None], MASK_VALUE)
    sc = sc.reshape(S, H, T, n_split, split)
    v = v.masked_fill(~ever[:, :, None, None], 0.0)
    v = v.reshape(S, n_split, split, H, D)
    m_i = sc.amax(-1)                                         # [S, H, T, n]
    p = torch.exp(sc - m_i[..., None]).masked_fill(
        sc <= 0.5 * MASK_VALUE, 0.0)
    l_i = p.sum(-1)
    acc_i = torch.einsum("shtnk,snkhd->shtnd", p, v)
    w = torch.exp(m_i - m_i.amax(-1, keepdim=True)).masked_fill(
        m_i <= 0.5 * MASK_VALUE, 0.0)
    l_sum = (l_i * w).sum(-1)
    acc = (acc_i * w[..., None]).sum(-2)                      # [S, H, T, D]
    out = acc / l_sum.masked_fill(l_sum == 0, 1.0)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()
