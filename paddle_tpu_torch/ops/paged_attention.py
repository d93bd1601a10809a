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

`launches` counts kernel launches (CPU calls do not count), so a run can
show that its main path went through the kernel.
"""
import ctypes

import torch

__all__ = ["paged_attention", "launches", "SUPPORTED_HEAD_DIMS"]

launches = 0

SUPPORTED_HEAD_DIMS = (64,)
_MAX_SMEM = 232448             # bytes a block may use on sm_90
_MODES = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16): 1,
          (torch.float32, torch.int8): 2}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .._kernels import build
        lib = build.load("paged_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp,        # q k v ks vs tables pos out
            ci, ci, ci, ci, ci, ci,                # S T H D bs nb
            cf, cf, ci, vp]                        # scale qmax mode stream
        lib.paged_attention_fwd.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
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
    [S, T, H, D] in q's dtype."""
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
    global launches
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
    smem = lib.paged_attention_smem_bytes(T, D, bs)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: block_size {bs} at head_dim "
                         f"{D} needs {smem} bytes of shared memory")
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_fwd(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale),
            ptr(tables), ptr(pos), ptr(out), S, T, H, D, bs, nb, scale,
            qmax, mode, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return out
