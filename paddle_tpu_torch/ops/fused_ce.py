"""Fused linear + softmax cross-entropy over vocab chunks: the port of
`paddle_tpu/ops/fused_ce.py`.

The (tokens, vocab) logits never exist at once: the forward walks the
vocab in `num_chunks` chunks, keeping a running max and sum of exponentials
per token (the flash-attention recurrence applied to the classifier), and
the backward recomputes each chunk's logits from the saved activations.
That saves the f32 logits tensor and its softmax (several GB at the
GPT-350M training shape) for one more logits product in the backward.

The JAX op is a `lax.scan`, not a Pallas kernel, so this port is plain
PyTorch: a Python loop over the chunks. Numerics are the JAX op's: chunk
logits in f32 from operands of any dtype (`matmul_f32`), f32 statistics,
and backward cotangents cast to the operand dtype before the two products.
The vocab-parallel (`axis_name`) mode waits for the multi-GPU slice; at one
device the op has no such argument.
"""
import torch

__all__ = ["fused_linear_cross_entropy", "matmul_f32"]


def matmul_f32(a, b):
    """a @ b with f32 output from operands of one dtype, accumulated in
    f32: the JAX package's `preferred_element_type=float32` products.

    bf16 operands on CUDA take `torch.mm(..., out_dtype=torch.float32)`
    (bf16 tensor-core rate, the f32 result never rounded to bf16); on the
    CPU, and for f32 operands, the product runs in f32. A plain bf16
    matmul would round 50304-wide logits to bf16 and change the loss;
    upcasting the operands on the card would run the model's largest
    product at the f32 rate. The cost, at the GPT-350M step's logits
    product (8192 x 1024 x 50304) on an NVIDIA H100 80GB HBM3 at 700 W
    (`chip_smoke.py` phase 8): 1.345 ms, against 1.144 ms for the
    bf16-result matmul and 16.66 ms with f32 operands."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, wte, labels, num_chunks):
        T, H = h.shape
        V = wte.shape[0]
        Vc = V // num_chunks
        li = labels.long()
        m = torch.full((T,), float("-inf"), device=h.device)
        s = torch.zeros((T,), device=h.device)
        picked = torch.zeros((T,), device=h.device)
        for c in range(num_chunks):
            lg = matmul_f32(h, wte[c * Vc:(c + 1) * Vc].t())      # (T, Vc)
            nm = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - nm) + torch.exp(lg - nm[:, None]).sum(-1)
            lid = li - c * Vc
            ok = (lid >= 0) & (lid < Vc)
            pk = lg.gather(1, lid.clamp(0, Vc - 1)[:, None])[:, 0]
            picked = torch.where(ok, pk, picked)
            m = nm
        logz = m + torch.log(s)
        ctx.save_for_backward(h, wte, li, logz)
        ctx.num_chunks = num_chunks
        return logz - picked

    @staticmethod
    def backward(ctx, g):
        h, wte, li, logz = ctx.saved_tensors
        num_chunks = ctx.num_chunks
        V = wte.shape[0]
        Vc = V // num_chunks
        gf = g.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(wte)
        cols = torch.arange(Vc, device=h.device)
        for c in range(num_chunks):
            wc = wte[c * Vc:(c + 1) * Vc]
            lg = matmul_f32(h, wc.t())                           # recompute
            p = torch.exp(lg - logz[:, None])
            lid = li - c * Vc
            ok = (lid >= 0) & (lid < Vc)
            onehot = (lid.clamp(0, Vc - 1)[:, None] == cols[None, :]) \
                & ok[:, None]
            coeff = (gf[:, None] * (p - onehot.float())).to(h.dtype)
            dh += matmul_f32(coeff, wc)
            dw[c * Vc:(c + 1) * Vc] = matmul_f32(coeff.t(), h).to(wte.dtype)
        return dh.to(h.dtype), dw, None, None


def fused_linear_cross_entropy(h, wte, labels, num_chunks):
    """Per-token NLL of softmax(h @ wte^T) at `labels`, chunked over vocab.

    h: (T, H); wte: (V, H) with V % num_chunks == 0; labels: (T,) int.
    Returns (T,) f32."""
    V = wte.shape[0]
    if V % num_chunks:
        raise ValueError(
            f"(InvalidArgument) fused_linear_cross_entropy: vocab {V} "
            f"not divisible by num_chunks {num_chunks}")
    return _FusedCE.apply(h, wte, labels, int(num_chunks))
