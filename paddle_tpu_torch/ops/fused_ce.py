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
The vocab-parallel (`axis_name`) mode takes the ranks of the mp group as
lists (one controller drives them all; `parallel/collectives.py`).
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


def _chunk_stats(h, wte, li, num_chunks):
    """Running max, sum of exponentials and the label's logit over the
    vocab chunks of `wte` (li: labels local to these rows; an id outside
    them picks nothing)."""
    T = h.shape[0]
    Vc = wte.shape[0] // num_chunks
    m = torch.full((T,), float("-inf"), device=h.device)
    s = torch.zeros((T,), device=h.device)
    picked = torch.zeros((T,), device=h.device)
    for c in range(num_chunks):
        lg = matmul_f32(h, wte[c * Vc:(c + 1) * Vc].t())          # (T, Vc)
        nm = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - nm) + torch.exp(lg - nm[:, None]).sum(-1)
        lid = li - c * Vc
        ok = (lid >= 0) & (lid < Vc)
        pk = lg.gather(1, lid.clamp(0, Vc - 1)[:, None])[:, 0]
        picked = torch.where(ok, pk, picked)
        m = nm
    return m, s, picked


def _chunk_grads(h, wte, li, logz, g, num_chunks):
    """dh (f32) and dwte of the chunked loss, recomputing each chunk's
    logits; the cotangent is cast to the operand dtype before the two
    products."""
    Vc = wte.shape[0] // num_chunks
    gf = g.float()
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty_like(wte)
    cols = torch.arange(Vc, device=h.device)
    for c in range(num_chunks):
        wc = wte[c * Vc:(c + 1) * Vc]
        lg = matmul_f32(h, wc.t())                               # recompute
        p = torch.exp(lg - logz[:, None])
        lid = li - c * Vc
        ok = (lid >= 0) & (lid < Vc)
        onehot = (lid.clamp(0, Vc - 1)[:, None] == cols[None, :]) \
            & ok[:, None]
        coeff = (gf[:, None] * (p - onehot.float())).to(h.dtype)
        dh += matmul_f32(coeff, wc)
        dw[c * Vc:(c + 1) * Vc] = matmul_f32(coeff.t(), h).to(wte.dtype)
    return dh, dw


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, wte, labels, num_chunks):
        li = labels.long()
        m, s, picked = _chunk_stats(h, wte, li, num_chunks)
        logz = m + torch.log(s)
        ctx.save_for_backward(h, wte, li, logz)
        ctx.num_chunks = num_chunks
        return logz - picked

    @staticmethod
    def backward(ctx, g):
        h, wte, li, logz = ctx.saved_tensors
        dh, dw = _chunk_grads(h, wte, li, logz, g, ctx.num_chunks)
        return dh.to(h.dtype), dw, None, None


class _FusedCEVocabParallel(torch.autograd.Function):
    """The JAX op with `axis_name`, over the n ranks of the group at once:
    inputs h_0..h_{n-1}, wte_0..wte_{n-1} (rank i's rows [i * V_loc,
    (i + 1) * V_loc)), then the labels (global ids); one full per-token
    loss a rank. The backward is each rank's own: dh stays partial (this
    rank's vocab rows), for the caller's `mp_copy` to sum."""

    @staticmethod
    def forward(ctx, num_chunks, n, *args):
        hs, wtes, labels = args[:n], args[n:2 * n], args[2 * n:]
        stats, lis = [], []
        for i, (h, wte, lab) in enumerate(zip(hs, wtes, labels)):
            # local ids, possibly outside this rank's rows: masked per chunk
            li = lab.long() - i * wte.shape[0]
            lis.append(li)
            stats.append(_chunk_stats(h, wte, li, num_chunks))
        out, saved = [], []
        for i, h in enumerate(hs):
            dev = h.device
            gm = stats[0][0].to(dev)
            for m, _, _ in stats[1:]:
                gm = torch.maximum(gm, m.to(dev))
            s = torch.zeros_like(gm)
            picked = torch.zeros_like(gm)
            for m, sj, pj in stats:
                s = s + (sj * torch.exp(m - gm.to(m.device))).to(dev)
                picked = picked + pj.to(dev)    # one rank owns each label
            logz = gm + torch.log(s)
            out.append(logz - picked)
            saved += [h, wtes[i], lis[i], logz]
        ctx.save_for_backward(*saved)
        ctx.num_chunks, ctx.n = num_chunks, n
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        dhs, dws = [], []
        for i, g in enumerate(gs):
            h, wte, li, logz = saved[4 * i:4 * i + 4]
            dh, dw = _chunk_grads(h, wte, li, logz, g, ctx.num_chunks)
            dhs.append(dh.to(h.dtype))
            dws.append(dw)
        return (None, None, *dhs, *dws) + (None,) * ctx.n


def fused_linear_cross_entropy(h, wte, labels, num_chunks):
    """Per-token NLL of softmax(h @ wte^T) at `labels`, chunked over vocab.

    h: (T, H); wte: (V, H) with V % num_chunks == 0; labels: (T,) int.
    Returns (T,) f32.

    Vocab-parallel mode (the JAX op's `axis_name`): h, wte and labels are
    lists over the ranks of the mp group, in axis order. Rank i holds
    h_i (T, H), its vocab rows wte_i (V/n, H) and the global label ids;
    the softmax statistics cross the ranks (max and sum of exponentials
    of every chunk, the label's logit from the rank that owns it). Returns
    one full (T,) loss a rank; each rank's dh is its partial part, which
    the caller's `mp_copy` completes in the backward."""
    if isinstance(h, (list, tuple)):
        n = len(h)
        if not (len(wte) == len(labels) == n):
            raise ValueError("fused_linear_cross_entropy: h, wte and labels "
                             "must list the same ranks")
        _check_chunks(wte[0].shape[0], num_chunks)
        return list(_FusedCEVocabParallel.apply(int(num_chunks), n, *h,
                                                *wte, *labels))
    _check_chunks(wte.shape[0], num_chunks)
    return _FusedCE.apply(h, wte, labels, int(num_chunks))


def _check_chunks(V, num_chunks):
    if V % num_chunks:
        raise ValueError(
            f"(InvalidArgument) fused_linear_cross_entropy: vocab {V} "
            f"not divisible by num_chunks {num_chunks}")
