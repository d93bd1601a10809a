"""paddle.static.nn (reference: python/paddle/static/nn/__init__.py).

Counterpart of `paddle_tpu/static/nn.py`. The reference's static-graph
layer functions append ops + parameters to a Program. Here "static"
computations are traced functions, so these helpers (a) create the
parameters inline (like the original LayerHelper did) and (b) express
control flow on the rule of `jit/dy2static.py`: concrete predicates run
as plain Python, traced ones lower to the `cond` / `while_loop` HOPs
(the counterparts of the reference's ConditionalBlock / While ops,
paddle/fluid/operators/controlflow/). `switch_case` is a chain of
`cond`s: torch has no switch op.

Sequence ops: the reference's sequence_* family operates on LoDTensors.
Per the LoDTensor policy (PARITY.md), variable-length batches here are
(data, lengths) pairs with padding — each sequence op takes an explicit
`length` argument where the reference read the LoD.
"""
import contextlib

import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor
from ..jit.dy2static import (_as_tensor, is_traced, traced_cond,
                             traced_while)

__all__ = [
    "fc", "batch_norm", "embedding", "bilinear_tensor_product", "case",
    "cond", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "crf_decoding", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "multi_box_head", "nce", "prelu",
    "py_func", "row_conv", "spectral_norm", "switch_case", "while_loop",
    "sparse_embedding", "sequence_conv", "sequence_softmax",
    "sequence_pool", "sequence_concat", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse", "StaticRNN",
]


def _t(x):
    return x if isinstance(x, Tensor) else to_tensor(x)


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _branch(fn, device):
    """A no-operand branch for traced_cond: fn's outputs as tensors."""
    def inner(*_):
        out = fn()
        outs = out if isinstance(out, (list, tuple)) else [out]
        return tuple(_as_tensor(_raw(o), device) for o in outs)
    return inner


def _unpack(outs):
    outs = [Tensor(o) for o in outs]
    return outs if len(outs) > 1 else outs[0]


# --------------------------------------------------------------- control flow
def cond(pred, true_fn=None, false_fn=None, name=None):
    """reference: static/nn/control_flow.py cond -> the cond op under a
    trace, plain python branch eagerly."""
    d = _raw(pred)
    if true_fn is None and false_fn is None:
        return None
    if is_traced(d) and (true_fn is None or false_fn is None):
        # Reference none-branch semantics (static/nn/control_flow.py cond):
        # a None branch contributes no outputs, so the other branch must
        # also return None; the cond then returns None.
        out = (true_fn or false_fn)()
        if out is not None:
            raise ValueError(
                "cond: incompatible branch returns — one branch is None "
                "so the other must return None as well")
        return None
    if is_traced(d):
        return _unpack(traced_cond(d, _branch(true_fn, d.device),
                                   _branch(false_fn, d.device), ()))
    fn = true_fn if bool(np.asarray(_host(d)).reshape(())) else false_fn
    return fn() if fn is not None else None


def _host(d):
    return d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else d


def case(pred_fn_pairs, default=None, name=None):
    """reference: control_flow.py case — first true predicate wins.
    Traced predicates select the index of the first true predicate and
    switch on it (the reference nests ConditionalBlocks)."""
    preds = [_raw(p) for p, _ in pred_fn_pairs]
    if any(is_traced(d) for d in preds):
        stacked = torch.stack([_as_tensor(d, preds[0].device).reshape(())
                               .to(torch.bool) for d in preds])
        # index of first true; all-false selects the default slot
        first = torch.argmax(stacked.to(torch.int64))
        idx = torch.where(torch.any(stacked), first,
                          torch.tensor(len(preds), device=first.device))
        fns = {i: fn for i, (_, fn) in enumerate(pred_fn_pairs)}
        fns[len(preds)] = default if default is not None \
            else pred_fn_pairs[-1][1]
        return switch_case(Tensor(idx), fns)
    for d, (_, fn) in zip(preds, pred_fn_pairs):
        if bool(np.asarray(_host(d)).reshape(())):
            return fn()
    if default is not None:
        return default()
    return pred_fn_pairs[-1][1]()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """reference: control_flow.py switch_case -> a chain of cond ops under
    a trace. An unmatched index takes `default`, or the LAST branch."""
    d = _raw(branch_index)
    if isinstance(branch_fns, (list, tuple)) and \
            isinstance(branch_fns[0], (list, tuple)):
        fns = dict(branch_fns)
    elif isinstance(branch_fns, (list, tuple)):
        fns = dict(enumerate(branch_fns))
    else:
        fns = dict(branch_fns)
    keys = sorted(fns)
    fallback = default if default is not None else fns[keys[-1]]
    if is_traced(d):
        d = d.reshape(())
        dev = d.device

        def chain(i):
            if i == len(keys):
                return _branch(fallback, dev)
            return lambda *_: traced_cond(d == keys[i],
                                          _branch(fns[keys[i]], dev),
                                          chain(i + 1), ())
        return _unpack(chain(0)())
    i = int(np.asarray(_host(d)).reshape(()))
    return fns.get(i, fallback)()


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """reference: control_flow.py while_loop -> the while_loop op (fixed
    shapes) when any loop var is traced; python loop eagerly."""
    datas = [_raw(v) for v in loop_vars]
    wrap = [isinstance(v, Tensor) for v in loop_vars]
    if any(is_traced(d) for d in datas):
        dev = next(d.device for d in datas if is_traced(d))
        init = tuple(_as_tensor(d, dev) for d in datas)

        def to_user(vals):
            return [Tensor(v) if w else v for v, w in zip(vals, wrap)]

        def body(*vals):
            out = body_fn(*to_user(vals))
            return tuple(_as_tensor(_raw(o), dev).to(i.dtype)
                         for o, i in zip(out, vals))

        final = traced_while(lambda *v: cond_fn(*to_user(v)), body, init)
        return [Tensor(v) for v in final]
    vals = list(loop_vars)
    while True:
        c = cond_fn(*vals)          # evaluate ONCE per iteration
        if not bool(np.asarray(_host(_raw(c))).reshape(())):
            break
        vals = list(body_fn(*vals))
    return vals


# ------------------------------------------------- param-creating layer fns
def _param(init, shape, x):
    return Tensor(init(tuple(shape), x.dtype, x._data.device))


def _act(out, act):
    from ..nn import functional as F
    return getattr(F, act)(out) if act else out


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    from ..nn import functional as F
    from ..nn.initializer import XavierUniform
    w = _param(XavierUniform(),
               (int(np.prod(x.shape[num_flatten_dims:])), size), x)
    out = F.linear(x.reshape(list(x.shape[:num_flatten_dims]) + [-1]), w)
    return _act(out, activation)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout="NCHW", **kw):
    from ..nn import BatchNorm1D, BatchNorm2D, BatchNorm3D
    C = input.shape[1] if data_layout.startswith("NC") else input.shape[-1]
    cls = {3: BatchNorm1D, 4: BatchNorm2D, 5: BatchNorm3D}.get(
        len(input.shape), BatchNorm1D)
    bn = cls(C, momentum=momentum, epsilon=epsilon, weight_attr=param_attr,
             bias_attr=bias_attr, data_format=data_layout)
    bn.to(device=input._data.device)
    if is_test:
        bn.eval()
    return _act(bn(input), act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    from ..nn import Embedding
    emb = Embedding(size[0], size[1], padding_idx=padding_idx,
                    weight_attr=param_attr)
    emb.to(device=input._data.device)
    return emb(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..nn import LayerNorm
    ln = LayerNorm(list(input.shape[begin_norm_axis:]), epsilon,
                   param_attr if scale else False,
                   bias_attr if shift else False)
    ln.to(device=input._data.device)
    return _act(ln(input), act)


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None,
                  name=None):
    from ..nn import functional as F
    return F.instance_norm(input, eps=epsilon)


def group_norm(input, groups, epsilon=1e-05, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import GroupNorm
    gn = GroupNorm(groups, input.shape[1], epsilon, param_attr, bias_attr,
                   data_layout)
    gn.to(device=input._data.device)
    return _act(gn(input), act)


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """reference: static/nn/common.py data_norm — normalization by batch
    statistics WITHOUT learned affine (used by CTR models)."""
    def fn(x):
        mean = x.mean(0, keepdim=True)
        var = x.var(0, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + epsilon)
    return _act(apply_op(fn, input), act)


def _conv(cls, input, num_filters, filter_size, stride, padding, dilation,
          groups, param_attr, bias_attr, data_format, act, **kw):
    conv = cls(input.shape[1], num_filters, filter_size, stride, padding,
               dilation=dilation, groups=groups, weight_attr=param_attr,
               bias_attr=bias_attr, data_format=data_format, **kw)
    conv.to(device=input._data.device)
    return _act(conv(input), act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None, use_cudnn=True):
    from ..nn import Conv2D
    return _conv(Conv2D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, param_attr, bias_attr, data_format, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None, use_cudnn=True):
    from ..nn import Conv2DTranspose
    return _conv(Conv2DTranspose, input, num_filters, filter_size, stride,
                 padding, dilation, groups, param_attr, bias_attr,
                 data_format, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None, use_cudnn=True):
    from ..nn import Conv3D
    return _conv(Conv3D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, param_attr, bias_attr, data_format, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", name=None, use_cudnn=True):
    from ..nn import Conv3DTranspose
    return _conv(Conv3DTranspose, input, num_filters, filter_size, stride,
                 padding, dilation, groups, param_attr, bias_attr,
                 data_format, act)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    from ..vision.ops import DeformConv2D
    conv = DeformConv2D(input.shape[1], num_filters, filter_size, stride,
                        padding, dilation, deformable_groups, groups,
                        weight_attr=param_attr, bias_attr=bias_attr)
    conv.to(device=input._data.device)
    return conv(input, offset, mask)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import functional as F
    from ..nn.initializer import Constant
    n = {"all": 1, "channel": x.shape[1], "element":
         int(np.prod(x.shape[1:]))}[mode]
    w = _param(Constant(0.25), (n,), x)
    if mode == "element":
        w = w.reshape(list(x.shape[1:]))
    return F.prelu(x, w, data_format=data_format)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn import SpectralNorm
    sn = SpectralNorm(weight.shape, dim=dim, power_iters=power_iters,
                      eps=eps)
    sn.to(device=weight._data.device)
    return sn(weight)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """reference: static/nn/common.py bilinear_tensor_product:
    out_k = x W_k y^T + b."""
    from ..nn import Bilinear
    bl = Bilinear(x.shape[-1], y.shape[-1], size, weight_attr=param_attr,
                  bias_attr=bias_attr)
    bl.to(device=x._data.device)
    return _act(bl(x, y), act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """reference: operators/row_conv_op.cc (lookahead conv from DeepSpeech2):
    out[t] = sum_{i=0..k} W[i] * in[t+i], per feature channel."""
    from ..nn.initializer import XavierUniform
    D = input.shape[-1]
    k = future_context_size + 1
    w = _param(XavierUniform(), (k, D), input)

    def fn(x, wt):
        # x: (B, T, D) padded forward in time
        xp = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + xp[:, i:i + x.shape[1]] * wt[i][None, None, :]
        return out

    return _act(apply_op(fn, input, w), act)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference: operators/nce_op.cc):
    binary logistic loss on the true class + `num_neg_samples` uniform
    negatives, per example."""
    from ..core.random import generator
    from ..nn.initializer import Constant, XavierUniform
    D = input.shape[-1]
    num_neg = num_neg_samples or 10
    w = _param(XavierUniform(), (num_total_classes, D), input)
    b = _param(Constant(0.0), (num_total_classes,), input)
    dev = input._data.device
    neg = torch.randint(0, num_total_classes, (num_neg,),
                        generator=generator(dev), device=dev)

    def fn(x, lab, wt, bt):
        lab = lab.reshape(-1).to(torch.int64)
        pos_logit = (x * wt[lab]).sum(-1) + bt[lab]
        neg_logit = x @ wt[neg].T + bt[neg][None]          # (B, num_neg)
        pos_loss = torch.nn.functional.softplus(-pos_logit)
        neg_loss = torch.nn.functional.softplus(neg_logit).sum(-1)
        return (pos_loss + neg_loss)[:, None]

    return apply_op(fn, input, label, w, b)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference: static/nn/multi_box_head; op
    prior_box + per-scale loc/conf convs). Returns (mbox_locs, mbox_confs,
    prior_boxes, variances) concatenated over scales."""
    from ..nn import functional as F
    from ..nn.initializer import XavierUniform
    from ..tensor.manipulation import concat
    locs, confs, priors, vars_ = [], [], [], []
    n_in = len(inputs)
    if min_sizes is None:
        # reference ratio interpolation
        min_ratio, max_ratio = min_ratio or 20, max_ratio or 90
        step = int((max_ratio - min_ratio) / max(n_in - 2, 1))
        min_sizes, max_sizes = [base_size * 0.1], [base_size * 0.2]
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = min_sizes[:n_in]
        max_sizes = max_sizes[:n_in]
    H_img = image.shape[2]
    W_img = image.shape[3]
    for i, feat in enumerate(inputs):
        dev = feat._data.device
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        n_prior = len(ar) * (2 if flip else 1) + 2
        B, C, H, W = feat.shape
        # prior boxes: centers on the feature grid, sizes from min/max + ars
        sw = (steps[i] if steps else W_img / W)
        sh = (steps[i] if steps else H_img / H)
        cx = (torch.arange(W, device=dev) + offset) * sw
        cy = (torch.arange(H, device=dev) + offset) * sh
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        sizes = [(min_sizes[i], min_sizes[i]),
                 (float(np.sqrt(min_sizes[i] * max_sizes[i])),) * 2]
        for a in ar:
            for aa in ([a, 1.0 / a] if flip else [a]):
                sizes.append((min_sizes[i] * np.sqrt(aa),
                              min_sizes[i] / np.sqrt(aa)))
        boxes = [torch.stack([(cxg - bw / 2) / W_img, (cyg - bh / 2) / H_img,
                              (cxg + bw / 2) / W_img, (cyg + bh / 2) / H_img],
                             -1) for bw, bh in sizes]
        pb = torch.stack(boxes, 2).reshape(-1, 4).float()  # (H*W*n_prior, 4)
        if clip:
            pb = pb.clamp(0.0, 1.0)
        priors.append(Tensor(pb))
        vars_.append(Tensor(torch.tensor(variance, dtype=pb.dtype,
                                         device=dev).expand(pb.shape)))
        wl = _param(XavierUniform(), (n_prior * 4, C, kernel_size,
                                      kernel_size), feat)
        wc = _param(XavierUniform(), (n_prior * num_classes, C, kernel_size,
                                      kernel_size), feat)
        loc = F.conv2d(feat, wl, stride=stride, padding=pad)
        conf = F.conv2d(feat, wc, stride=stride, padding=pad)
        locs.append(loc.transpose([0, 2, 3, 1]).reshape([B, -1, 4]))
        confs.append(conf.transpose([0, 2, 3, 1]).reshape(
            [B, -1, num_classes]))
    return (concat(locs, axis=1), concat(confs, axis=1),
            concat(priors, axis=0), concat(vars_, axis=0))


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """reference: static/nn/common.py sparse_embedding -> PS-backed lookup
    over the native striped hash table, which the port has not yet
    (ROADMAP A.13g)."""
    raise NotImplementedError(
        "sparse_embedding needs the parameter-server tables "
        "(distributed.ps SparseEmbedding over the native ps_table), which "
        "come with ROADMAP A.13g; use nn.Embedding")


def crf_decoding(input, param_attr, label=None, length=None):
    """reference: operators/crf_decoding_op.h:120-157 — viterbi path over a
    linear-chain CRF. Transition takes the linear_chain_crf layout
    [num_tags + 2, num_tags]: row 0 = start weights, row 1 = stop weights,
    rows 2.. = the square tag->tag block. A square [N, N] transition (no
    start/stop) is also accepted. With `label`, returns the reference's
    1/0 correctness mask over live positions (crf_decoding_op.h:66-78)."""
    from ..text.viterbi import _viterbi
    trans = _t(param_attr)
    B, T, N = input.shape
    dev = input._data.device
    if length is None:
        length = Tensor(torch.full((B,), T, dtype=torch.int64, device=dev))

    def decode(pot, tr, ln):
        if tr.shape[0] == N + 2:
            start, stop, square = tr[0], tr[1], tr[2:]
        else:
            start = stop = None
            square = tr
        _, path = _viterbi(pot, square, ln, False, start_trans=start,
                           stop_trans=stop)
        return path

    path = apply_op(decode, input, trans, length)
    if label is not None:
        lab = _t(label)

        def correct(p, lb, ln):
            live = torch.arange(T, device=p.device)[None, :] < \
                ln.reshape(-1, 1).to(p.device)
            hit = (lb.reshape(B, T).to(p.device) == p).to(p.dtype)
            return torch.where(live, hit, torch.zeros_like(hit))

        return apply_op(correct, path, lab, length)
    return path


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    from .extras import py_func as _pf
    return _pf(func, x, out, backward_func, skip_vars_in_backward_input)


# ------------------------------------------------------------ sequence ops
def _lens(x, length):
    d = _raw(x)
    if length is None:
        return torch.full((d.shape[0],), d.shape[1], dtype=torch.int64,
                          device=d.device)
    ln = _raw(length) if isinstance(length, Tensor) else \
        torch.as_tensor(np.asarray(length))
    return ln.reshape(-1).to(device=d.device, dtype=torch.int64)


def _live(ln, T, ndim, device):
    live = torch.arange(T, device=device)[None] < ln[:, None]
    return live.reshape(live.shape + (1,) * (ndim - 2))


def sequence_mask(x, maxlen=None, dtype="int64"):
    from ..nn import functional as F
    return F.sequence_mask(x, maxlen, dtype)


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """(B, T, ...) already-padded layout: overwrite positions past `length`
    with pad_value (reference pads raggeds; here padding is re-asserted)."""
    ln = _lens(x, length)

    def fn(xd, pv):
        live = _live(ln, xd.shape[1], xd.dim(), xd.device)
        return torch.where(live, xd, pv.to(xd.dtype))
    return apply_op(fn, x, _t(pad_value)), Tensor(ln)


def sequence_unpad(x, length, name=None):
    """Mask positions past length to 0 (stays padded: see module note)."""
    ln = _lens(x, length)

    def fn(xd):
        live = _live(ln, xd.shape[1], xd.dim(), xd.device)
        return torch.where(live, xd, torch.zeros_like(xd))
    return apply_op(fn, x)


def sequence_softmax(input, length=None, name=None):
    ln = _lens(input, length)

    def fn(x):
        live = _live(ln, x.shape[1], 2, x.device)
        masked = torch.where(live, x, torch.full_like(x, float("-inf")))
        return torch.where(live, torch.softmax(masked, 1),
                           torch.zeros_like(x))
    return apply_op(fn, input)


def sequence_pool(input, pool_type="max", length=None, pad_value=0.0):
    ln = _lens(input, length)

    def fn(x):
        lv = _live(ln, x.shape[1], x.dim(), x.device)
        if pool_type == "max":
            return torch.where(lv, x, torch.full_like(x, float("-inf"))) \
                .amax(1)
        if pool_type == "min":
            return torch.where(lv, x, torch.full_like(x, float("inf"))) \
                .amin(1)
        s = torch.where(lv, x, torch.zeros_like(x)).sum(1)
        if pool_type == "sum":
            return s
        n = torch.clamp(ln, min=1).reshape((-1,) + (1,) * (x.dim() - 2))
        if pool_type in ("average", "mean"):
            return s / n
        if pool_type == "sqrt":
            return s / torch.sqrt(n.to(x.dtype))
        if pool_type == "last":
            idx = torch.clamp(ln - 1, min=0)
            idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
                (x.shape[0], 1) + tuple(x.shape[2:]))
            return torch.gather(x, 1, idx)[:, 0]
        if pool_type == "first":
            return x[:, 0]
        raise ValueError(f"pool_type {pool_type}")
    return apply_op(fn, input)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_concat(input, name=None):
    """Concatenate along time (padded layout: plain concat on axis 1)."""
    from ..tensor.manipulation import concat
    return concat(list(input), axis=1)


def _gather_time(x, idx):
    """x[b, idx[b, t], ...] over the time axis."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def sequence_slice(input, offset, length, name=None):
    def fn(x, off, ln):
        T = x.shape[1]
        ar = torch.arange(T, device=x.device)[None]
        idx = torch.clamp(off.reshape(-1, 1).to(torch.int64) + ar, 0, T - 1)
        g = _gather_time(x, idx)
        live = _live(ln.reshape(-1).to(torch.int64), T, x.dim(), x.device)
        return torch.where(live, g, torch.zeros_like(g))
    return apply_op(fn, input, _t(offset), _t(length))


def sequence_expand(x, y, ref_level=-1, name=None):
    """Padded-layout expand: tile each row of x `rep` times to match y's
    batch (the LoD-driven general case needs raggeds; repeat-factor
    expansion covers the common usage)."""
    def fn(xd, yd):
        return torch.repeat_interleave(xd, yd.shape[0] // xd.shape[0], 0)
    return apply_op(fn, x, y)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_reshape(input, new_dim):
    return apply_op(lambda x: x.reshape(x.shape[0], -1, new_dim), input)


def sequence_scatter(input, index, updates, name=None):
    def fn(x, idx, upd):
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return x.index_put((rows.expand_as(idx), idx.to(torch.int64)),
                           upd.to(x.dtype), accumulate=True)
    return apply_op(fn, input, index, updates)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    def fn(x):
        T = x.shape[1]
        idx = torch.arange(T, device=x.device)[:, None] + \
            torch.arange(win_size, device=x.device)[None]
        valid = idx < T
        g = x[:, torch.clamp(idx, 0, T - 1)]               # (B, T, win)
        return torch.where(valid[None], g, torch.full_like(g, pad_value))
    return apply_op(fn, input)


def sequence_reverse(x, length=None, name=None):
    """Reverse each sequence within its live prefix, padding stays put."""
    ln = _lens(x, length)

    def fn(xd):
        ar = torch.arange(xd.shape[1], device=xd.device)[None]
        idx = torch.where(ar < ln[:, None], ln[:, None] - 1 - ar, ar)
        return _gather_time(xd, idx)
    return apply_op(fn, x)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, act=None,
                  param_attr=None, bias_attr=None, name=None):
    """reference: operators/sequence_ops/sequence_conv_op — context-window
    convolution over time: concat the window features, project."""
    from ..nn.initializer import XavierUniform
    D = input.shape[-1]
    w = _param(XavierUniform(), (filter_size * D, num_filters), input)
    start = padding_start if padding_start is not None \
        else -(filter_size // 2)

    def fn(x, wt):
        T = x.shape[1]
        ar = torch.arange(T, device=x.device)
        cols = []
        for i in range(filter_size):
            off = start + i
            rolled = torch.roll(x, -off, 1)
            valid = ((ar + off) >= 0) & ((ar + off) < T)
            cols.append(torch.where(valid[None, :, None], rolled,
                                    torch.zeros_like(rolled)))
        return torch.cat(cols, -1) @ wt                  # (B, T, k*D) @ W
    return _act(apply_op(fn, input, w), act)


class StaticRNN:
    """reference: static/nn/control_flow.py StaticRNN — an unrolled RNN
    made step by step. Here the step function runs eagerly per time
    step; the compiled path is nn.RNN."""

    def __init__(self, name=None):
        self._inputs = []
        self._memories = []     # (init, current) pairs by index
        self._outputs = []
        self._built = False

    def step(self):
        return contextlib.nullcontext(self)

    def step_input(self, x):
        self._inputs.append(x)
        self._T = x.shape[1] if len(x.shape) > 1 else x.shape[0]
        return _SeqSlot(self, len(self._inputs) - 1)

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0):
        if init is None:
            B = batch_ref.shape[0]
            init = Tensor(torch.full((B,) + tuple(shape), float(value),
                                     device=batch_ref._data.device))
        self._memories.append({"init": init, "updates": None})
        return _MemSlot(self, len(self._memories) - 1)

    def update_memory(self, mem_slot, new_val):
        self._memories[mem_slot.idx]["updates"] = new_val

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        raise RuntimeError("StaticRNN here only records its steps; use "
                           "nn.RNN for the compiled path")


class _SeqSlot:
    def __init__(self, rnn, idx):
        self.rnn = rnn
        self.idx = idx


class _MemSlot:
    def __init__(self, rnn, idx):
        self.idx = idx
