"""Writable program-transform surface over the captured graph IR.

Counterpart of `paddle_tpu/static/ir_pass.py`. Reference: the
static-graph pass system — user-extensible `Pass` subclasses registered
in a PassRegistry and applied to a mutable program
(paddle/fluid/framework/ir/pass.h:69,236; Python Program/Block/Operator
mutation surface, python/paddle/fluid/framework.py:2716,3556,5223).

The program IR is the `torch.fx` graph `make_fx` records (aten ops and
the `cond` / `while_loop` / `scan` HOPs), so a pass is a *node rewrite
rule* applied by re-tracing: the graph is interpreted node by node under
`make_fx`, and the rule sees each op with its live input values (fake
tensors) and can:

- return None            -> keep the op unchanged,
- return replacement out -> replace it (build anything: insert casts,
                            call other torch ops, ...),
- return op.inputs[...]  -> delete it (forward its inputs),

and naming and wiring are handled by the re-trace itself. Dead nodes are
swept afterwards (placeholders never are, so the calling convention
holds), mirroring the reference's memory-optimize passes. The
interpreter recurses into the subgraphs of `cond`, `while_loop` and
`scan`, so passes see inside them. A custom pass is ~5 lines:

    @register_pass("cast_matmuls")
    def cast_matmuls(op, attrs):
        if op.name != "mm":
            return None
        lo = [x.to(torch.bfloat16) for x in op.inputs]
        return [o.to(op.out_avals[0].dtype) for o in op.bind(*lo)]
"""
import operator

import torch
import torch.fx
import torch.fx.traceback as fx_traceback

from . import op_type as _op_type

__all__ = ["OpView", "apply_rule", "register_pass", "get_registered_pass",
           "registered_pass_names"]


class OpView:
    """One node as seen by a rewrite rule: op name, non-tensor params,
    live input values (the positional arguments, graph values replaced by
    their live values), and the original outputs' fake values (for
    dtype/shape-preserving rewrites)."""

    def __init__(self, node, args, kwargs):
        self._node = node
        self.name = _op_type(node.target)
        self.inputs = list(args)
        self._kwargs = dict(kwargs)
        self.params = {k: v for k, v in kwargs.items()
                       if not isinstance(v, torch.Tensor)}
        val = node.meta.get("val")
        self.out_avals = list(val) if isinstance(val, (tuple, list)) \
            else [val]

    def bind(self, *args, **param_overrides):
        """Re-apply this op (optionally with different inputs/params).
        Always returns a list of outputs."""
        kwargs = dict(self._kwargs)
        kwargs.update(param_overrides)
        out = self._node.target(*(args or self.inputs), **kwargs)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def __repr__(self):
        return f"OpView({self.name}, {len(self.inputs)} inputs)"


def _n_outputs(node):
    val = node.meta.get("val")
    return len(val) if isinstance(val, (tuple, list)) else 1


def _sub(gm, rule):
    """A subgraph as a function of its placeholders, under the rule."""
    return lambda *xs: tuple(_eval_with_rule(gm, rule, xs))


def _default_eval(node, target, args, kwargs, rule):
    """Default evaluation of an unmatched node. Passes see THROUGH the
    control-flow HOPs (like reference ir passes see the whole graph,
    ir/graph.h): cond branches, while_loop cond/body and scan bodies are
    rewritten and re-wrapped."""
    from ..jit.dy2static import traced_cond, traced_scan, traced_while
    name = _op_type(target)
    if name == "cond":
        pred, tg, fg, ops = args
        return list(traced_cond(pred, _sub(tg, rule), _sub(fg, rule), ops))
    if name == "while_loop":
        cg, bg, carry, extra = args
        extra = tuple(extra)
        return list(traced_while(
            lambda *c: _eval_with_rule(cg, rule, c + extra)[0],
            lambda *c: tuple(_eval_with_rule(bg, rule, c + extra)),
            carry))
    if name == "scan":
        fg, init, xs, extra = args
        extra = tuple(extra)
        return list(traced_scan(
            lambda *a: tuple(_eval_with_rule(fg, rule, a + extra)),
            init, xs))
    out = target(*args, **kwargs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _eval_with_rule(gm, rule, args):
    env = {}

    def read(a):
        return torch.fx.node.map_arg(a, lambda n: env[n])

    it = iter(args)
    outs = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(it)
        elif node.op == "get_attr":
            obj = gm
            for part in node.target.split("."):
                obj = getattr(obj, part)
            env[node] = obj
        elif node.op == "call_function":
            a, k = read(node.args), read(node.kwargs)
            if node.target is operator.getitem:
                env[node] = a[0][a[1]]
                continue
            with fx_traceback.set_current_meta(node):
                out = rule(OpView(node, a, k))
                if out is None:
                    out = _default_eval(node, node.target, a, k, rule)
                elif not isinstance(out, (list, tuple)):
                    out = [out]
            n = _n_outputs(node)
            if len(out) != n:
                raise ValueError(
                    f"pass rule for {_op_type(node.target)} returned "
                    f"{len(out)} outputs, op has {n}")
            val = node.meta.get("val")
            env[node] = tuple(out) if isinstance(val, (tuple, list)) \
                else out[0]
        elif node.op == "output":
            outs = read(node.args[0])
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


def apply_rule(gm, rule):
    """Rewrite a GraphModule by re-tracing it under `rule`; returns a new
    GraphModule (the original is untouched). Dead nodes are swept, so
    deleted/orphaned ops disappear from the IR; every placeholder stays,
    so the Program's calling convention (InputSpecs) does not change."""
    from ..jit import trace_program
    examples = []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            v = n.meta["val"]
            examples.append(torch.zeros(v.shape, dtype=v.dtype,
                                        device=v.device))

    def run(*xs):
        return _eval_with_rule(gm, rule, xs)

    with fx_traceback.preserve_node_meta():
        new = trace_program(run, examples)
    _mark_recompute(new)
    return new


def _mark_recompute(gm):
    """Carry a recompute annotation into torch's checkpoint policy, in the
    graph and its subgraphs."""
    from torch.utils.checkpoint import CheckpointPolicy
    for mod in gm.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for n in mod.graph.nodes:
                if n.op == "call_function" and \
                        n.meta.get("custom", {}).get("recompute"):
                    n.meta["recompute"] = CheckpointPolicy.MUST_RECOMPUTE


# ------------------------------------------------------------ pass registry
_REGISTRY = {}


def register_pass(name):
    """Register a rewrite rule `fn(op: OpView, attrs: dict) -> None | outs`
    under `name` for use with distributed.passes.new_pass (the reference's
    REGISTER_PASS, ir/pass.h:236)."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_registered_pass(name):
    return _REGISTRY.get(name)


def registered_pass_names():
    return sorted(_REGISTRY)


# ------------------------------------------------- shipped real passes
# the products: what a jaxpr's dot_general / conv_general_dilated become
_MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "linear", "matmul",
               "convolution")


def _is_float(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


@register_pass("auto_parallel_fp16")
@register_pass("auto_parallel_amp")
@register_pass("amp")
def _amp_cast_pass(op, attrs):
    """Cast-insertion AMP (reference: fluid/contrib/mixed_precision/
    fp16_utils.py graph rewrite): the products' float inputs are cast to
    the low dtype, the op runs on the tensor cores' rate, and the output
    is cast back to its original dtype. Non-float and already-low inputs
    pass through."""
    if op.name not in _MATMUL_OPS:
        return None
    from ..core import dtype as _dt
    lo = _dt.convert_dtype(attrs.get("dtype", "bfloat16"))
    ins = [x.to(lo) if _is_float(x) and x.dtype != lo else x
           for x in op.inputs]
    outs = op.bind(*ins)
    return [o.to(a.dtype) for o, a in zip(outs, op.out_avals)]


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def _fake_quant_raw(x, scale, bits):
    """Quant-dequant with an abs-max scale and a straight-through round
    (the reference's `quantization._fake_quant_raw`)."""
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.clamp(scale, min=1e-8)
    return torch.clamp(_ste_round(x / s * qmax), -qmax, qmax) * s / qmax


# which positional inputs of a product are (activation, weight)
_PRODUCT_OPERANDS = {"addmm": (1, 2), "baddbmm": (1, 2)}


@register_pass("quant_aware")
@register_pass("quantization")
def _quant_pass(op, attrs):
    """QAT fake-quant insertion (reference: slim/quantization/
    quantization_pass.py QuantizationTransformPass — fake_quantize ops
    inserted before every matmul/conv on weights and activations). Scales
    are inline abs-max (the reference's fake_quantize_abs_max); the STE
    round keeps the rewritten program trainable."""
    if op.name not in _MATMUL_OPS:
        return None
    wbits = attrs.get("weight_bits", 8)
    abits = attrs.get("activation_bits", 8)
    act, wt = _PRODUCT_OPERANDS.get(op.name, (0, 1))
    ins = list(op.inputs)
    for i, bits in ((act, abits), (wt, wbits)):
        x = ins[i]
        if _is_float(x):
            ins[i] = _fake_quant_raw(x, torch.amax(torch.abs(x)), bits)
    return op.bind(*ins)


@register_pass("auto_parallel_recompute")
@register_pass("recompute")
def _recompute_tag_pass(op, attrs):
    """Recompute tagging (reference: fleet recompute pass /
    distributed/passes/auto_parallel_recompute.py): matched ops carry the
    annotation {"recompute": "must_recompute"} (shown by `to_string()`)
    and torch's activation-checkpoint policy in their node meta, which the
    partitioner of a compiled backward reads to recompute them instead of
    saving their activations."""
    match = tuple(attrs.get("ops", _MATMUL_OPS))
    if op.name not in match:
        return None
    with fx_traceback.annotate({"recompute": "must_recompute"}):
        return op.bind(*op.inputs)
