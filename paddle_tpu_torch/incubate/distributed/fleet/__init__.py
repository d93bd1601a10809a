"""incubate.distributed.fleet (counterpart of
`paddle_tpu/incubate/distributed/fleet/__init__.py`; reference:
recompute_sequential / recompute_hybrid, segment-wise activation
recompute)."""

__all__ = ["recompute_sequential", "recompute_hybrid"]


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split a Sequential (or a list of layers) into `ctx["segments"]`
    chunks and recompute each chunk."""
    from ....distributed.fleet.utils import recompute
    from ....nn import Sequential
    segments = (ctx or {}).get("segments", 1)
    layers = list(functions)
    if segments <= 1:
        chunks = [layers]
    else:
        per = max(len(layers) // segments, 1)
        chunks = [layers[i:i + per] for i in range(0, len(layers), per)]
    out = args[0] if len(args) == 1 else args
    for chunk in chunks:
        seq = chunk[0] if len(chunk) == 1 else Sequential(*chunk)
        out = recompute(seq, out, **kwargs)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """Recompute with hybrid-parallel RNG bookkeeping: the recompute
    replays the forward's random draws (preserve_rng_state), so this is
    `recompute` with the ctx's offload knobs accepted."""
    from ....distributed.fleet.utils import recompute
    return recompute(function, *args, **kwargs)
