"""The global random state of the eager surface: one explicit
`torch.Generator` per device.

Counterpart of `paddle_tpu/core/random.py`. The JAX package folds a
counter into one base key; the port keeps one torch.Generator per device,
each seeded from the global seed when it is first used, and every random
op draws from the generator of the device it fills. `jax.random` bits
cannot be reproduced in torch, so the random ops are held by their
contract: the same seed gives the same stream, a state round-trip
replays it, shapes and dtypes match the JAX package, and moments match
within stated bounds.

`traced_rng` is not ported: it threads a traced key through jit-compiled
programs, and the eager surface has none (ROADMAP C.14).
"""
import contextlib
import os

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "fork_rng",
           "generator", "Generator"]

Generator = torch.Generator

_seed = int.from_bytes(os.urandom(4), "little") % (2 ** 31)
_generators = {}                 # torch.device -> torch.Generator


def generator(device):
    """The global generator of `device` (a torch.device)."""
    g = _generators.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_seed)
        _generators[device] = g
    return g


def seed(s):
    """paddle.seed(s): reseed the generator of every device."""
    global _seed
    _seed = int(s)
    for g in _generators.values():
        g.manual_seed(_seed)
    return _seed


def get_rng_state():
    """The global seed and every device generator's state; give it back
    to `set_rng_state` to replay the streams from here."""
    return {"seed": _seed,
            "states": {str(d): g.get_state() for d, g in _generators.items()}}


def set_rng_state(state):
    global _seed
    _seed = state["seed"]
    states = state["states"]
    for d in list(_generators):
        if str(d) not in states:       # made after the state was taken
            del _generators[d]
    for name, st in states.items():
        generator(torch.device(name)).set_state(st)


@contextlib.contextmanager
def fork_rng(seed_):
    """Run a region under an independent, reproducible stream seeded with
    `seed_`, restoring the previous state on exit."""
    saved = get_rng_state()
    seed(seed_)
    try:
        yield
    finally:
        set_rng_state(saved)
