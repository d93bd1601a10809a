"""fleet.meta_parallel: the pipeline layers and the hybrid wrappers
(counterpart of `paddle_tpu/distributed/fleet/meta_parallel/__init__.py`;
reference: python/paddle/distributed/fleet/meta_parallel/).
"""
import contextlib
import zlib

from ...parallel_layers import DataParallel as ShardingParallel  # noqa: F401
from ...parallel_layers import DataParallel as TensorParallel  # noqa: F401
from .pp_layers import (LayerDesc, PipelineLayer, PipelineParallel,
                        SharedLayerDesc)

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "TensorParallel", "ShardingParallel",
           "get_rng_state_tracker", "RNGStatesTracker"]


class RNGStatesTracker:
    """Named random streams for tensor-parallel dropout (reference:
    parallel_layers/random.py get_rng_state_tracker): `rng_state(name)`
    runs its region under a stream seeded by the name's registered seed
    (or, unregistered, a crc32 of the name, the same in every process)
    and restores the global stream after it."""

    def __init__(self):
        self._seeds = {}

    def add(self, name, seed):
        self._seeds[name] = int(seed)

    def get_states_tracker(self):
        return dict(self._seeds)

    def rng_state(self, name="model-parallel-rng"):
        from ....core import random as _rng

        @contextlib.contextmanager
        def ctx():
            seed = self._seeds.get(name)
            if seed is None:
                seed = zlib.crc32(name.encode()) % (2 ** 31)
            with _rng.fork_rng(seed):
                yield
        return ctx()


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker
