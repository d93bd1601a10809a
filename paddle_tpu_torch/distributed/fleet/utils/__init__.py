"""fleet.utils (counterpart of `paddle_tpu/distributed/fleet/utils/
__init__.py`; reference: python/paddle/distributed/fleet/utils/
__init__.py: LocalFS, recompute, DistributedInfer, HDFSClient).

`recompute` is activation rematerialization (reference:
fleet/recompute/recompute.py RecomputeFunction) over
`torch.utils.checkpoint` (non-reentrant): the backward re-runs the
function instead of keeping its intermediates, and parameters the
function captures (a Layer's weights, or a closure's) receive their
gradients, so every call keeps the direct call's values and gradients.
"""
import os
import shutil

import torch
from torch.utils.checkpoint import checkpoint

from ....core.tensor import Tensor, _wrap

__all__ = ["LocalFS", "recompute", "DistributedInfer", "HDFSClient"]


def recompute(function, *args, **kwargs):
    """Run `function` keeping only its inputs; the backward re-runs it.
    `preserve_rng_state` (default True) replays the same random draws
    (dropout) in the recompute."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    slots = [("a", i) for i, a in enumerate(args) if isinstance(a, Tensor)]
    slots += [("k", k) for k, v in kwargs.items() if isinstance(v, Tensor)]
    tensors = [args[i] if kind == "a" else kwargs[i] for kind, i in slots]
    box = {}

    def raw(*datas):
        a, kw = list(args), dict(kwargs)
        for (kind, i), d in zip(slots, datas):
            if kind == "a":
                a[i] = _wrap(d)
            else:
                kw[i] = _wrap(d)
        out = function(*a, **kw)
        box["tuple"] = isinstance(out, (tuple, list))
        outs = out if box["tuple"] else (out,)
        return tuple(o._data if isinstance(o, Tensor) else o for o in outs)

    got = checkpoint(raw, *[t._data for t in tensors], use_reentrant=False,
                     preserve_rng_state=preserve)
    outs = tuple(_wrap(o) if isinstance(o, torch.Tensor) else o for o in got)
    return outs if box["tuple"] else outs[0]


class LocalFS:
    """reference: fleet/utils/fs.py LocalFS — filesystem client facade."""

    def ls_dir(self, path):
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n))
             else files).append(n)
        return dirs, files

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False):
        if os.path.exists(dst):
            if not overwrite:
                raise FileExistsError(
                    f"destination {dst!r} exists (pass overwrite=True)")
            self.delete(dst)
        shutil.move(src, dst)

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path) and not exist_ok:
            raise FileExistsError(path)
        open(path, "a").close()


class HDFSClient:
    """reference: fleet/utils/fs.py HDFSClient (shells out to the hadoop
    CLI). No hadoop binary ships with the package; constructing raises
    and names LocalFS, as the JAX package does."""

    def __init__(self, hadoop_home=None, configs=None, **kwargs):
        raise RuntimeError(
            "HDFSClient needs a hadoop installation (the reference shells "
            "out to ${HADOOP_HOME}/bin/hadoop); none is bundled — use "
            "LocalFS, or mount the HDFS path locally")


class DistributedInfer:
    """reference: fleet/utils/ps_util.py DistributedInfer, the
    parameter-server inference helper: it hands back the main program to
    run locally, as the JAX package's does."""

    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program

    def init_distributed_infer_env(self, exe, loss, role_maker=None,
                                   dirname=None):
        return None

    def get_dist_infer_program(self):
        return self._main
