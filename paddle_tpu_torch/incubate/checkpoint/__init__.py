"""Training auto-checkpoint of the port, epoch-granular save and resume
(counterpart of `paddle_tpu/incubate/checkpoint/`): a job wraps its epoch
loop in `train_epoch_range`, which restores the last completed epoch and
saves at each epoch boundary, keyed by a job name, over a local
directory; tensors go through the port's `framework.io` save / load,
whose files either package reads.

Crash safety: each epoch saves into its own
`<dir>/epoch-<n>/` through the shared atomic-commit protocol
(framework/ckpt_commit.py) — the `epoch_no` travels in the commit
manifest's metadata, `LATEST` updates only after the rename, and stale
epoch dirs are deleted only AFTER the new one committed (retention
`keep`, default 2, so the previous epoch stays available as the
fallback). A SIGKILL mid-save leaves the prior epoch's checkpoint
intact and resumable; a torn dir never resumes.
"""
import json
import os

from ...framework import ckpt_commit as _commit

__all__ = ["train_epoch_range", "ExeTrainStatus"]

_CKPT_DIR_ENV = "PADDLE_CHECKPOINT_DIR"


class ExeTrainStatus:
    """Tracks (epoch_no, checkpoint paths) for one named training run."""

    def __init__(self, name="auto", save_dir=None, keep=2):
        self.name = name
        self.save_dir = save_dir or os.environ.get(_CKPT_DIR_ENV,
                                                   "./auto_checkpoint")
        self._dir = os.path.join(self.save_dir, name)
        self._meta = os.path.join(self._dir, "status.json")  # legacy mirror
        self._keep = max(int(keep), 1)
        self._resolved = None     # (path, epoch_no) cache for restore()

    def _current(self):
        """(path, epoch_no) of the newest VALID epoch checkpoint, or
        (None, -1). Prefers LATEST; falls back to the newest sibling
        that verifies (the torn-save recovery path). The result is
        cached for the restore() that typically follows last_epoch(), so
        resume verifies the (possibly multi-GB) digests ONCE."""
        candidate, _ = _commit.resolve_valid(self._dir)
        if candidate is not None:
            manifest = _commit.read_manifest(candidate) or {}
            self._resolved = (candidate, int(manifest.get("meta", {})
                                             .get("epoch_no", -1)))
        else:
            self._resolved = (None, -1)
        return self._resolved

    def last_epoch(self):
        path, epoch_no = self._current()
        if path is not None:
            return epoch_no
        # commit artifacts exist but NONE verify: resuming "fresh" here
        # would silently train on uninitialized weights — be loud instead
        if _commit.has_commits(self._dir):
            raise _commit.CheckpointCorruptError(
                f"{self._dir}: epoch checkpoints exist but none verify")
        # legacy flat layout (pre-commit-protocol jobs)
        if os.path.exists(self._meta):
            with open(self._meta) as f:
                return json.load(f).get("epoch_no", -1)
        return -1

    def save(self, epoch_no, layers=None, optimizers=None):
        from ...framework.io import save as _save
        target = os.path.join(self._dir, f"epoch-{int(epoch_no):08d}")
        with _commit.atomic_commit(
                target, extra_meta={"epoch_no": int(epoch_no)}) as tmp:
            for i, layer in enumerate(layers or []):
                _save(layer.state_dict(),
                      os.path.join(tmp, f"layer_{i}.pdparams"))
            for i, opt in enumerate(optimizers or []):
                _save(opt.state_dict(), os.path.join(tmp, f"opt_{i}.pdopt"))
        base = os.path.basename(target)
        self._resolved = None         # state changed: resolve fresh
        _commit.update_latest(self._dir, base)
        # stale epoch dirs go ONLY after the new one is committed and
        # LATEST moved — a crash anywhere above keeps the previous epoch
        _commit.gc_old(self._dir, self._keep, protect={base},
                       same_lineage_as=base)
        tmp_meta = self._meta + ".tmp"
        with open(tmp_meta, "w") as f:
            json.dump({"epoch_no": int(epoch_no)}, f)
        os.replace(tmp_meta, self._meta)  # legacy readers keep working

    def restore(self, layers=None, optimizers=None):
        from ...framework.io import load as _load
        dev = _device(layers)
        path, _ = self._resolved if self._resolved is not None \
            else self._current()
        self._resolved = None         # one-shot: next resolve is fresh
        if path is None:
            if _commit.has_commits(self._dir):
                raise _commit.CheckpointCorruptError(
                    f"{self._dir}: epoch checkpoints exist but none verify")
            path = self._dir          # legacy flat layout
        for i, layer in enumerate(layers or []):
            p = os.path.join(path, f"layer_{i}.pdparams")
            if os.path.exists(p):
                layer.set_state_dict(_load(p, device=dev))
        for i, opt in enumerate(optimizers or []):
            p = os.path.join(path, f"opt_{i}.pdopt")
            if os.path.exists(p):
                opt.set_state_dict(_load(p, device=dev))


def _device(layers):
    """Where restored tensors go: the first layer's parameters' device,
    else the current place."""
    for layer in layers or []:
        for p in layer.parameters():
            return p._data.device
    from ...core.device import current_device
    return current_device()


def train_epoch_range(max_epoch_num, name="auto", save_dir=None,
                      layers=None, optimizers=None, save_checkpoint_inter=1,
                      keep=2):
    """Resumable epoch generator:

        for epoch in train_epoch_range(10, layers=[net], optimizers=[opt]):
            train_one_epoch(...)

    On restart, already-completed epochs are skipped and layer/optimizer
    state is restored from the last VALID checkpoint (torn saves are
    skipped). `keep` epochs of history are retained."""
    status = ExeTrainStatus(name, save_dir, keep=keep)
    start = status.last_epoch() + 1
    if start > 0:
        status.restore(layers, optimizers)
    for epoch in range(start, max_epoch_num):
        yield epoch
        if (epoch + 1) % save_checkpoint_inter == 0 or \
                epoch == max_epoch_num - 1:
            status.save(epoch, layers, optimizers)
