"""Adapter registry: tenants publish adapter checkpoints through the
committed-checkpoint protocol.

Counterpart of `paddle_tpu/serving/tenancy/registry.py`, over the port's
`distributed/checkpoint.py` and `framework/ckpt_commit.py`, whose files
are the JAX package's: an adapter either package publishes resolves in
the other. A tenant's adapter directory is a checkpoint root; each
published version lands by atomic commit (hidden tempdir, sha256
manifest, fsync, rename) and the LATEST pointer moves only after the
rename. `resolve()` never loads a torn commit: the load verifies digests
and falls back to the newest sibling that verifies; when nothing
verifies (or nothing was published) the tenant is served the base
weights, with a warning.
"""
import os
import re
import warnings

from ...distributed import checkpoint as _ckpt
from ...distributed.checkpoint import CheckpointCorruptError  # noqa: F401
from .adapters import AdapterState

__all__ = ["AdapterRegistry"]

_VERSION_PAT = re.compile(r"^adapter-(\d{6})$")


class AdapterRegistry:
    def __init__(self, root, keep=2):
        self.root = os.path.abspath(root)
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)

    def _tenant_root(self, tenant):
        safe = re.sub(r"[^A-Za-z0-9_.\-]", "_", str(tenant))
        return os.path.join(self.root, safe)

    def _next_version(self, troot):
        best = 0
        if os.path.isdir(troot):
            for name in os.listdir(troot):
                m = _VERSION_PAT.match(name)
                if m:
                    best = max(best, int(m.group(1)))
        return best + 1

    def publish(self, tenant, state, keep=None):
        """Commit `state` (an AdapterState) as the tenant's newest
        adapter version; returns the committed checkpoint path."""
        troot = self._tenant_root(tenant)
        os.makedirs(troot, exist_ok=True)
        version = self._next_version(troot)
        path = os.path.join(troot, f"adapter-{version:06d}")
        _ckpt.save_state_dict(state.to_state_dict(), path,
                              keep=keep if keep is not None else self.keep)
        return path

    def resolve(self, tenant):
        """The tenant's newest VERIFIED adapter, or None (base weights).

        Torn/corrupt commits are skipped by manifest verification; if no
        version of the tenant's adapter verifies, a RuntimeWarning is
        issued and the tenant serves base weights — degradation, not a
        crash, and never a stale delta."""
        troot = self._tenant_root(tenant)
        if not os.path.isdir(troot):
            return None
        try:
            sd = _ckpt.load_state_dict(troot, return_numpy=True)
        except CheckpointCorruptError as e:
            warnings.warn(
                f"tenant {tenant!r}: no adapter checkpoint verifies "
                f"({e}); serving base weights", RuntimeWarning,
                stacklevel=2)
            return None
        except FileNotFoundError:
            return None
        try:
            return AdapterState.from_state_dict(sd)
        except (ValueError, KeyError) as e:
            warnings.warn(
                f"tenant {tenant!r}: adapter checkpoint malformed ({e}); "
                f"serving base weights", RuntimeWarning, stacklevel=2)
            return None
