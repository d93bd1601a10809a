"""KV tiers below the device pool (`paddle_tpu.serving.kv_tiers`).

  store.py — the corrupt-restore counter the tiers and the engine's
             cross-engine prefix restore share

The host and disk tiers themselves (`HostTier`, `DiskTier`,
`TieredBlockStore`) and the engine's `enable_kv_tiers` are ROADMAP
A.11b.
"""
from .store import corrupt_counter  # noqa: F401

__all__ = ["corrupt_counter"]
