"""The KV tier store's metric families (counterpart of
`paddle_tpu/serving/kv_tiers/store.py:55-75`).

Only the corrupt-restore counter is registered so far: the engine's
`restore_prefix` latches it when its `serving.kv_restore` fault site
raises or truncates. `TieredBlockStore` and its block, restore-time and
tier families join it with the tiers (ROADMAP A.11b), reusing this
family.
"""
from ...observability import metrics as _metrics

__all__ = ["corrupt_counter"]

_C_CORRUPT = _metrics.counter(
    "serving_kv_tier_corrupt_total",
    "Tier restores that failed verification (torn payload, sha256 "
    "mismatch) — failure-class: the chain degraded to recompute")


def corrupt_counter():
    """The failure-class corrupt-restore counter, shared by the tiers and
    the engine's cross-engine prefix restore, so a torn restore is as
    visible to the `tools/metrics_report.py --compare` failure gate as a
    torn tier restore."""
    return _C_CORRUPT
