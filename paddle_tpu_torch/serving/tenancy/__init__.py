"""Multi-tenant serving (`paddle_tpu.serving.tenancy`): per-tenant LoRA
adapters gathered by slot inside the one decode graph, an adapter
registry over committed checkpoints, and tenant declarations with token
buckets and prefix-namespace quotas.

  adapters.py — `lora_delta`, `lora_apply`, `AdapterState`,
                `init_adapter_state`, `AdapterBank`
  limits.py   — `TokenBucket`, `TenantSpec`, `TenancyConfig`
  registry.py — `AdapterRegistry` (either package resolves what the
                other publishes)
"""
from .adapters import (TARGETS, AdapterBank, AdapterState,  # noqa: F401
                       init_adapter_state, lora_apply, lora_delta,
                       target_dims)
from .limits import TenancyConfig, TenantSpec, TokenBucket  # noqa: F401
from .registry import AdapterRegistry  # noqa: F401

__all__ = ["AdapterBank", "AdapterState", "AdapterRegistry", "TARGETS",
           "TenancyConfig", "TenantSpec", "TokenBucket",
           "init_adapter_state", "lora_apply", "lora_delta",
           "target_dims"]
