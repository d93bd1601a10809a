"""Serving beyond one engine (counterpart of `paddle_tpu.serving.distributed`).

  kv_handoff.py — the KV-bundle wire format a prefill engine hands a
                  request's K/V to another engine with, byte-compatible
                  with the JAX package's

The tensor- and pipeline-parallel engines, the worker verbs and the
router are not ported yet (ROADMAP A.10, A.11).
"""
from .kv_handoff import (KVWireError, pack_kv_bundle,  # noqa: F401
                         pack_payload, unpack_kv_bundle, unpack_payload)

__all__ = ["KVWireError", "pack_kv_bundle", "unpack_kv_bundle",
           "pack_payload", "unpack_payload"]
