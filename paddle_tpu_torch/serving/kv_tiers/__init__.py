"""KV tiers below the device pool (`paddle_tpu.serving.kv_tiers`).

The block pool lives in device memory and the prefix cache covers one
engine; prefix reuse that outgrows the pool needs colder tiers:

  device pool --evict--> HostTier (host copies of the pool-native slabs,
                         optionally int8-requantized through the
                         canonical quantize_codes / dequant_codes pair)
              --pressure--> DiskTier (append-only block log and index,
                            torn-tail recovery, sha256 checked at restore,
                            threshold compaction)

  host.py  — `HostTier`
  disk.py  — `DiskTier`, the log format shared with the JAX package
  store.py — `TieredBlockStore`, what the engine attaches under its
             prefix cache (`enable_kv_tiers`): eviction demotes instead
             of freeing, a match against a demoted chain promotes its
             blocks back in place; and the corrupt-restore counter the
             tiers and the engine's cross-engine prefix restore share

Corruption anywhere (a torn spill, a torn restore, a sha mismatch)
degrades to a miss and a recompute, never to wrong KV. The fleet half
(PREFIXLOOKUP counting tiered continuations, KVEXPORT shipping them) is
in `serving/distributed/worker.py`.
"""
from .disk import DiskTier  # noqa: F401
from .host import HostTier  # noqa: F401
from .store import TieredBlockStore, corrupt_counter  # noqa: F401

__all__ = ["HostTier", "DiskTier", "TieredBlockStore", "corrupt_counter"]
