"""Host-RAM KV tier: host copies of evicted prefix blocks.

Counterpart of `paddle_tpu/serving/kv_tiers/host.py`. One entry holds one
block's whole-model KV (every layer, both sides, plus the scale rows of
an int8 pool) in the pool-native layout the engine's read callback
produced, keyed by the prefix-chain key. LRU ordered: `overflow()`
surfaces the coldest entries for the store to demote to disk (or drop)
when the tier holds more than its capacity.

`dtype="int8"` requantizes float payloads on the way in through the
port's canonical `blocks.quantize_codes` / `dequant_codes` pair
(per-block per-head abs-max scales, the int8 KV pools' rule; codes bit
for bit the JAX tier's) and gives float32 back on the way out: lossy,
and 4x the blocks per host byte. Payloads that already are int8 codes
(quantized pools) are stored losslessly. The requantized names carry the
reference's `/q8` (codes) and `/s8` (per-head scales) suffixes, so a
record spilled to disk by either package decodes in the other.

Each requantizing put records its codes' saturated fraction (codes at
the +-127 rail), which the store hands to the KV ledger's `tier_demote`
as `sat`, and feeds the codes to the process numerics monitor
(`observability.numerics.observe_tree("kv_tier.requant_codes", ...)`, a
no-op unless `numerics.set_monitor` installed one).
"""
import collections

import numpy as np
import torch

from ...observability import numerics as _numerics
from ..blocks import dequant_codes, quantize_codes

__all__ = ["HostTier"]

# array-name suffixes of a requantized pair: "k3" becomes "k3/q8" (codes)
# and "k3/s8" (per-head scales)
_Q8 = "/q8"
_S8 = "/s8"


def _quantize(a, scale):
    """a [block_size, heads, head_dim] f32, scale [heads] -> int8 codes."""
    return quantize_codes(torch.from_numpy(a),
                          torch.from_numpy(scale)[None, :, None]).numpy()


def _dequantize(codes, scale):
    return dequant_codes(torch.from_numpy(np.ascontiguousarray(codes)),
                         torch.from_numpy(np.ascontiguousarray(
                             scale, np.float32))[None, :, None]).numpy()


class HostTier:
    """Capacity-bounded {chain key -> block record} host store. A record is
    `{"ns", "parent", "quant", "arrays": {name: np.ndarray}}`: the arrays
    are what the engine's block reader produced and its writer accepts
    back, so the tier never needs to know the pool's layer layout."""

    def __init__(self, capacity_blocks, dtype="float32"):
        if dtype not in ("float32", "int8"):
            raise ValueError(f"host tier dtype must be 'float32' or "
                             f"'int8', got {dtype!r}")
        self.capacity = int(capacity_blocks)
        self.dtype = dtype
        self._entries = collections.OrderedDict()   # key -> rec, LRU first
        # int8 requantization: the fraction of codes at the +-127 rail per
        # requantizing put (an outlier-dominated scale round-trips with
        # visible error)
        self.last_put_saturation = None
        self._sat_sum = 0.0
        self._sat_max = 0.0
        self._sat_samples = 0

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def keys(self):
        return list(self._entries)

    # -- codec ---------------------------------------------------------------
    def _encode(self, rec):
        """int8 mode: requantize each float [bs, heads, head_dim] array
        against its per-head abs-max; int8 codes and scale rows of a
        quantized pool pass through losslessly."""
        if self.dtype != "int8":
            return rec
        arrays = {}
        qcodes = []
        for name, a in rec["arrays"].items():
            if a.dtype != np.float32 or a.ndim != 3:
                arrays[name] = a
                continue
            scale = np.maximum(np.abs(a).max(axis=(0, 2)), 1e-30)
            codes = _quantize(np.ascontiguousarray(a), scale)
            arrays[name + _Q8] = codes
            arrays[name + _S8] = scale.astype(np.float32)
            qcodes.append(codes)
        if qcodes:
            total = sum(c.size for c in qcodes)
            railed = sum(int((np.abs(c) >= 127).sum()) for c in qcodes)
            sat = railed / total if total else 0.0
            self.last_put_saturation = sat
            self._sat_sum += sat
            self._sat_max = max(self._sat_max, sat)
            self._sat_samples += 1
            # latches a saturation anomaly when a process monitor is
            # installed; one global read otherwise
            _numerics.observe_tree("kv_tier.requant_codes", qcodes,
                                   sat_threshold=127)
        else:
            self.last_put_saturation = None
        return dict(rec, arrays=arrays)

    @staticmethod
    def _decode(rec):
        """Pool-native arrays from a possibly requantized record (the
        inverse of `_encode`, through `dequant_codes`)."""
        if not any(n.endswith(_Q8) for n in rec["arrays"]):
            return rec
        arrays = {}
        for name, a in rec["arrays"].items():
            if name.endswith(_S8):
                continue
            if name.endswith(_Q8):
                base = name[:-len(_Q8)]
                arrays[base] = _dequantize(a, rec["arrays"][base + _S8])
            else:
                arrays[name] = a
        return dict(rec, arrays=arrays)

    # -- tier ops ------------------------------------------------------------
    def put(self, key, rec):
        """Store (or refresh) one block record at the MRU end. The store
        fires `serving.kv_spill` and decides what a torn spill means;
        this container only stores."""
        self._entries.pop(key, None)
        self._entries[key] = self._encode(rec)

    def get(self, key):
        """Pool-native record or None; a hit refreshes its LRU place."""
        rec = self._entries.get(key)
        if rec is None:
            return None
        self._entries.move_to_end(key)
        return self._decode(rec)

    def raw(self, key):
        """The stored (possibly requantized) record, LRU untouched: what a
        demotion to disk serializes, with no decode and re-encode."""
        return self._entries.get(key)

    def drop(self, key):
        return self._entries.pop(key, None) is not None

    def saturation_stats(self):
        """Running int8 requantization saturation over the puts."""
        n = self._sat_samples
        return {"samples": n, "mean": (self._sat_sum / n) if n else 0.0,
                "max": self._sat_max, "last": self.last_put_saturation}

    def overflow(self):
        """Pop and return the coldest entries beyond capacity as
        [(key, raw record)]: the store demotes them to disk or drops
        them."""
        out = []
        while len(self._entries) > max(self.capacity, 0):
            out.append(self._entries.popitem(last=False))
        return out
