"""Tenant declarations and token-budget rate limiting.

Counterpart of `paddle_tpu/serving/tenancy/limits.py`, copied. A
`TenantSpec` is what the serving stack knows of a tenant beyond its
label: its prefix-cache namespace (the trust boundary), its resident-block
quota, its token bucket and its adapter shape. `TenancyConfig` is the
{tenant: spec} table the scheduler reads.

The bucket refills lazily from the scheduler's injectable clock at each
probe, so two runs with the same clock trace admit and deny identically.
The admit rule itself is `observability.decisions.replay_rate_limit`: the
scheduler records the rule's inputs and the decision-record validator
runs the same function over every record.
"""
from dataclasses import dataclass, field

__all__ = ["TokenBucket", "TenantSpec", "TenancyConfig"]


class TokenBucket:
    """Refillable token bucket over an injectable monotonic clock.
    `rate` tokens/second refill up to `burst` capacity; a request costs
    its token budget (prompt + max_new)."""

    def __init__(self, rate, burst, clock):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._last = None

    def _refill(self):
        now = float(self._clock())
        if self._last is None:
            self._last = now
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def available(self):
        """Tokens available right now (post-refill)."""
        self._refill()
        return self._tokens

    def take(self, cost):
        """Spend `cost` tokens (caller has already checked the rule)."""
        self._refill()
        self._tokens = max(0.0, self._tokens - float(cost))


@dataclass
class TenantSpec:
    """One tenant's serving contract. Every field optional — an absent
    field means "no isolation/limit of that kind", so a config naming no
    tenants behaves exactly like the pre-tenancy stack."""
    namespace: str = None             # prefix-cache trust boundary
    kv_block_quota: int = None        # resident prefix blocks (namespace)
    rate_tokens_per_s: float = None   # token-bucket refill rate
    burst_tokens: float = None        # token-bucket capacity
    adapter_rank: int = None          # LoRA rank (None = base weights)
    adapter_seed: int = 0             # synthetic-adapter seed
    adapter_scale: float = 0.01


@dataclass
class TenancyConfig:
    """{tenant: TenantSpec} plus the shared adapter-bank geometry."""
    tenants: dict = field(default_factory=dict)
    adapter_slots: int = None         # bank rows incl. slot 0 (base)
    adapter_rank: int = 8             # bank (max) rank

    def __post_init__(self):
        self.tenants = dict(self.tenants or {})
        if self.adapter_slots is None:
            self.adapter_slots = len(self.tenants) + 1

    def spec(self, tenant):
        return self.tenants.get(tenant)

    def namespace_of(self, tenant):
        s = self.tenants.get(tenant)
        return s.namespace if s is not None else None

    def quotas(self):
        """{namespace: resident-block quota} over quota-carrying specs."""
        out = {}
        for spec in self.tenants.values():
            if spec.namespace is not None and spec.kv_block_quota is not None:
                out[spec.namespace] = int(spec.kv_block_quota)
        return out

    def buckets(self, clock):
        """{tenant: TokenBucket} over rate-carrying specs."""
        out = {}
        for tenant, spec in self.tenants.items():
            if spec.rate_tokens_per_s is not None:
                burst = spec.burst_tokens if spec.burst_tokens is not None \
                    else spec.rate_tokens_per_s
                out[tenant] = TokenBucket(spec.rate_tokens_per_s, burst,
                                          clock)
        return out
