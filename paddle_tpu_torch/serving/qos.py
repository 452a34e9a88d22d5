# Copied from the JAX package: paddle_tpu/serving/qos.py (stdlib
# only). Keep it in step with that file; its declared change gives
# WeightedFairScheduler a plain lock.
"""Per-tenant QoS: priority tiers, weighted-fair token scheduling,
quota enforcement, and tier-ordered overload shedding (SERVING.md
§Multi-tenancy).

A multi-tenant replica must degrade *by tier*, not globally: the old
behavior — one `QueueFullError` 503 for whoever arrives after the
queue fills — lets a single misbehaving low-priority tenant starve
everyone, because arrival order is the only admission signal. This
module supplies the three mechanisms the batcher and the decode
scheduler compose instead:

- **Tiers** (`QoSPolicy`): an ordered list of named priority classes,
  highest first. Every tenant maps to a tier (unknown tenants land on
  `default_tier`). Admission and preemption order is strict across
  tiers: a lower tier never displaces a higher one.
- **Weighted-fair scheduling** (`WeightedFairScheduler`): within a
  tier, tenants share service in proportion to their configured
  weights via start-time fair queuing — each tenant carries a virtual
  time advanced by `tokens / weight` per unit of service, and the
  scheduler always picks the backlogged tenant with the smallest
  virtual time. A tenant arriving after idling starts at the system
  virtual time (no banked credit), so fairness is over *backlogged*
  periods, the textbook SFQ property.
- **Shedding** (`ShedError`, `shed_victim`): under queue pressure the
  victim is the lowest-tier request, newest first within the tier —
  never simply the arriving request. The HTTP layer maps `ShedError`
  to a typed 503 (`{"shed": "<tier>"}` + Retry-After) that the fleet
  router classifies as an *answer*, not a failure to retry elsewhere:
  re-sending a deliberately shed request to a surviving replica
  amplifies exactly the overload the shed is relieving.

Quotas bound a single tenant's concurrent footprint (queued +
in-flight) regardless of pressure, so one tenant cannot occupy every
slot even when the system is otherwise idle.

The scheduler takes an injectable clock for its idle bookkeeping so
share math is unit-testable without wall time.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..observability import metrics as _m
from .batcher import QueueFullError

__all__ = ["QoSPolicy", "ShedError", "TenantSpec",
           "WeightedFairScheduler", "shed_victim"]

# Shed accounting is the overload story's primary evidence: the
# noisy-neighbor gate asserts sheds land on the flooding tier ONLY.
SHEDS = _m.counter(
    "paddle_tpu_serving_sheds_total",
    "Requests shed by QoS admission, by victim tier and cause "
    "(kind=queue|quota)", labelnames=("tier", "kind"))
TENANT_REQUESTS = _m.counter(
    "paddle_tpu_serving_tenant_requests_total",
    "Per-tenant request outcomes (ok|rejected|shed|timeout|error for "
    "the batcher; eos|length|... for decode)",
    labelnames=("tenant", "tier", "outcome"))
TENANT_TOKENS = _m.counter(
    "paddle_tpu_serving_tenant_tokens_total",
    "Generated tokens per tenant (decode engine)",
    labelnames=("tenant",))
TENANT_REQUEST_SECONDS = _m.histogram(
    "paddle_tpu_serving_tenant_request_seconds",
    "End-to-end predict latency per tenant (successful only)",
    labelnames=("tenant",))
TENANT_TTFT_SECONDS = _m.histogram(
    "paddle_tpu_decode_tenant_ttft_seconds",
    "Time to first generated token per tenant",
    labelnames=("tenant",))

DEFAULT_TENANT = "default"


class ShedError(QueueFullError):
    """This request (or its victim's caller) was deliberately shed by
    QoS admission. Maps to HTTP 503 with a typed body
    `{"shed": "<tier>", "kind": "queue"|"quota"}` and a Retry-After
    header; the fleet router treats it as an answer, not a retryable
    replica failure."""

    def __init__(self, msg: str, *, tenant: str, tier: str,
                 kind: str = "queue", retry_after_s: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.tier = tier
        self.kind = kind
        self.retry_after_s = float(retry_after_s)


class TenantSpec:
    """One tenant's QoS contract: its tier, its weight within the tier
    (share of service under contention), and an optional cap on
    concurrent requests (queued + in-flight; None = unlimited)."""

    def __init__(self, tier: Optional[str] = None, weight: float = 1.0,
                 max_inflight: Optional[int] = None):
        self.tier = tier
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.max_inflight = None if max_inflight is None \
            else int(max_inflight)


class QoSPolicy:
    """Tier order + per-tenant specs. Tiers are listed highest-priority
    FIRST; unknown tenants land on `default_tier` (the last = lowest
    tier unless overridden) with weight 1 and no quota."""

    def __init__(self, tiers: Sequence[str] = ("high", "normal", "low"),
                 tenants: Optional[Dict[str, TenantSpec]] = None,
                 default_tier: Optional[str] = None):
        if not tiers:
            raise ValueError("QoSPolicy needs at least one tier")
        self.tiers = tuple(str(t) for t in tiers)
        if len(set(self.tiers)) != len(self.tiers):
            raise ValueError(f"duplicate tier names: {self.tiers}")
        self.default_tier = self.tiers[-1] if default_tier is None \
            else str(default_tier)
        if self.default_tier not in self.tiers:
            raise ValueError(
                f"default_tier {self.default_tier!r} not in {self.tiers}")
        self.tenants: Dict[str, TenantSpec] = dict(tenants or {})
        for name, spec in self.tenants.items():
            if spec.tier is not None and spec.tier not in self.tiers:
                raise ValueError(
                    f"tenant {name!r} names unknown tier {spec.tier!r}; "
                    f"tiers are {self.tiers}")

    @classmethod
    def from_spec(cls, spec) -> Optional["QoSPolicy"]:
        """Coerce a config value into a policy: None passes through
        (QoS off), a QoSPolicy passes through, a dict is the JSON
        shape replica CLIs load from --qos files:

            {"tiers": ["gold", "bronze"], "default_tier": "bronze",
             "tenants": {"acme": {"tier": "gold", "weight": 3,
                                  "max_inflight": 8}}}
        """
        if spec is None or isinstance(spec, cls):
            return spec
        if not isinstance(spec, dict):
            raise TypeError(f"qos spec must be a dict or QoSPolicy, "
                            f"got {type(spec).__name__}")
        tenants = {str(name): TenantSpec(**dict(ts))
                   for name, ts in (spec.get("tenants") or {}).items()}
        return cls(tiers=spec.get("tiers", ("high", "normal", "low")),
                   tenants=tenants,
                   default_tier=spec.get("default_tier"))

    def tier_of(self, tenant: Optional[str]) -> str:
        spec = self.tenants.get(tenant or DEFAULT_TENANT)
        if spec is not None and spec.tier is not None:
            return spec.tier
        return self.default_tier

    def tier_rank(self, tier: str) -> int:
        """0 = highest priority; unknown tiers rank below every
        configured one (shed first, admitted last)."""
        try:
            return self.tiers.index(tier)
        except ValueError:
            return len(self.tiers)

    def rank_of(self, tenant: Optional[str]) -> int:
        return self.tier_rank(self.tier_of(tenant))

    def weight_of(self, tenant: Optional[str]) -> float:
        spec = self.tenants.get(tenant or DEFAULT_TENANT)
        return spec.weight if spec is not None else 1.0

    def quota_of(self, tenant: Optional[str]) -> Optional[int]:
        spec = self.tenants.get(tenant or DEFAULT_TENANT)
        return spec.max_inflight if spec is not None else None

    def spec_dict(self) -> Dict:
        """The from_spec-shaped dict (for /v1/status and obsdump)."""
        return {
            "tiers": list(self.tiers),
            "default_tier": self.default_tier,
            "tenants": {
                name: {"tier": ts.tier, "weight": ts.weight,
                       "max_inflight": ts.max_inflight}
                for name, ts in sorted(self.tenants.items())},
        }


class WeightedFairScheduler:
    """Start-time fair queuing over tenants, tier-priority first.

    `pick(tenants)` returns the index of the candidate to serve next:
    strict tier order across tiers, minimum virtual time within a
    tier, submission order as the tie-break. `charge(tenant, tokens)`
    advances the served tenant's virtual time by tokens/weight. The
    system virtual time (`_vbase`) tracks the served minimum, so a
    tenant returning from idle starts at the current frontier instead
    of cashing in its idle period.

    Callers serialize access under their own scheduler lock (the
    batcher/decode `_cv`); the instance-level lock exists for direct
    use outside one, and is a leaf in the lock order."""

    def __init__(self, policy: QoSPolicy, clock=time.monotonic):
        self.policy = policy
        self._clock = clock
        self._vt: Dict[str, float] = {}
        self._vbase = 0.0
        self._served: Dict[str, float] = {}  # cumulative tokens (stats)
        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()

    def vtime(self, tenant: str) -> float:
        with self._lock:
            return max(self._vt.get(tenant, self._vbase), self._vbase)

    def served(self, tenant: str) -> float:
        with self._lock:
            return self._served.get(tenant, 0.0)

    def pick(self, tenants: Sequence[str]) -> int:
        """Index of the next candidate to serve: (tier rank, virtual
        time, position). Advances the system virtual time to the
        winner's start tag — the SFQ v(t) approximation."""
        if not tenants:
            raise ValueError("pick() needs at least one candidate")
        pol = self.policy
        with self._lock:
            best, best_key = 0, None
            for i, t in enumerate(tenants):
                key = (pol.rank_of(t),
                       max(self._vt.get(t, self._vbase), self._vbase), i)
                if best_key is None or key < best_key:
                    best, best_key = i, key
            self._vbase = max(self._vbase, best_key[1])
            return best

    def charge(self, tenant: str, tokens: float):
        """Record `tokens` of service for `tenant` (rows for the
        batcher, generated tokens for decode)."""
        w = self.policy.weight_of(tenant)
        with self._lock:
            v = max(self._vt.get(tenant, self._vbase), self._vbase)
            self._vt[tenant] = v + float(tokens) / w
            self._served[tenant] = self._served.get(tenant, 0.0) \
                + float(tokens)

    def served_shares(self) -> Dict[str, float]:
        with self._lock:
            total = sum(self._served.values())
            if total <= 0:
                return {}
            return {t: s / total for t, s in self._served.items()}


def shed_victim(entries: Iterable[Tuple[str, float]],
                policy: QoSPolicy) -> int:
    """Index of the request to shed under queue pressure: lowest tier
    first, newest first within the tier. `entries` is (tenant,
    order_key) with order_key increasing by arrival (a sequence number
    or enqueue timestamp). The caller includes the INCOMING request as
    the final entry, so an arrival that outranks everything queued
    displaces the queued victim instead of being bounced itself."""
    entries = list(entries)
    if not entries:
        raise ValueError("shed_victim() needs at least one entry")
    return max(range(len(entries)),
               key=lambda i: (policy.rank_of(entries[i][0]),
                              entries[i][1]))
