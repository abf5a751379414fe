"""Per-tenant SLO classes and admission quotas for the shared host.

A copy of ``hpnn_tpu/tenant/quota.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

A multi-tenant host is only useful if one tenant's burst cannot eat
another's latency budget.  This module is the admission side of that
isolation: each tenant is declared with an **SLO class** (a p99
latency target) and a **quota** — a sustained request rate and a
concurrency ceiling — and :class:`QuotaEnforcer` charges every
request against them *before* it reaches a batcher queue.  A request
over budget is rejected up front with :class:`QuotaExceeded` — a
:class:`~hpnn_tpu_torch.serve.batcher.Shed` with ``reason="quota"`` — so
the whole existing retriable-429 surface (HTTP ``Retry-After``,
loadgen backoff, fleet-router handling) applies unchanged; the HTTP
body additionally names the offending tenant.

Declaration grammar (``HPNN_TENANTS``), comma-separated::

    tenant=class[:rate=RPS][:inflight=N][:burst=SECONDS]

    HPNN_TENANTS="acme=gold:rate=50:inflight=8,hog=bronze:rate=5"

Classes are ``gold|silver|bronze`` with default p99 targets of
25/100/400 ms (:data:`SLO_CLASSES`).  ``rate`` is a token bucket
(same shape as the edge ``_RateCap``) with ``burst`` seconds of
headroom; ``inflight`` caps concurrent requests.  An omitted budget
is uncapped; an undeclared tenant gets the default spec (bronze,
uncapped) so the host degrades to best-effort rather than rejecting
unknown callers.

Every outcome lands in a per-tenant rolling window, published as the
``tenant.p99_ms`` / ``tenant.shed_rate`` / ``tenant.inflight``
gauges — the per-tenant surface the ``HPNN_ALERTS`` grammar watches
(a rule on ``tenant.shed_rate`` fires on whichever tenant breaches;
the record's ``tenant`` field names it).  The gauge ``tenant=``
labels route through the cardinality governor
(``obs.meter.tenant_label``): top-K tenants keep their names, the
long tail exports as ``tenant="_other"`` — so a 10k-tenant fleet
publishes O(K) series, not 30k (docs/observability.md, "Tenant
metering").  The shed *count* events keep the real tenant name:
they are bounded by traffic, not by tenant census, and the alert →
capsule path needs the offender named.  stdlib only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import NamedTuple

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.serve.batcher import Shed

ENV_TENANTS = "HPNN_TENANTS"

# SLO class -> default p99 latency target (ms).  The target feeds the
# published per-tenant gauges (and the docs' alert recipes); it is a
# *label with a number*, not an enforcement bound — enforcement is the
# quota, the target is what the tenant was promised.
SLO_CLASSES = {"gold": 25.0, "silver": 100.0, "bronze": 400.0}

DEFAULT_CLASS = "bronze"
DEFAULT_BURST_S = 0.25
# rolling outcome window per tenant (seconds)
WINDOW_S = 10.0
# gauge publish stride: every Nth recorded outcome per tenant (the
# hot path must not pay a gauge emission per request)
PUBLISH_EVERY = 8


class QuotaExceeded(Shed):
    """A tenant over its rate or concurrency budget — the 429 carries
    ``reason="quota"`` and the tenant name in the body."""

    def __init__(self, msg: str, *, tenant: str,
                 retry_after_s: float = 1.0):
        super().__init__(msg, reason="quota",
                         retry_after_s=retry_after_s)
        self.tenant = tenant


class TenantSpec(NamedTuple):
    """One declared tenant: SLO class + budgets (0 = uncapped)."""

    tenant: str
    slo_class: str = DEFAULT_CLASS
    rate_rps: float = 0.0
    max_inflight: int = 0
    burst_s: float = DEFAULT_BURST_S

    @property
    def target_ms(self) -> float:
        return SLO_CLASSES[self.slo_class]


def parse_tenants(raw: str) -> dict[str, TenantSpec]:
    """Parse the ``HPNN_TENANTS`` grammar; junk raises ``ValueError``
    (a silently dropped quota is an isolation hole, not a default)."""
    specs: dict[str, TenantSpec] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        head, _, opts = part.partition(":")
        tenant, eq, cls = head.partition("=")
        tenant = tenant.strip()
        cls = cls.strip() if eq else DEFAULT_CLASS
        if not tenant:
            raise ValueError(f"{ENV_TENANTS}: empty tenant in {part!r}")
        if cls not in SLO_CLASSES:
            raise ValueError(
                f"{ENV_TENANTS}: unknown class {cls!r} for tenant "
                f"{tenant!r} (want {'|'.join(SLO_CLASSES)})")
        kw: dict = {}
        for opt in filter(None, opts.split(":")):
            key, eq, val = opt.partition("=")
            if not eq:
                raise ValueError(
                    f"{ENV_TENANTS}: malformed option {opt!r} for "
                    f"tenant {tenant!r}")
            if key == "rate":
                kw["rate_rps"] = float(val)
            elif key == "inflight":
                kw["max_inflight"] = int(val)
            elif key == "burst":
                kw["burst_s"] = float(val)
            else:
                raise ValueError(
                    f"{ENV_TENANTS}: unknown option {key!r} for "
                    f"tenant {tenant!r} (want rate|inflight|burst)")
        specs[tenant] = TenantSpec(tenant, cls, **kw)
    return specs


def tenants_from_env() -> dict[str, TenantSpec]:
    raw = os.environ.get(ENV_TENANTS, "").strip()
    return parse_tenants(raw) if raw else {}


class _TenantState:
    """Per-tenant runtime state; every field is guarded by the
    enforcer's lock."""

    __slots__ = ("spec", "tokens", "t_tokens", "inflight", "window",
                 "admitted", "shed", "since_publish")

    def __init__(self, spec: TenantSpec, now: float):
        self.spec = spec
        # a tenant starts with its full burst, like the edge _RateCap
        self.tokens = max(1.0, spec.rate_rps * spec.burst_s) \
            if spec.rate_rps > 0 else 0.0
        self.t_tokens = now
        self.inflight = 0
        # (t, latency_ms) outcomes + (t, shed?) admissions, trimmed
        # to WINDOW_S — the p99 / shed-rate the gauges publish
        self.window: deque = deque()
        self.admitted: deque = deque()
        self.shed: deque = deque()
        self.since_publish = 0


class QuotaEnforcer:
    """Charge requests against per-tenant budgets at admission.

    ``admit(tenant)`` consumes one rate token and one inflight slot or
    raises :class:`QuotaExceeded`; ``release(tenant)`` returns the
    slot; ``record(tenant, latency_s)`` lands the outcome in the
    rolling window and periodically publishes the per-tenant gauges.
    ``clock`` is injectable for tests (monotonic float seconds)."""

    def __init__(self, specs: dict[str, TenantSpec] | None = None, *,
                 clock=time.monotonic):
        self._clock = clock
        self._lock = obs.lockwatch.lock("tenant.quota")
        self._specs = dict(tenants_from_env() if specs is None
                           else specs)
        # written only via _state(), whose callers hold _lock
        self._states: dict[str, _TenantState] = {}

    def spec(self, tenant: str) -> TenantSpec:
        s = self._specs.get(tenant)
        return s if s is not None else TenantSpec(tenant)

    def tenants(self) -> list[str]:
        with self._lock:
            known = set(self._specs) | set(self._states)
        return sorted(known)

    def _state(self, tenant: str, now: float) -> _TenantState:
        # callers hold self._lock
        st = self._states.get(tenant)
        if st is None:
            st = self._states[tenant] = _TenantState(
                self.spec(tenant), now)
        return st

    @staticmethod
    def _trim(dq: deque, horizon: float) -> None:
        while dq and dq[0][0] < horizon:
            dq.popleft()

    # ------------------------------------------------------------ admission
    def admit(self, tenant: str, *, kernel: str | None = None) -> None:
        """Charge one request; raises :class:`QuotaExceeded` when the
        tenant is over its rate or concurrency budget.  Admitted
        requests MUST be paired with :meth:`release`."""
        now = self._clock()
        with self._lock:
            st = self._state(tenant, now)
            spec = st.spec
            retry_s = None
            if spec.max_inflight > 0 and st.inflight >= spec.max_inflight:
                over = "inflight"
                retry_s = 0.05  # a slot frees when any request lands
            elif spec.rate_rps > 0:
                burst = max(1.0, spec.rate_rps * spec.burst_s)
                st.tokens = min(
                    burst,
                    st.tokens + (now - st.t_tokens) * spec.rate_rps)
                st.t_tokens = now
                if st.tokens >= 1.0:
                    st.tokens -= 1.0
                    over = None
                else:
                    over = "rate"
                    retry_s = (1.0 - st.tokens) / spec.rate_rps
            else:
                over = None
            if over is None:
                st.inflight += 1
                st.admitted.append((now,))
                self._trim(st.admitted, now - WINDOW_S)
                inflight = st.inflight
            else:
                st.shed.append((now,))
                self._trim(st.shed, now - WINDOW_S)
                shed_rate = self._shed_rate(st, now)
        if over is None:
            obs.gauge("tenant.inflight", float(inflight),
                      tenant=obs.meter.tenant_label(tenant))
            return
        obs.meter.note_shed(tenant)
        fields = {"reason": "quota", "tenant": tenant, "over": over}
        if kernel is not None:
            fields["kernel"] = kernel
        obs.count("serve.shed", **fields)
        obs.count("tenant.shed", tenant=tenant, over=over)
        # the alertable per-tenant breach signal (docs/tenancy.md):
        # published on the shed edge so a quota storm cannot hide
        # behind the publish stride.  The label is governed; the
        # serve.shed/tenant.shed counts above carry the real name.
        obs.gauge("tenant.shed_rate", shed_rate,
                  tenant=obs.meter.tenant_label(tenant), over=over)
        raise QuotaExceeded(
            f"tenant {tenant!r} over {over} quota; retry later",
            tenant=tenant, retry_after_s=retry_s or 1.0)

    def release(self, tenant: str) -> None:
        with self._lock:
            st = self._states.get(tenant)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    # ------------------------------------------------------------ pressure
    def squeeze(self, factor: float) -> dict[str, TenantSpec]:
        """Scale every *declared rate cap* by ``factor`` (< 1 =
        pressure: overload is rejected at admission instead of after
        queueing — the tune plane's shed-storm remediation,
        hpnn_tpu_torch/tune/engine.py).  Uncapped tenants are untouched (a
        fraction of infinity is still infinity, and inventing a cap
        is a policy decision this method must not take).  Returns the
        displaced specs — the exact :class:`TenantSpec` tuples —
        keyed by tenant, so :meth:`restore_specs` rolls the squeeze
        back bitwise.  Empty when no tenant declares a rate."""
        factor = float(factor)
        if not factor > 0:
            raise ValueError("squeeze factor must be > 0")
        priors: dict[str, TenantSpec] = {}
        with self._lock:
            for tenant, spec in list(self._specs.items()):
                if spec.rate_rps <= 0:
                    continue
                priors[tenant] = spec
                new = spec._replace(rate_rps=spec.rate_rps * factor)
                self._specs[tenant] = new
                st = self._states.get(tenant)
                if st is not None:
                    st.spec = new
                    # clamp banked burst to the new budget so a
                    # squeeze takes effect now, not a burst later
                    st.tokens = min(
                        st.tokens,
                        max(1.0, new.rate_rps * new.burst_s))
        return priors

    def restore_specs(self, priors: dict[str, TenantSpec]) -> None:
        """Reinstall displaced specs from :meth:`squeeze` — the same
        tuples, so the restored quota table is bitwise the
        pre-squeeze one."""
        with self._lock:
            for tenant, spec in priors.items():
                self._specs[tenant] = spec
                st = self._states.get(tenant)
                if st is not None:
                    st.spec = spec
        return None

    # ------------------------------------------------------------ outcomes
    @staticmethod
    def _shed_rate(st: _TenantState, now: float) -> float:
        # callers hold self._lock; windows already trimmed by callers
        n_ok = len(st.admitted)
        n_shed = len(st.shed)
        total = n_ok + n_shed
        return (n_shed / total) if total else 0.0

    def record(self, tenant: str, latency_s: float) -> None:
        """Land one served outcome; every ``PUBLISH_EVERY`` outcomes
        the tenant's rolling p99 / shed-rate gauges publish."""
        now = self._clock()
        ms = float(latency_s) * 1000.0
        with self._lock:
            st = self._state(tenant, now)
            st.window.append((now, ms))
            self._trim(st.window, now - WINDOW_S)
            st.since_publish += 1
            if st.since_publish < PUBLISH_EVERY:
                return
            st.since_publish = 0
            lats = sorted(v for _, v in st.window)
            self._trim(st.admitted, now - WINDOW_S)
            self._trim(st.shed, now - WINDOW_S)
            shed_rate = self._shed_rate(st, now)
            spec = st.spec
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        label = obs.meter.tenant_label(tenant)
        obs.gauge("tenant.p99_ms", p99, tenant=label,
                  slo_class=spec.slo_class, target_ms=spec.target_ms)
        obs.gauge("tenant.shed_rate", shed_rate, tenant=label)

    # ------------------------------------------------------------ health
    def p99_ms(self, tenant: str) -> float | None:
        now = self._clock()
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                return None
            self._trim(st.window, now - WINDOW_S)
            lats = sorted(v for _, v in st.window)
        if not lats:
            return None
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))]

    def health_doc(self) -> dict:
        """Per-tenant census for ``/healthz`` and ``/tenantz``: spec,
        window p99 vs the class target, inflight, shed totals."""
        now = self._clock()
        doc: dict = {}
        for tenant in self.tenants():
            spec = self.spec(tenant)
            with self._lock:
                st = self._states.get(tenant)
                if st is not None:
                    self._trim(st.window, now - WINDOW_S)
                    self._trim(st.admitted, now - WINDOW_S)
                    self._trim(st.shed, now - WINDOW_S)
                    lats = sorted(v for _, v in st.window)
                    inflight = st.inflight
                    shed_rate = self._shed_rate(st, now)
                else:
                    lats, inflight, shed_rate = [], 0, 0.0
            p99 = (lats[min(len(lats) - 1, int(0.99 * len(lats)))]
                   if lats else None)
            doc[tenant] = {
                "slo_class": spec.slo_class,
                "target_ms": spec.target_ms,
                "rate_rps": spec.rate_rps,
                "max_inflight": spec.max_inflight,
                "inflight": inflight,
                "p99_ms": p99,
                "shed_rate": round(shed_rate, 4),
            }
        return doc
