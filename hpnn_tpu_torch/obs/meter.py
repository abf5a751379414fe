"""Per-tenant cost attribution + cardinality governor (the
``HPNN_METER`` knob).

A copy of ``hpnn_tpu/obs/meter.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

The multi-tenant host (docs/tenancy.md) runs ~10k named kernels behind
per-tenant quotas, but until this module nothing attributed *resources*
to tenants: device dispatch seconds, FLOPs and bytes (joined from the
``HPNN_COST`` catalog, obs/cost.py), queue-wait seconds, rows served,
and shed counts all vanished into per-kernel aggregates.  Worse, the
quota layer's per-tenant gauges minted one ``/metrics`` series per
tenant *name* — a 10k-tenant fleet is a cardinality bomb.  This module
is both the attribution story and the bomb disposal:

* **mergeable sketches** — one space-saving heavy-hitter sketch per
  resource axis (``device_s``, ``flops``, ``bytes``, ``queue_s``,
  ``rows``, ``sheds``).  Each sketch keeps at most ``4*K`` weighted
  entries plus an *exact* scalar total; an evicted tenant's mass is
  inherited (count, with the inherited part recorded as ``err``) by
  the newcomer, the classic Metwally space-saving scheme.  The
  exported per-tenant value is ``count - err`` — a guaranteed lower
  bound on the tenant's true mass, exact for any tenant that was never
  evicted — and the remainder ``total - sum(exported)`` rolls into
  ``tenant="_other"``, so the exported series **conserve the raw
  total exactly by construction** in every regime.
* **cardinality governor** — full-resolution per-tenant series are
  exported only for the top-``K`` tenants (``HPNN_METER_TOPK``,
  default 32) per axis; everything else is ``_other``.  ``/metrics``
  line count is O(K) regardless of tenant count.  The quota layer's
  ``tenant.p99_ms``/``tenant.shed_rate``/``tenant.inflight`` gauge
  labels route through :func:`tenant_label`: a top-K tenant keeps its
  name, the long tail collapses to ``_other`` (those gauges are then
  last-writer *samples* of the tail, not aggregates — documented in
  docs/observability.md).  When ``HPNN_METER`` is unarmed the
  governor still bounds cardinality with a first-``K``-distinct
  admission set, so the fix does not depend on the knob.
* **fleet merge** — a throttled ``meter.sketch`` record (at most one
  per ``_EMIT_EVERY_S``) carries each worker's sketches through the
  existing JSONL sink and collector push batches; the collector
  (obs/collector.py) merges them per axis — totals add, entries sum
  count and err, truncation keeps the largest — into fleet
  ``/metrics`` lines and a ``/meterz`` census, so the fleet-wide
  top-K hog is computable centrally.  ``tools/tenant_report.py``
  renders the same records from any sink set into a per-tenant blame
  table, the programmatic input ROADMAP item 5's remediation needs.

Serve-side ``/metrics`` renders the local :func:`export_doc` in both
exposition flavors (obs/export.py); ``/meterz`` on the serve server is
the local census; an armed ``HPNN_CAPSULE_DIR`` capsule bundles
:func:`sketch_doc` as ``meter.json``.  Schema lint:
``tools/check_obs_catalog.py --meter``; E2E drill:
``tools/chaos_drill.py --drill hog``; overhead gate: ``bench.py``
``meter_overhead_pct``.

Contract (the usual obs rules, proven by tools/check_tokens.py):
``HPNN_METER`` unset ⇒ one env read ever, then every tap is a
constant-time early return (plus one bounded set lookup in
:func:`tenant_label`, the unarmed governor); never a stdout byte;
stdlib only.
"""

from __future__ import annotations

import os
import threading
import time

from hpnn_tpu_torch.obs import registry

ENV_KNOB = "HPNN_METER"
ENV_TOPK = "HPNN_METER_TOPK"

DEFAULT_TOPK = 32
OTHER = "_other"

# resource axes, one sketch each; values are per-axis units:
# seconds (device_s, queue_s), FLOPs, bytes, rows, shed requests
AXES = ("device_s", "flops", "bytes", "queue_s", "rows", "sheds")

_STRIDE = 32          # taps between emission-clock checks: the
                      # meter.sketch serialization is amortized so the
                      # per-dispatch tap stays a few dict ops (the
                      # overhead bench holds meter_overhead_pct under
                      # the 5% bar)
_EMIT_EVERY_S = 0.25  # min seconds between meter.sketch records —
                      # matches the collector's default flush cadence
                      # so the fleet view is at most one interval old

# None = env not read yet; False = disabled; dict = armed config
_cfg: dict | bool | None = None
_lock = threading.Lock()

_sk: dict[str, "_SpaceSaving"] = {}  # axis -> sketch
_seen: set[str] = set()              # distinct tenants (bounded: cap)
_fallback: set[str] = set()          # unarmed governor admission set
_taps = 0                            # taps since last emission check
_last_emit = 0.0


def _knob(env: str, default, convert=float):
    """Parse one secondary knob; a malformed value warns on stderr and
    falls back to its documented default, leaving metering armed."""
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return convert(raw)
    except ValueError:
        import sys

        sys.stderr.write(f"hpnn obs: bad {env} value {raw!r}; "
                         f"using default {default}\n")
        return default


def _config() -> dict | None:
    global _cfg
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                raw = os.environ.get(ENV_KNOB, "")
                if not raw or raw == "0":
                    _cfg = False
                else:
                    k = max(1, int(_knob(ENV_TOPK, DEFAULT_TOPK, int)))
                    _cfg = {"k": k, "cap": max(64, 4 * k)}
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when ``HPNN_METER`` is armed.  First call reads the env;
    later calls are a memo hit — the taps' whole unarmed cost."""
    return _config() is not None


def topk() -> int:
    """The governor's K (``HPNN_METER_TOPK`` when armed, the default
    otherwise — the unarmed fallback admission set uses the same
    bound)."""
    cfg = _config()
    return cfg["k"] if cfg is not None else DEFAULT_TOPK


def _tenant_of(name: str) -> str:
    """Owner tenant of one kernel/batcher name.  Tenant hosts scope
    every kernel ``tenant:kernel`` (tenant/host.py); a bare name is
    the single-tenant default."""
    i = name.find(":")
    return name[:i] if i > 0 else "default"


class _SpaceSaving:
    """Metwally space-saving heavy-hitter sketch over weighted keys.

    ``entries[key] = [count, err]``: ``count`` overestimates the key's
    true mass by at most ``err`` (the count inherited from the entry it
    evicted), so ``count - err`` is a guaranteed lower bound.
    ``total`` is the exact sum of every weight ever added — evictions
    move mass between entries, never off the books — which is what
    makes the ``_other`` remainder exact.  Not thread-safe; callers
    hold the module lock."""

    __slots__ = ("cap", "total", "entries")

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self.total = 0.0
        self.entries: dict[str, list] = {}

    def add(self, key: str, w: float) -> None:
        self.total += w
        e = self.entries.get(key)
        if e is not None:
            e[0] += w
            return
        if len(self.entries) < self.cap:
            self.entries[key] = [w, 0.0]
            return
        # evict the minimum-count entry; the newcomer inherits its
        # count (recorded as err).  Deterministic key tie-break keeps
        # merge results reproducible across orderings.
        victim = min(self.entries, key=lambda t: (self.entries[t][0], t))
        floor = self.entries.pop(victim)[0]
        self.entries[key] = [floor + w, floor]

    def export(self, k: int) -> dict[str, float]:
        """Top-``k`` tenants by estimated mass (value ``count - err``,
        the lower bound) plus the exact ``_other`` remainder.  The
        values always sum to ``total``."""
        top = sorted(self.entries.items(),
                     key=lambda kv: (-kv[1][0], kv[0]))[:k]
        out = {}
        for t, (c, e) in top:
            v = c - e
            if v > 0:
                out[t] = v
        rest = self.total - sum(out.values())
        if rest > 1e-9 or len(self.entries) > len(out):
            out[OTHER] = max(rest, 0.0)
        return out

    def top_keys(self, k: int) -> list[str]:
        return [t for t, _ in sorted(self.entries.items(),
                                     key=lambda kv: (-kv[1][0], kv[0]))
                [:k]]

    def to_doc(self) -> dict:
        return {"total": round(self.total, 9),
                "entries": {t: [round(c, 9), round(e, 9)]
                            for t, (c, e) in sorted(self.entries.items())}}

    @classmethod
    def from_doc(cls, doc: dict, cap: int) -> "_SpaceSaving":
        sk = cls(cap)
        sk.total = float(doc.get("total") or 0.0)
        for t, ce in (doc.get("entries") or {}).items():
            try:
                c, e = float(ce[0]), float(ce[1])
            except (TypeError, ValueError, IndexError):
                continue
            sk.entries[str(t)] = [c, e]
        sk._truncate()
        return sk

    def merge(self, other: "_SpaceSaving") -> "_SpaceSaving":
        """Commutative merge: totals add; shared keys sum count and
        err; overflow past ``cap`` keeps the largest counts (dropped
        mass stays in ``total``, i.e. lands in ``_other``)."""
        out = _SpaceSaving(max(self.cap, other.cap))
        out.total = self.total + other.total
        for src in (self.entries, other.entries):
            for t, (c, e) in src.items():
                cur = out.entries.get(t)
                if cur is None:
                    out.entries[t] = [c, e]
                else:
                    cur[0] += c
                    cur[1] += e
        out._truncate()
        return out

    def _truncate(self) -> None:
        if len(self.entries) <= self.cap:
            return
        keep = sorted(self.entries.items(),
                      key=lambda kv: (-kv[1][0], kv[0]))[:self.cap]
        self.entries = {t: ce for t, ce in keep}


def _add(cfg: dict, tenant: str, **axes: float) -> None:
    """Fold weights into the per-axis sketches under the lock, then
    run the amortized emission check.  The emission itself (a registry
    event that fans into the sink, the flight ring, and the collector
    push queue) happens OUTSIDE the lock."""
    global _taps, _last_emit
    rec = None
    with _lock:
        for axis, w in axes.items():
            if not w:
                continue
            sk = _sk.get(axis)
            if sk is None:
                sk = _sk[axis] = _SpaceSaving(cfg["cap"])
            sk.add(tenant, w)
        if len(_seen) < 4 * cfg["cap"]:
            _seen.add(tenant)
        _taps += 1
        if _taps >= _STRIDE:
            _taps = 0
            now = time.monotonic()
            if now - _last_emit >= _EMIT_EVERY_S:
                _last_emit = now
                rec = _sketch_fields(cfg)
    if rec is not None:
        registry.event("meter.sketch", **rec)


def _sketch_fields(cfg: dict) -> dict:
    """The ``meter.sketch`` record body (caller holds the lock):
    per-axis raw sketches for the fleet merge plus the governed
    ``export`` view the schema lint checks the O(K) bound on."""
    return {
        "k": cfg["k"],
        "tenants_seen": len(_seen),
        "axes": {ax: sk.to_doc() for ax, sk in sorted(_sk.items())},
        "export": {ax: {t: round(v, 9) for t, v in
                        sk.export(cfg["k"]).items()}
                   for ax, sk in sorted(_sk.items())},
    }


# ------------------------------------------------------------ taps

def note_dispatch(name: str, dt: float, rows: int | None = None,
                  exe: str | None = None) -> None:
    """Engine dispatch tap (serve/engine.py): attribute one measured
    device dispatch to the owning tenant — wall seconds always, FLOPs
    and bytes when the ``HPNN_COST`` catalog knows the executable
    (scaled by ``rows`` against the analyzed quantum, same rule as
    ``cost.record_dispatch``).  Constant-time no-op when unarmed."""
    cfg = _config()
    if cfg is None or dt is None or dt <= 0.0:
        return
    tenant = _tenant_of(name)
    flops = byts = 0.0
    if exe is not None:
        from hpnn_tpu_torch.obs import cost

        entry = cost.lookup(exe)
        if entry is not None:
            scale = (max(int(rows), 1) / entry["units"]
                     if rows is not None else 1.0)
            flops = (entry["flops"] or 0.0) * scale
            byts = (entry["bytes"] or 0.0) * scale
    _add(cfg, tenant, device_s=float(dt), flops=flops, bytes=byts)


def note_queue(name: str, wait_s: float, n: int = 1) -> None:
    """Batcher queue tap (serve/batcher.py drain): attribute one
    drained batch's summed queue-wait seconds (``n`` requests) to the
    owning tenant.  Constant-time no-op when unarmed."""
    cfg = _config()
    if cfg is None or wait_s is None or wait_s < 0.0:
        return
    _add(cfg, _tenant_of(name), queue_s=float(wait_s))


def note_request(tenant: str, rows: int) -> None:
    """Tenant host tap (tenant/host.py ``infer_for``): attribute one
    admitted request's served rows.  Constant-time no-op when
    unarmed."""
    cfg = _config()
    if cfg is None:
        return
    _add(cfg, tenant, rows=float(max(int(rows), 0)))


def note_shed(tenant: str) -> None:
    """Quota shed tap (tenant/quota.py): count one shed admission
    against the tenant.  Constant-time no-op when unarmed."""
    cfg = _config()
    if cfg is None:
        return
    _add(cfg, tenant, sheds=1.0)


# ------------------------------------------------------ governor

def tenant_label(tenant: str) -> str:
    """The cardinality governor for per-tenant *gauge labels*
    (tenant/quota.py): a tenant currently in any axis's top-K keeps
    its name, everything else exports as ``_other`` — so per-tenant
    gauge families stay O(K) series no matter how many tenants exist.
    Unarmed, a first-K-distinct admission set bounds cardinality the
    same way (without sketches there is no mass ranking to govern
    by)."""
    cfg = _config()
    if cfg is None:
        with _lock:
            if tenant in _fallback:
                return tenant
            if len(_fallback) < DEFAULT_TOPK:
                _fallback.add(tenant)
                return tenant
        return OTHER
    with _lock:
        for sk in _sk.values():
            if tenant in sk.entries:
                ks = sk.top_keys(cfg["k"])
                if tenant in ks:
                    return tenant
    return OTHER


# ------------------------------------------------- export surfaces

def export_doc() -> dict | None:
    """The governed local export view: ``{axis: {tenant: value, ...,
    "_other": rest}}`` with at most K+1 keys per axis, values summing
    exactly to the axis total.  Rendered onto ``/metrics`` by
    obs/export.py.  None when unarmed."""
    cfg = _config()
    if cfg is None:
        return None
    with _lock:
        return {ax: sk.export(cfg["k"]) for ax, sk in sorted(_sk.items())}


def sketch_doc() -> dict | None:
    """The ``meter.json`` capsule artifact (obs/triggers.py) — raw
    sketches plus the governed export at capture time.  None when
    unarmed."""
    cfg = _config()
    if cfg is None:
        return None
    with _lock:
        return _sketch_fields(cfg)


def meterz_doc() -> dict | None:
    """The ``/meterz`` census (serve/server.py): governor config,
    tenant count, per-axis totals and governed top-K + ``_other``.
    None when unarmed."""
    cfg = _config()
    if cfg is None:
        return None
    with _lock:
        return {
            "status": "ok",
            "k": cfg["k"],
            "cap": cfg["cap"],
            "tenants_seen": len(_seen),
            "axes": {ax: {"total": round(sk.total, 9),
                          "top": {t: round(v, 9) for t, v in
                                  sk.export(cfg["k"]).items()}}
                     for ax, sk in sorted(_sk.items())},
        }


def health_doc() -> dict:
    """The meter census for ``/healthz``."""
    cfg = _config()
    if cfg is None:
        return {"armed": False}
    with _lock:
        return {"armed": True, "k": cfg["k"], "cap": cfg["cap"],
                "tenants_seen": len(_seen),
                "totals": {ax: round(sk.total, 9)
                           for ax, sk in sorted(_sk.items())}}


def emit_sketch() -> None:
    """Force one ``meter.sketch`` record now (tests, drills, clean
    shutdowns) regardless of the throttle.  No-op when unarmed."""
    global _last_emit, _taps
    cfg = _config()
    if cfg is None:
        return
    with _lock:
        _last_emit = time.monotonic()
        _taps = 0
        rec = _sketch_fields(cfg)
    registry.event("meter.sketch", **rec)


# -------------------------------------------------- fleet merge

def merge_sketch_docs(docs: list, k: int | None = None) -> dict:
    """Merge the ``axes`` halves of several ``meter.sketch`` records
    (one per worker, latest wins upstream) into one fleet view:
    ``{"k", "tenants_seen", "axes": {axis: {"total", "top"}}}`` where
    ``top`` is the governed top-K + ``_other`` over the merged
    sketches.  Order-independent.  Used by the collector's ``/meterz``
    and fleet ``/metrics``; tools/tenant_report.py applies the same
    rule offline."""
    if k is None:
        k = max([int(d.get("k") or DEFAULT_TOPK) for d in docs]
                or [DEFAULT_TOPK])
    cap = max(64, 4 * k)
    merged: dict[str, _SpaceSaving] = {}
    seen = 0
    for d in docs:
        seen = max(seen, int(d.get("tenants_seen") or 0))
        for ax, doc in (d.get("axes") or {}).items():
            sk = _SpaceSaving.from_doc(doc, cap)
            cur = merged.get(ax)
            merged[ax] = sk if cur is None else cur.merge(sk)
    return {
        "k": k,
        "tenants_seen": seen,
        "axes": {ax: {"total": round(sk.total, 9),
                      "top": {t: round(v, 9)
                              for t, v in sk.export(k).items()}}
                 for ax, sk in sorted(merged.items())},
    }


# ------------------------------------------------------- control

def configure(value, *, k=None) -> None:
    """Programmatic twin of the env knobs: arm metering with any
    truthy ``value`` — or disarm with None/""/0, which also clears
    ``HPNN_METER_TOPK`` — optionally pinning K, and forget the memo.
    Callers re-running ``obs.configure`` afterwards also refresh the
    registry's file-less activation."""
    if not value or value == "0":
        for env in (ENV_KNOB, ENV_TOPK):
            os.environ.pop(env, None)
    else:
        os.environ[ENV_KNOB] = str(value)
        if k is not None:
            os.environ[ENV_TOPK] = str(int(k))
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _taps, _last_emit
    with _lock:
        _cfg = None
        _sk.clear()
        _seen.clear()
        _fallback.clear()
        _taps = 0
        _last_emit = 0.0
