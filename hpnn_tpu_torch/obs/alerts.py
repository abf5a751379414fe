"""Metric-driven alerting: a rule engine over gauge streams
(``HPNN_ALERTS``).

A copy of ``hpnn_tpu/obs/alerts.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Gauges answer "what is the value now"; nothing in the obs stack
*watches* them — a human must read ``/metrics``.  This module turns
gauge streams into actionable signals: rules are parsed once from
``HPNN_ALERTS`` and evaluated inline on every ``obs.gauge`` emission
(event-driven — no poller thread, no sampling gap), firing
``alert.fire`` / ``alert.resolve`` events into the ordinary record
stream where the collector, the flight recorder, and
``obs_report`` already live.

Grammar (same term shape as the chaos plan, docs/resilience.md)::

    HPNN_ALERTS="replicas_down@router.ready_replicas<1.5:for=0,cooldown=5;
                 burn@slo.burn_rate>2:severity=crit;
                 drift@online.staleness_s:z=3"

comma- or semicolon-separated terms, ``NAME@GAUGE<op>VALUE[:opts]``;
a token without ``@`` folds into the previous term's options.  Three
rule kinds:

``threshold`` (``>`` / ``<``)
    breach while the gauge is beyond the bound.  SLO **burn-rate**
    alerting is this kind pointed at the ``slo.burn_rate`` gauge
    (obs/slo.py) — burning error budget at k× the sustainable rate.
``z`` (``:z=K``, no operator in the head)
    EWMA anomaly rule: keeps an exponentially-weighted mean/variance
    of the gauge and breaches while ``|v - mean| > K·σ`` — the
    drift-detection primitive (ROADMAP 4b) that needs no absolute
    threshold.  Options ``alpha`` (EWMA weight, default 0.2) and
    ``warmup`` (samples before the rule arms, default 10).

Options: ``for=<s>`` (breach must hold this long before firing,
default 0 — fires on the first breaching sample), ``cooldown=<s>``
(minimum gap between consecutive fires of one rule, default 30),
``severity=<info|warn|crit>`` (default warn).

On fire the engine dumps the flight recorder (obs/flight.py) and
attaches the dump path to the ``alert.fire`` event — the last N
records *leading up to* the alert are preserved at the moment it
trips, not at the later crash that may follow.  Resolution emits
``alert.resolve`` with the active duration.  ``health_doc()`` is the
alert census served on ``/healthz`` (serve server + collector).

Contract (same as every obs knob): ``HPNN_ALERTS`` unset ⇒ one env
read ever, then the gauge hook is never installed — no per-gauge
overhead, no stdout bytes (tools/check_tokens.py proves the byte
freeze with rules armed and firing).  Malformed terms degrade to "no
rule" with one stderr warning, never a crash.  stdlib-only.
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time

from hpnn_tpu_torch.obs import flight, registry

ENV_KNOB = "HPNN_ALERTS"

# fire-time fan-out hook (obs/triggers.py capture capsules) — same
# shape as the registry's _push_hook: a module-level callable, one
# ``is not None`` check per fire, armed by triggers._install and
# disarmed by its reset.  Called with a copy of the fire record.
_fire_hook = None

DEFAULT_COOLDOWN_S = 30.0
DEFAULT_ALPHA = 0.2
DEFAULT_WARMUP = 10
SEVERITIES = ("info", "warn", "crit")


class _Rule:
    __slots__ = ("name", "gauge", "kind", "op", "value", "z", "for_s",
                 "cooldown_s", "severity", "alpha", "warmup",
                 # runtime state
                 "active", "active_since", "breach_since", "last_fire",
                 "fired", "n", "mean", "var")

    def __init__(self, name, gauge, kind, *, op=None, value=None,
                 z=None, for_s=0.0, cooldown_s=DEFAULT_COOLDOWN_S,
                 severity="warn", alpha=DEFAULT_ALPHA,
                 warmup=DEFAULT_WARMUP):
        self.name = name
        self.gauge = gauge
        self.kind = kind        # "threshold" | "z"
        self.op = op            # ">" | "<" (threshold only)
        self.value = value      # bound (threshold only)
        self.z = z              # K sigmas (z only)
        self.for_s = float(for_s)
        self.cooldown_s = float(cooldown_s)
        self.severity = severity
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.active = False
        self.active_since = 0.0
        self.breach_since = None
        self.last_fire = None
        self.fired = 0
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def _breach(self, v: float) -> tuple[bool, dict]:
        if self.kind == "threshold":
            hit = v > self.value if self.op == ">" else v < self.value
            return hit, {"threshold": self.value, "op": self.op}
        # EWMA z-score: judge against the stats from BEFORE this
        # sample, then fold the sample in (an anomaly must not hide
        # itself inside its own statistics)
        std = math.sqrt(self.var) if self.var > 0 else 0.0
        if std > 0:
            # capped so the record stays JSON-finite for the lint
            score = min(abs(v - self.mean) / std, 1e9)
        else:
            # zero variance: any deviation is infinitely many sigmas
            score = 1e9 if v != self.mean else 0.0
        armed = self.n >= self.warmup
        self.n += 1
        if self.n == 1:
            self.mean = v
        else:
            d = v - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * d * d)
        return (armed and score > self.z), {
            "z": round(score, 3), "z_limit": self.z,
            "ewma_mean": round(self.mean, 6),
        }

    def observe(self, v: float, now: float) -> None:
        hit, detail = self._breach(v)
        if hit:
            if self.breach_since is None:
                self.breach_since = now
            if self.active:
                return
            if now - self.breach_since < self.for_s:
                return
            if (self.last_fire is not None
                    and now - self.last_fire < self.cooldown_s):
                return  # cooling down; breach_since keeps accruing
            self.active = True
            self.active_since = now
            self.last_fire = now
            self.fired += 1
            rec = {"rule": self.name, "gauge": self.gauge,
                   "value": round(v, 6), "severity": self.severity}
            rec.update(detail)
            dump = flight.dump(f"alert:{self.name}")
            if dump:
                rec["flight"] = dump
            registry.event("alert.fire", **rec)
            hook = _fire_hook
            if hook is not None:
                hook(dict(rec))  # capsule capture (obs/triggers.py)
        else:
            self.breach_since = None
            if not self.active:
                return
            self.active = False
            rec = {"rule": self.name, "gauge": self.gauge,
                   "value": round(v, 6), "severity": self.severity,
                   "duration_s": round(now - self.active_since, 6)}
            rec.update(detail)
            registry.event("alert.resolve", **rec)

    def doc(self) -> dict:
        out = {"rule": self.name, "gauge": self.gauge,
               "kind": self.kind, "severity": self.severity,
               "active": self.active, "fired": self.fired}
        if self.kind == "threshold":
            out["threshold"] = self.value
            out["op"] = self.op
        else:
            out["z"] = self.z
        return out


# Memoized rule set: None = env not read yet, False = disarmed,
# {gauge: [_Rule]} = armed.
_rules: dict[str, list[_Rule]] | bool | None = None
_lock = threading.Lock()


def _parse(spec: str) -> dict[str, list[_Rule]]:
    """``spec`` -> {gauge: [_Rule]}.  Malformed terms are skipped with
    one stderr warning each — a typo in an alert plan must degrade to
    "no rule", never crash the process it watches."""
    terms: list[str] = []
    for token in spec.replace(";", ",").split(","):
        token = token.strip()
        if not token:
            continue
        if "@" not in token and terms:
            terms[-1] += "," + token  # option continuation
        else:
            terms.append(token)
    rules: dict[str, list[_Rule]] = {}
    for term in terms:
        try:
            head, _, tail = term.partition(":")
            name, _, target = head.partition("@")
            opts: dict[str, str] = {}
            for kv in tail.split(","):
                if kv.strip():
                    k, _, v = kv.partition("=")
                    opts[k.strip()] = v.strip()
            kw = {
                "for_s": float(opts.pop("for", 0.0)),
                "cooldown_s": float(opts.pop("cooldown",
                                             DEFAULT_COOLDOWN_S)),
                "severity": opts.pop("severity", "warn"),
                "alpha": float(opts.pop("alpha", DEFAULT_ALPHA)),
                "warmup": int(opts.pop("warmup", DEFAULT_WARMUP)),
            }
            if kw["severity"] not in SEVERITIES:
                raise ValueError(f"severity {kw['severity']!r}")
            if "z" in opts:
                rule = _Rule(name, target, "z",
                             z=float(opts.pop("z")), **kw)
            else:
                for op in (">", "<"):
                    if op in target:
                        gauge, _, bound = target.partition(op)
                        rule = _Rule(name, gauge, "threshold", op=op,
                                     value=float(bound), **kw)
                        break
                else:
                    raise ValueError("no operator and no z= option")
            if opts:
                raise ValueError(f"unknown option(s) {sorted(opts)}")
            if not rule.name or not rule.gauge:
                raise ValueError("empty rule or gauge name")
            rules.setdefault(rule.gauge, []).append(rule)
        except (ValueError, TypeError) as exc:
            sys.stderr.write(
                f"hpnn obs: bad HPNN_ALERTS term {term!r}: {exc}; "
                f"term skipped\n")
    return rules


def _config() -> dict[str, list[_Rule]] | None:
    global _rules
    r = _rules
    if r is None:
        with _lock:
            if _rules is None:
                spec = os.environ.get(ENV_KNOB, "")
                _rules = _parse(spec) if spec else False
            r = _rules
    return r if r is not False else None


def enabled() -> bool:
    """True when ``HPNN_ALERTS`` parsed to at least one rule."""
    r = _config()
    return bool(r)


def _on_gauge(name: str, value: float) -> None:
    """The registry's gauge hook: evaluate every rule watching this
    gauge.  Installed only when the knob is set, so the unset path
    never pays the call."""
    r = _config()
    if not r:
        return
    watchers = r.get(name)
    if not watchers:
        return
    now = time.monotonic()
    with _lock:
        for rule in watchers:
            rule.observe(float(value), now)


def _install() -> None:
    """Arm the registry's gauge hook (called from ``registry._init``
    when the knob is set).  Safe to call repeatedly."""
    if _config():
        registry._gauge_hook = _on_gauge


def configure(spec: str | None) -> None:
    """Programmatic twin of the env knob: (re)install the rule set —
    or disarm with None/"" — and forget the memo."""
    if spec:
        os.environ[ENV_KNOB] = spec
    else:
        os.environ.pop(ENV_KNOB, None)
    _reset_for_tests()


def health_doc() -> dict:
    """The alert census for ``/healthz``: every rule with its state."""
    r = _config()
    if not r:
        return {"armed": False, "rules": []}
    with _lock:
        rules = [rule.doc() for watchers in r.values()
                 for rule in watchers]
    return {
        "armed": True,
        "rules": sorted(rules, key=lambda d: d["rule"]),
        "active": sum(1 for d in rules if d["active"]),
        "fired_total": sum(d["fired"] for d in rules),
    }


def _reset_for_tests() -> None:
    global _rules
    with _lock:
        _rules = None
    registry._gauge_hook = None
