"""The self-tuning policy engine: blame in, one audited knob out.

A copy of ``hpnn_tpu/tune/engine.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Sensor → decision → actuator → watch, each stage separable:

* **sensor** — the rolling fleet blame split
  (:func:`hpnn_tpu_torch.obs.blame.fleet_doc`) plus the SLO burn rate
  (obs/slo.py).  No burn, no action: a healthy SLO means the current
  shape of the tail is nobody's problem.
* **decision** — the pure function :func:`decide`: sensor + policy +
  clock state map to a verdict (``apply`` naming the action, or one
  of the explicit do-nothing verdicts — ``burn_ok`` /
  ``no_dominant`` / ``thin_window`` / ``cooldown`` /
  ``watch_active`` / ``no_sensor``), so every policy edge is
  unit-testable with plain dicts (tests/test_tune.py), exactly the
  shape ``fleet/autoscaler.py decide()`` established.
* **actuators** — one object per action (``scale_up`` /
  ``precision_down`` / ``grow_buckets`` / ``quota_squeeze``,
  :data:`RULE_OF`), each returning the **prior** config it displaced
  so rollback restores it bitwise, each able to refuse with a typed
  :class:`Veto` (fleet at max, precision at floor, quant-error bound
  breached, bucket menu exhausted, no rate caps declared).
* **watch** — an applied action arms a bounded window
  (``HPNN_TUNE_WATCH_S``); a p99 regression past
  :data:`ROLLBACK_P99_RATIO` inside it rolls the action back and
  re-arms the cooldown; surviving the window disarms.  The shape is
  the online promotion gate's ``_prior``/``_watch``/``check_watch``
  (online/promote.py) applied to config instead of weights.

Audit trail: ``tune.apply`` / ``tune.rollback`` / throttled
``tune.decision`` events (schema lint:
``tools/check_obs_catalog.py --tune``), a bounded in-memory decision
ledger, and the ``/tunez`` census (serve/server.py).  One action per
cooldown (``HPNN_TUNE_COOLDOWN_S``) — a remediation plane that moves
two knobs at once can never attribute the recovery.
``HPNN_TUNE_DRY=1`` runs the whole sensor → decision pipeline but
stops short of actuating (verdict ``dry_run``) — the shadow mode to
trust the policy before handing it knobs.  docs/selftuning.md.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from collections import deque

from hpnn_tpu_torch import obs
from hpnn_tpu_torch.obs import blame

ENV_KNOB = "HPNN_TUNE"

# blame class -> the one knob that relieves it (package docstring)
RULE_OF = {
    "queue": "scale_up",
    "dispatch": "precision_down",
    "spill": "grow_buckets",
    "shed_retry": "quota_squeeze",
}
ACTIONS = ("scale_up", "precision_down", "grow_buckets",
           "quota_squeeze")

# every verdict decide()/tick() can return — the closed enum the
# ledger, the tune.decision event, and the schema lint share
VERDICTS = ("apply", "veto", "dry_run", "no_actuator", "watch_active",
            "cooldown", "burn_ok", "no_dominant", "thin_window",
            "no_sensor")

# precision downshift chain: one notch per action, never to int8 —
# the quantized policy is an operator decision, not an automatic one
DOWNSHIFT = {"native": "f32", "f64": "f32", "f32": "bf16"}

# post-apply regression bar: rollback when the watched p99 exceeds
# the pre-apply p99 by this ratio
ROLLBACK_P99_RATIO = 1.25
# declared tenant rate caps scale by this on quota_squeeze
QUOTA_SQUEEZE_FACTOR = 0.5
LEDGER_CAP = 64


class Veto(RuntimeError):
    """An actuator refusing its action (fleet at max, precision at
    floor, quant-error bound breached, ...).  A veto is a verdict,
    not a failure: it lands in the ledger and the ``tune.decision``
    stream, arms no watch, and emits no ``tune.apply``."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class Policy:
    """Tuning policy knobs (env twins ``HPNN_TUNE_*``,
    docs/selftuning.md)."""

    dominant_pct: float = 40.0   # a phase must own this much of the
                                 # window before it names an action
    burn_gate: float = 1.0       # act only while eating error budget
    cooldown_s: float = 30.0     # one action per cooldown
    watch_s: float = 10.0        # post-apply regression watch window
    min_roots: int = 16          # thinner blame windows prove nothing
    quant_err_max: float = 1e-2  # precision_down's measured-error bar
    dry: bool = False            # decide but never actuate

    def __post_init__(self):
        if self.cooldown_s < 0 or self.watch_s < 0:
            raise ValueError("cooldown_s/watch_s must be >= 0")
        if not 0 < self.dominant_pct <= 100:
            raise ValueError("dominant_pct must be in (0, 100]")

    # env knob -> field; the names docs/selftuning.md tabulates
    _ENV_FIELDS = (
        ("HPNN_TUNE_DOMINANT_PCT", "dominant_pct", float),
        ("HPNN_TUNE_BURN", "burn_gate", float),
        ("HPNN_TUNE_COOLDOWN_S", "cooldown_s", float),
        ("HPNN_TUNE_WATCH_S", "watch_s", float),
        ("HPNN_TUNE_QUANT_ERR", "quant_err_max", float),
    )

    @classmethod
    def from_env(cls, env=None, **overrides) -> "Policy":
        """A :class:`Policy` from the ``HPNN_TUNE_*`` knobs (unset
        knobs keep the field defaults; ``overrides`` win).  Raises
        ``ValueError`` on an unparseable knob — same contract as the
        autoscaler's: a silently ignored remediation limit is worse
        than a loud one."""
        src = os.environ if env is None else env
        kwargs: dict = {}
        for knob, field, cast in cls._ENV_FIELDS:
            raw = src.get(knob, "").strip()
            if not raw:
                continue
            try:
                kwargs[field] = cast(raw)
            except ValueError:
                raise ValueError(
                    f"{knob}={raw!r} is not a valid {cast.__name__}")
        if src.get("HPNN_TUNE_DRY", "") == "1":
            kwargs["dry"] = True
        kwargs.update(overrides)
        return cls(**kwargs)


def decide(sensor, burn, *, policy: Policy, now: float,
           last_apply_t: float | None = None,
           watch_active: bool = False) -> dict:
    """The pure decision core: ``{"verdict", "phase", "pct",
    "action"}`` from one sensor reading.

    ``sensor`` is :func:`hpnn_tpu_torch.obs.blame.fleet_doc`'s shape
    (``{"roots", "pct": {phase: pct}, ...}``) or None when blame is
    unarmed; ``burn`` the SLO burn rate or None when untracked.
    Pure: all clock state comes in as arguments.  Check order is the
    audit order — each verdict names the *first* reason nothing (or
    something) happened:

    1. no sensor → ``no_sensor`` (blame unarmed: blind planes don't
       steer);
    2. a watch armed → ``watch_active`` (one change at a time, or
       rollback can't attribute);
    3. thin window → ``thin_window``;
    4. burn under the gate → ``burn_ok`` (the SLO is healthy — the
       tail's shape is nobody's problem);
    5. no phase dominant → ``no_dominant`` (a smeared tail has no
       single knob);
    6. cooldown running → ``cooldown``;
    7. else ``apply`` with ``action = RULE_OF[phase]``.
    """
    if sensor is None:
        return {"verdict": "no_sensor", "phase": None, "pct": 0.0,
                "action": None}
    pct = sensor.get("pct", {})
    # dominant ACTIONABLE phase: other/gap have no knob by design
    phase = max(RULE_OF, key=lambda p: pct.get(p, 0.0))
    top = float(pct.get(phase, 0.0))
    d = {"phase": phase, "pct": top, "action": None}
    if watch_active:
        return dict(d, verdict="watch_active")
    if int(sensor.get("roots", 0)) < policy.min_roots:
        return dict(d, verdict="thin_window")
    if burn is None or float(burn) < policy.burn_gate:
        return dict(d, verdict="burn_ok")
    if top < policy.dominant_pct:
        return dict(d, verdict="no_dominant")
    if (last_apply_t is not None
            and now - last_apply_t < policy.cooldown_s):
        return dict(d, verdict="cooldown")
    return dict(d, verdict="apply", action=RULE_OF[phase])


# ========================================================== actuators
#
# One object per action.  apply() returns {"target", "prior" (the
# opaque restore token rollback takes), "prior_doc"/"applied" (the
# JSON summaries the tune.apply event carries)} or raises Veto;
# rollback(prior) restores the displaced config bitwise and returns
# {"restored": <json>}.

class _ScaleUpActuator:
    action = "scale_up"

    def __init__(self, autoscaler):
        self.autoscaler = autoscaler

    def apply(self) -> dict:
        change = self.autoscaler.request_up(reason="tune:queue")
        if change is None:
            raise Veto("at_max")
        from_w, to_w = change
        return {"target": "fleet", "prior": from_w,
                "prior_doc": from_w, "applied": to_w}

    def rollback(self, prior) -> dict:
        self.autoscaler.request_down(int(prior),
                                     reason="tune:rollback")
        return {"restored": int(prior)}


class _PrecisionActuator:
    action = "precision_down"

    def __init__(self, session, quant_err_max: float):
        self.session = session
        self.quant_err_max = float(quant_err_max)

    def _pick_kernel(self) -> str:
        """The kernel to downshift: heaviest in the blame window
        (per-kernel rolling split) that is actually resident, else
        the first resident kernel."""
        names = self.session.registry.names()
        if not names:
            raise Veto("no_kernel")
        for cand in blame.kernel_doc():
            if cand in names:
                return cand
        return names[0]

    def apply(self) -> dict:
        eng = self.session.engine
        if eng.mode != "compiled":
            # parity mode ignores precision by contract (bitwise
            # equality with the embedded caller) — nothing to move
            raise Veto("parity_mode")
        name = self._pick_kernel()
        entry = self.session.registry.get(name)
        cur = entry.precision or eng.default_precision or "native"
        nxt = DOWNSHIFT.get(cur)
        if nxt is None:
            raise Veto("at_floor")
        prior = {"kernel": name, "precision": entry.precision}
        self.session.registry.set_precision(name, nxt)
        # warmup compiles the new policy AND probes its error against
        # the eager f64 reference (engine._probe_quant_err) — the
        # gate is measured, never assumed
        eng.warmup([name])
        err = eng._quant_err.get(name)
        if err is not None and err > self.quant_err_max:
            # bound breached: revert immediately.  The version chain
            # stays monotone — downshift was v+1, the revert is v+2 —
            # so in-flight batches and the fleet's executable
            # identities never see a version reused
            self.session.registry.set_precision(
                name, prior["precision"])
            eng.warmup([name])
            raise Veto("quant_err")
        return {"target": name, "prior": prior,
                "prior_doc": prior["precision"] or "native",
                "applied": nxt}

    def rollback(self, prior) -> dict:
        name = prior["kernel"]
        self.session.registry.set_precision(name, prior["precision"])
        self.session.engine.warmup([name])
        return {"restored": prior["precision"] or "native"}


class _BucketActuator:
    action = "grow_buckets"

    def __init__(self, session):
        self.session = session

    def apply(self) -> dict:
        from hpnn_tpu_torch.serve.engine import bucket_menu

        eng = self.session.engine
        prior = tuple(eng.buckets)
        menu = bucket_menu(eng.max_batch, len(prior) + 1)
        if menu == prior:
            raise Veto("menu_exhausted")
        # reassignment is atomic; the added (finer) bucket compiles
        # lazily on first dispatch and is counted by serve.compile
        eng.buckets = menu
        return {"target": "engine", "prior": prior,
                "prior_doc": list(prior), "applied": list(menu)}

    def rollback(self, prior) -> dict:
        self.session.engine.buckets = tuple(prior)
        return {"restored": list(prior)}


class _QuotaActuator:
    action = "quota_squeeze"

    def __init__(self, quota):
        self.quota = quota

    def apply(self) -> dict:
        priors = self.quota.squeeze(QUOTA_SQUEEZE_FACTOR)
        if not priors:
            raise Veto("no_rate_caps")
        return {
            "target": "tenants", "prior": priors,
            "prior_doc": {t: s.rate_rps for t, s in priors.items()},
            "applied": {t: self.quota.spec(t).rate_rps
                        for t in priors},
        }

    def rollback(self, prior) -> dict:
        self.quota.restore_specs(prior)
        return {"restored": {t: s.rate_rps
                             for t, s in prior.items()}}


# ============================================================= engine

# None = env not read yet; False = disabled; True = armed
_cfg: bool | None = None
_env_lock = threading.Lock()
# the started tuner /tunez and health_doc() read (one per process in
# practice: the serving Session's)
_active: "Tuner | None" = None


def enabled() -> bool:
    """True when ``HPNN_TUNE`` is armed.  First call reads the env;
    later calls are a memo hit."""
    global _cfg
    c = _cfg
    if c is None:
        with _env_lock:
            if _cfg is None:
                raw = os.environ.get(ENV_KNOB, "")
                _cfg = bool(raw) and raw != "0"
            c = _cfg
    return c


class Tuner:
    """The control loop over one serving session: sample the blame
    sensor, :func:`decide`, actuate, watch, roll back.

    ``p99_fn`` / ``burn_fn`` default to the SLO tracker
    (obs/slo.py); inject callables (and ``clock``) to drive the loop
    from a test script or the chaos drill with no wall time."""

    def __init__(self, session=None, *, autoscaler=None, quota=None,
                 policy: Policy | None = None, interval_s: float = 1.0,
                 clock=time.monotonic, p99_fn=None, burn_fn=None):
        self.session = session
        self.policy = policy if policy is not None else Policy.from_env()
        self.interval_s = float(interval_s)
        self._clock = clock
        self._p99_fn = p99_fn or self._slo_p99
        self._burn_fn = burn_fn or self._slo_burn
        self._lock = obs.lockwatch.lock("tune.engine")
        acts = []
        if autoscaler is not None:
            acts.append(_ScaleUpActuator(autoscaler))
        if session is not None:
            acts.append(_PrecisionActuator(
                session, self.policy.quant_err_max))
            acts.append(_BucketActuator(session))
        if quota is not None:
            acts.append(_QuotaActuator(quota))
        self._actuators = {a.action: a for a in acts}
        self._ids = itertools.count(1)
        self._ledger: deque = deque(maxlen=LEDGER_CAP)  # guarded: _lock
        self._watch: dict | None = None                 # guarded: _lock
        self._last_apply_t: float | None = None
        self._last_verdict: str | None = None
        self.stats = {"ticks": 0, "applied": 0, "rolled_back": 0,
                      "vetoed": 0}                      # guarded: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- sensors
    @staticmethod
    def _slo_burn():
        doc = obs.slo.health_doc()
        return doc.get("burn_rate") if doc.get("mode") == "on" else None

    @staticmethod
    def _slo_p99():
        doc = obs.slo.health_doc()
        return doc.get("p99_ms") if doc.get("mode") == "on" else None

    # ------------------------------------------------------------ tick
    def tick(self) -> dict:
        """One control-loop iteration: settle the watch, read the
        sensor, decide, actuate.  Returns the decision dict (with
        ``verdict``) for callers that script the loop."""
        now = self._clock()
        self.check_watch(now=now)
        sensor = blame.fleet_doc()
        burn = self._burn_fn()
        with self._lock:
            self.stats["ticks"] += 1
            watch_active = self._watch is not None
            last_apply_t = self._last_apply_t
        d = decide(sensor, burn, policy=self.policy, now=now,
                   last_apply_t=last_apply_t,
                   watch_active=watch_active)
        if d["verdict"] == "apply":
            if self.policy.dry:
                d = dict(d, verdict="dry_run")
            elif d["action"] not in self._actuators:
                d = dict(d, verdict="no_actuator")
            else:
                d = self._apply(d, now)
        self._note(d, burn=burn, sensor=sensor, now=now)
        return d

    def _apply(self, d: dict, now: float) -> dict:
        act = self._actuators[d["action"]]
        try:
            res = act.apply()
        except Veto as veto:
            with self._lock:
                self.stats["vetoed"] += 1
            return dict(d, verdict="veto", reason=veto.reason)
        aid = f"t{next(self._ids)}"
        before = self._p99_fn()
        with self._lock:
            self._watch = {
                "armed_at": now, "id": aid, "action": d["action"],
                "target": res["target"], "prior": res["prior"],
                "before_p99": before,
            }
            self._last_apply_t = now
            self.stats["applied"] += 1
        obs.event("tune.apply", id=aid, action=d["action"],
                  phase=d["phase"], pct=round(d["pct"], 2),
                  target=res["target"], prior=res["prior_doc"],
                  applied=res["applied"],
                  cooldown_s=self.policy.cooldown_s,
                  watch_s=self.policy.watch_s)
        return dict(d, id=aid, target=res["target"],
                    applied=res["applied"])

    # ----------------------------------------------------------- watch
    def check_watch(self, *, now: float | None = None) -> str | None:
        """Settle the armed watch, if any: expire it (the action
        survived), or roll back on a p99 regression past
        :data:`ROLLBACK_P99_RATIO`.  Returns the rolled-back action
        name, else None."""
        now = self._clock() if now is None else now
        with self._lock:
            w = self._watch
        if w is None:
            return None
        if now - w["armed_at"] > self.policy.watch_s:
            with self._lock:
                self._watch = None
                self._ledger.append({
                    "t": now, "verdict": "watch_pass",
                    "action": w["action"], "id": w["id"]})
            return None
        p99 = self._p99_fn()
        before = w.get("before_p99")
        if (p99 is not None and before is not None and before > 0
                and float(p99) > float(before) * ROLLBACK_P99_RATIO):
            return self.rollback("p99_regression", now=now)
        return None

    def rollback(self, reason: str, *,
                 now: float | None = None) -> str | None:
        """Undo the watched action (drills call this directly to
        prove a deliberately wrong move restores the prior config).
        Returns the action name, or None when nothing is watched."""
        now = self._clock() if now is None else now
        with self._lock:
            w = self._watch
            self._watch = None
        if w is None:
            return None
        act = self._actuators[w["action"]]
        res = act.rollback(w["prior"])
        with self._lock:
            self.stats["rolled_back"] += 1
            # a rollback is itself a config move: re-arm the cooldown
            # so the same rule can't immediately re-apply
            self._last_apply_t = now
            self._ledger.append({
                "t": now, "verdict": "rollback", "reason": reason,
                "action": w["action"], "id": w["id"]})
        obs.event("tune.rollback", id=w["id"], action=w["action"],
                  target=w["target"], restored=res["restored"],
                  reason=reason)
        return w["action"]

    # ----------------------------------------------------------- audit
    def _note(self, d: dict, *, burn, sensor, now: float) -> None:
        """Ledger + throttled ``tune.decision`` stream: every verdict
        EDGE is recorded (and every apply/veto/dry_run), steady-state
        repeats are not — an idle hour must not write 3600 rows."""
        verdict = d["verdict"]
        edge = verdict != self._last_verdict
        self._last_verdict = verdict
        if not edge and verdict not in ("apply", "veto", "dry_run"):
            return
        row = {
            "t": now, "verdict": verdict, "phase": d.get("phase"),
            "pct": round(float(d.get("pct") or 0.0), 2),
            "action": d.get("action"),
            "burn": None if burn is None else round(float(burn), 4),
            "roots": int(sensor.get("roots", 0)) if sensor else 0,
        }
        if "reason" in d:
            row["reason"] = d["reason"]
        if "id" in d:
            row["id"] = d["id"]
        with self._lock:
            self._ledger.append(row)
        obs.event("tune.decision", **row)

    # ---------------------------------------------------------- census
    def census(self) -> dict:
        with self._lock:
            w = dict(self._watch) if self._watch else None
            stats = dict(self.stats)
            ledger = list(self._ledger)
        return {"stats": stats, "watch": w,
                "ledger": ledger[-16:],
                "last_verdict": self._last_verdict}

    def tunez_doc(self) -> dict:
        doc = {
            "armed": True,
            "dry": self.policy.dry,
            "policy": {
                "dominant_pct": self.policy.dominant_pct,
                "burn_gate": self.policy.burn_gate,
                "cooldown_s": self.policy.cooldown_s,
                "watch_s": self.policy.watch_s,
                "min_roots": self.policy.min_roots,
                "quant_err_max": self.policy.quant_err_max,
            },
            "rules": dict(RULE_OF),
            "actuators": sorted(self._actuators),
        }
        doc.update(self.census())
        return doc

    # ------------------------------------------------------------ loop
    def activate(self) -> None:
        """Register as the process's census target (``/tunez``,
        ``health_doc``).  ``start`` calls this; scripted loops (the
        chaos drill) call it directly."""
        global _active
        _active = self

    def start(self) -> None:
        if self._thread is not None:
            return
        self.activate()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hpnn-tuner", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # keep the loop alive: the
                # remediation plane must never take down the data
                # plane it is tuning
                obs.event("tune.error",
                          error=f"{type(exc).__name__}: {exc}")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        global _active
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        if _active is self:
            _active = None


# ------------------------------------------------------------- module

def for_session(session, *, autoscaler=None, quota=None,
                **kwargs) -> "Tuner | None":
    """The serving Session's factory: a :class:`Tuner` wired to the
    session's registry/engine (plus any autoscaler/quota the caller
    owns — defaulting to the session's own, when it has them), or
    None when ``HPNN_TUNE`` is unarmed."""
    if not enabled():
        return None
    return Tuner(session,
                 autoscaler=(autoscaler if autoscaler is not None
                             else getattr(session, "autoscaler", None)),
                 quota=(quota if quota is not None
                        else getattr(session, "quota", None)),
                 **kwargs)


def tunez_doc() -> dict | None:
    """The ``/tunez`` census — the active tuner's policy, stats,
    watch, and recent ledger.  None when ``HPNN_TUNE`` is unarmed or
    no tuner is active (the route answers 404)."""
    t = _active
    if t is None or not enabled():
        return None
    return t.tunez_doc()


def health_doc() -> dict:
    """The ``tune`` section of the serve ``/healthz`` document."""
    if not enabled():
        return {"armed": False}
    t = _active
    doc: dict = {"armed": True, "active": t is not None}
    if t is not None:
        doc["dry"] = t.policy.dry
        doc.update(t.census())
        doc.pop("ledger", None)  # /tunez carries the ledger
    return doc


def configure(value) -> None:
    """Programmatic twin of ``HPNN_TUNE``: arm with any truthy
    ``value``, disarm with None/""/0; forgets the memo either way."""
    if not value or value == "0":
        os.environ.pop(ENV_KNOB, None)
    else:
        os.environ[ENV_KNOB] = str(value)
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _active
    t = _active
    if t is not None:
        t.stop()
    with _env_lock:
        _cfg = None
        _active = None
