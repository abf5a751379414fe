"""SLO-driven autoscaler: gauge window in, fleet width out (the port of
``hpnn_tpu/fleet/autoscaler.py``).

The control loop closes the circle the telemetry plane opened: the
serve stack already *publishes* every overload signal — client-side queue depth
(``cluster.outstanding``), shed counts, and the error-budget burn rate
(obs/slo.py, or the collector's fleet ``/metrics`` when armed) — and
this module *acts* on them, calling ``WorkerSupervisor.spawn`` /
``drain_and_kill`` under hysteresis.

The decision core is the pure function :func:`decide`: a window of
``(t, outstanding, shed, burn)`` samples plus a :class:`Policy` maps
to a desired width and a reason — no clocks, no processes, no I/O —
so every policy edge (hysteresis, cool-downs, min/max clamps,
burn-dominates-queue ordering) is unit-testable with plain tuples
(tests/test_torch_fleet_cluster.py runs the JAX package's cases on
both).  Policy shape:

* **scale up fast** — one hot sample (burn rate ≥ ``up_burn``, queue
  ≥ ``up_outstanding`` rows/worker, or any shed within the trailing
  ``down_for_s`` window) grows the fleet by ``up_step`` immediately,
  gated only by ``up_cooldown_s``;
* **scale down slow** — shrinking by ``down_step`` requires *every*
  sample over a trailing ``down_for_s`` window to be calm (queue ≤
  ``down_outstanding``, no shed, burn ≤ ``down_burn``), plus the
  longer ``down_cooldown_s`` since any previous action;
* **burn dominates queue** — a hot burn rate scales up even over an
  empty queue (latency is the SLO, queue depth is only a proxy), and
  a warm burn rate vetoes scale-down no matter how idle the queue;
* **predictive slope** (opt-in, ``HPNN_FLEET_UP_SLOPE``) — a steep
  offered-load ramp (least-squares fit of outstanding-per-worker over
  the trailing ``slope_for_s`` window) scales up *before* any level
  threshold trips, buying the spawn latency back from the tail.

Actions emit ``fleet.scale_up`` / ``fleet.scale_down`` carrying the
triggering signal snapshot — and every record lands in the flight ring
(obs/flight.py) when armed, so a post-mortem dump explains each width
edge.  ``tools/check_obs_catalog.py --cluster`` lints the schema.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from hpnn_tpu_torch import obs


@dataclasses.dataclass(frozen=True)
class Policy:
    """Autoscaler policy knobs (env twins ``HPNN_FLEET_*``, the JAX
    package's ``config.KNOBS`` defaults; docs/serving.md "Cross-host
    fleet")."""

    min_width: int = 1
    max_width: int = 4
    up_outstanding: float = 8.0    # rows in flight per worker
    down_outstanding: float = 1.0
    up_burn: float = 1.0           # burn ≥ 1.0: eating future budget
    down_burn: float = 0.5
    up_step: int = 2               # scale up fast
    down_step: int = 1             # scale down slow
    up_cooldown_s: float = 3.0
    down_cooldown_s: float = 15.0
    down_for_s: float = 5.0        # calm must be sustained this long
    up_slope: float = 0.0          # predictive trigger: offered-load
                                   # ramp (rows/worker per second) that
                                   # scales up BEFORE burn; 0 disables
    slope_for_s: float = 3.0       # trailing window the ramp is fit on

    def __post_init__(self):
        if not 1 <= self.min_width <= self.max_width:
            raise ValueError("need 1 <= min_width <= max_width")
        if self.up_step < 1 or self.down_step < 1:
            raise ValueError("steps must be >= 1")
        if self.up_slope < 0 or self.slope_for_s <= 0:
            raise ValueError("need up_slope >= 0 and slope_for_s > 0")

    # env knob -> field; the names docs/serving.md tabulates
    _ENV_FIELDS = (
        ("HPNN_FLEET_MIN", "min_width", int),
        ("HPNN_FLEET_MAX", "max_width", int),
        ("HPNN_FLEET_UP_OUTSTANDING", "up_outstanding", float),
        ("HPNN_FLEET_DOWN_OUTSTANDING", "down_outstanding", float),
        ("HPNN_FLEET_UP_BURN", "up_burn", float),
        ("HPNN_FLEET_DOWN_BURN", "down_burn", float),
        ("HPNN_FLEET_UP_STEP", "up_step", int),
        ("HPNN_FLEET_DOWN_STEP", "down_step", int),
        ("HPNN_FLEET_UP_COOLDOWN_S", "up_cooldown_s", float),
        ("HPNN_FLEET_DOWN_COOLDOWN_S", "down_cooldown_s", float),
        ("HPNN_FLEET_DOWN_FOR_S", "down_for_s", float),
        ("HPNN_FLEET_UP_SLOPE", "up_slope", float),
        ("HPNN_FLEET_SLOPE_FOR_S", "slope_for_s", float),
    )

    @classmethod
    def from_env(cls, env=None, **overrides) -> "Policy":
        """A :class:`Policy` from the ``HPNN_FLEET_*`` knobs (unset
        knobs keep the field defaults; ``overrides`` win over env).
        Raises ``ValueError`` on an unparseable knob — a silently
        ignored autoscaler limit is an outage waiting."""
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
        kwargs.update(overrides)
        return cls(**kwargs)


def _sample_field(sample, key: str, index: int):
    if isinstance(sample, dict):
        return sample.get(key)
    return sample[index]


def _slope(points) -> float:
    """Least-squares dy/dt over ``(t, y)`` pairs (0.0 when the fit is
    degenerate) — the predictive trigger's ramp estimate."""
    n = len(points)
    mt = sum(t for t, _ in points) / n
    my = sum(y for _, y in points) / n
    den = sum((t - mt) ** 2 for t, _ in points)
    if den <= 0.0:
        return 0.0
    return sum((t - mt) * (y - my) for t, y in points) / den


def decide(samples, *, width: int, policy: Policy, now: float,
           last_up_t: float | None = None,
           last_down_t: float | None = None) -> tuple[int, str]:
    """The pure decision core: ``(desired_width, reason)`` from a
    gauge window.

    ``samples`` is a time-ordered sequence of ``(t, outstanding,
    shed, burn)`` tuples (or dicts with those keys): ``outstanding``
    is mean rows in flight per worker at ``t``, ``shed`` the sheds
    since the previous sample, ``burn`` the SLO burn rate (None when
    the tracker is off).  Pure: all clock state comes in as
    arguments."""
    if width < policy.min_width:
        return policy.min_width, "below_min"
    if not samples:
        return width, "no_data"
    rows = [(
        float(_sample_field(s, "t", 0)),
        float(_sample_field(s, "outstanding", 1) or 0.0),
        float(_sample_field(s, "shed", 2) or 0.0),
        _sample_field(s, "burn", 3),
    ) for s in samples]
    t_l, out_l, _shed_l, burn_l = rows[-1]

    # ---- scale up: any single hot sample, burn first (it IS the SLO)
    reason = None
    if burn_l is not None and float(burn_l) >= policy.up_burn:
        reason = "burn"
    elif out_l >= policy.up_outstanding:
        reason = "queue"
    elif any(shed > 0 for (t, _o, shed, _b) in rows
             if t >= now - policy.down_for_s):
        # sheds older than the calm window have aged out: without the
        # bound, a ramp's sheds would pin the fleet wide for the whole
        # kept-sample horizon (~30 s) after traffic stops
        reason = "shed"
    elif policy.up_slope > 0:
        # predictive trigger: a steep offered-load ramp scales up
        # BEFORE any level threshold trips — by the time burn or queue
        # fire, up_cooldown_s + worker spawn latency are already in
        # the tail.  The ramp is a least-squares fit over the trailing
        # slope_for_s window; it needs >= 3 points spanning at least
        # half the window, or one noisy pair would whipsaw the fleet.
        pts = [(t, o) for (t, o, _s, _b) in rows
               if t >= now - policy.slope_for_s]
        if (len(pts) >= 3
                and pts[-1][0] - pts[0][0] >= policy.slope_for_s / 2.0
                and _slope(pts) >= policy.up_slope):
            reason = "slope"
    if reason is not None:
        if width >= policy.max_width:
            return width, f"{reason}_at_max"
        if last_up_t is not None and now - last_up_t < policy.up_cooldown_s:
            return width, f"{reason}_cooldown"
        return min(policy.max_width, width + policy.up_step), reason

    # ---- scale down: sustained calm over the whole trailing window
    if width <= policy.min_width:
        return width, "steady"
    calm_lo = now - policy.down_for_s
    window = [r for r in rows if r[0] >= calm_lo]
    covered = rows[0][0] <= calm_lo   # the window truly spans down_for_s
    if not window or not covered:
        return width, "calm_unproven"
    for (_t, out, shed, burn) in window:
        if out > policy.down_outstanding or shed > 0:
            return width, "steady"
        if burn is not None and float(burn) > policy.down_burn:
            # a warm burn rate vetoes shrink even over an idle queue
            return width, "burn_veto"
    last_act = max((t for t in (last_up_t, last_down_t)
                    if t is not None), default=None)
    if last_act is not None and now - last_act < policy.down_cooldown_s:
        return width, "down_cooldown"
    return max(policy.min_width, width - policy.down_step), "calm"


class Autoscaler:
    """The control loop: sample → :func:`decide` → act (module doc).

    ``signals()`` defaults to the router's client-side stats plus the
    local SLO tracker; inject a callable returning ``(outstanding,
    shed_total, burn)`` to drive it from the collector's fleet gauges
    or from a test script.  ``replace_dead`` keeps the supervisor's
    restart policy inside the same loop (a crashed worker is respawned
    on the next tick, width unchanged)."""

    def __init__(self, supervisor, router, *, policy: Policy = Policy(),
                 interval_s: float = 1.0, signals=None,
                 replace_dead: bool = True, clock=time.monotonic):
        self.supervisor = supervisor
        self.router = router
        self.policy = policy
        self.interval_s = float(interval_s)
        self._signals = signals or self._default_signals
        self._replace_dead = bool(replace_dead)
        self._clock = clock
        self._samples: list[tuple] = []
        self._last_shed_total = 0.0
        self._last_up_t: float | None = None
        self._last_down_t: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _default_signals(self):
        stats = self.router.stats()
        slo_doc = obs.slo.health_doc()
        burn = (slo_doc.get("burn_rate")
                if slo_doc.get("mode") == "on" else None)
        return (stats["outstanding_per_worker"],
                stats["shed_total"], burn)

    # ------------------------------------------------------------- tick
    def tick(self) -> tuple[int, str]:
        """One control-loop iteration: reap/replace dead workers,
        append a sample, decide, and act on any width change.  Returns
        ``(width_after, reason)``."""
        if self._replace_dead:
            self.supervisor.replace_dead()
        now = self._clock()
        outstanding, shed_total, burn = self._signals()
        shed_delta = max(0.0, float(shed_total) - self._last_shed_total)
        self._last_shed_total = float(shed_total)
        self._samples.append((now, outstanding, shed_delta, burn))
        keep = max(2.0 * self.policy.down_for_s, 30.0)
        self._samples = [s for s in self._samples if s[0] >= now - keep]

        width = self.supervisor.width()
        desired, reason = decide(
            self._samples, width=width, policy=self.policy, now=now,
            last_up_t=self._last_up_t, last_down_t=self._last_down_t)
        if desired > width:
            for _ in range(desired - width):
                self.supervisor.spawn()
            self._last_up_t = now
            obs.event("fleet.scale_up", from_width=width,
                      to_width=desired, reason=reason,
                      outstanding=round(float(outstanding), 3),
                      shed=shed_delta,
                      burn=None if burn is None else round(burn, 4))
        elif desired < width:
            for rank in sorted(self.supervisor.ranks(),
                               reverse=True)[:width - desired]:
                self.supervisor.drain_and_kill(rank)
            self._last_down_t = now
            obs.event("fleet.scale_down", from_width=width,
                      to_width=desired, reason=reason,
                      outstanding=round(float(outstanding), 3),
                      shed=shed_delta,
                      burn=None if burn is None else round(burn, 4))
        return self.supervisor.width(), reason

    # --------------------------------------------------------- requests
    def request_up(self, *, reason: str) -> tuple[int, int] | None:
        """Externally requested one-step scale-up (the tune plane's
        queue remediation, hpnn_tpu_torch/tune/engine.py): grow by
        ``up_step`` under the policy's max clamp, emitting the same
        audited ``fleet.scale_up`` record the loop's own decisions
        emit.  Starts the up-cooldown, so the loop and the requester
        never double-fire.  Returns ``(from_width, to_width)``, or
        None when already at max."""
        now = self._clock()
        width = self.supervisor.width()
        desired = min(self.policy.max_width, width + self.policy.up_step)
        if desired <= width:
            return None
        for _ in range(desired - width):
            self.supervisor.spawn()
        self._last_up_t = now
        obs.event("fleet.scale_up", from_width=width,
                  to_width=desired, reason=reason)
        return width, desired

    def request_down(self, to_width: int, *,
                     reason: str) -> tuple[int, int] | None:
        """Externally requested shrink back to ``to_width`` (the tune
        plane's rollback restoring the pre-apply width).  Clamped to
        the policy min; drains the highest ranks first like the
        loop's own scale-down.  Returns ``(from_width, to_width)``,
        or None when no shrink applies."""
        now = self._clock()
        width = self.supervisor.width()
        desired = max(self.policy.min_width, int(to_width))
        if desired >= width:
            return None
        for rank in sorted(self.supervisor.ranks(),
                           reverse=True)[:width - desired]:
            self.supervisor.drain_and_kill(rank)
        self._last_down_t = now
        obs.event("fleet.scale_down", from_width=width,
                  to_width=desired, reason=reason)
        return width, desired

    # ------------------------------------------------------------- loop
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hpnn-autoscaler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # keep the loop alive: control
                # plane faults must not take down the data plane
                obs.event("fleet.scale_error",
                          error=f"{type(exc).__name__}: {exc}")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
