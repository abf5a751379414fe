"""Deterministic fault injection (``HPNN_CHAOS``): a copy of
``hpnn_tpu/chaos/__init__.py``, so a chaos plan drives the port's serve
stack as it drives the JAX package's.

The serve stack carries *named injection seams*: one
``chaos.inject("seam.name")`` call at each place a production fault
would land (engine dispatch, batcher admission/drain, registry
hot-reload, the promotion path, the online training round).  A seam
costs one function call and one ``is False`` check when the knob is
unset — same zero-overhead discipline as every obs knob; stdout is
never written.

Fault plans are parsed once from ``HPNN_CHAOS``::

    HPNN_CHAOS="kill@serve.dispatch:p=0.01,delay@batcher.submit:ms=200"

Grammar: comma- (or semicolon-) separated terms, each
``ACTION@SEAM[:key=value[,key=value...]]``.  A token without ``@`` is
folded into the previous term's parameter list, so both separators
work inside one plan.  Actions:

``kill``
    ``SIGKILL`` the current process — the un-catchable crash.
``raise``
    raise :class:`ChaosFault` (a ``RuntimeError``) at the seam.
``delay``
    sleep ``ms`` milliseconds (default 100) — latency injection.
``nan``
    corrupt the arrays passed to :func:`inject` (first element of the
    first array becomes NaN) — exercises the sentinel gate.

Parameters: ``p`` (fire probability per trigger, default 1.0),
``ms`` (delay milliseconds), ``after`` (skip the first N triggers),
``times`` (fire at most N times, default unlimited).  Randomness is
seeded per-fault from ``HPNN_CHAOS_SEED`` (default 0) so a plan
replays identically — a drill is a *deterministic* experiment.

Every fire emits a ``chaos.inject`` count (seam, action) into the obs
sink and one stderr line; stdout is never touched.  Catalog:
docs/resilience.md.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time

from hpnn_tpu_torch import obs

ENV_KNOB = "HPNN_CHAOS"
ENV_SEED = "HPNN_CHAOS_SEED"

ACTIONS = ("kill", "raise", "delay", "nan")


class ChaosFault(RuntimeError):
    """The injected failure for ``raise@<seam>`` terms."""


class _Fault:
    __slots__ = ("action", "seam", "p", "ms", "after", "times",
                 "calls", "fired", "rng")

    def __init__(self, action, seam, *, p=1.0, ms=100.0, after=0,
                 times=0, seed=0, index=0):
        self.action = action
        self.seam = seam
        self.p = float(p)
        self.ms = float(ms)
        self.after = int(after)
        self.times = int(times)  # 0 = unlimited
        self.calls = 0
        self.fired = 0
        # Seeded per-term so a plan replays identically run to run;
        # string seeding is version-2 stable across processes.
        self.rng = random.Random(f"{seed}:{index}:{action}@{seam}")

    def should_fire(self) -> bool:
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times and self.fired >= self.times:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def doc(self) -> dict:
        return {"action": self.action, "seam": self.seam, "p": self.p,
                "ms": self.ms, "after": self.after, "times": self.times,
                "calls": self.calls, "fired": self.fired}


# Memoized plan: None = env not read yet, False = disarmed,
# dict seam -> [_Fault] = armed.
_plan = None
_lock = threading.Lock()


def _parse(spec: str, seed: int):
    """``spec`` -> {seam: [_Fault]}.  Malformed terms are skipped with
    one stderr warning each — a typo in a chaos plan must degrade to
    "no fault", never crash the process under test."""
    terms: list[str] = []
    for token in spec.replace(";", ",").split(","):
        token = token.strip()
        if not token:
            continue
        if "@" not in token and terms:
            terms[-1] += "," + token  # parameter continuation
        else:
            terms.append(token)
    plan: dict[str, list[_Fault]] = {}
    for i, term in enumerate(terms):
        try:
            head, _, tail = term.partition(":")
            action, _, seam = head.partition("@")
            action = action.strip().lower()
            seam = seam.strip()
            if action not in ACTIONS or not seam:
                raise ValueError(f"unknown action or empty seam: {head!r}")
            kwargs = {}
            for kv in filter(None, tail.split(",")):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k not in ("p", "ms", "after", "times"):
                    raise ValueError(f"unknown parameter {k!r}")
                kwargs[k] = float(v)
            fault = _Fault(action, seam, seed=seed, index=i, **kwargs)
        except (ValueError, TypeError) as exc:
            print(f"hpnn chaos: ignoring malformed term {term!r}: {exc}",
                  file=sys.stderr)
            continue
        plan.setdefault(seam, []).append(fault)
    return plan if plan else False


def _config():
    global _plan
    with _lock:
        if _plan is None:
            spec = os.environ.get(ENV_KNOB, "").strip()
            if not spec:
                _plan = False
            else:
                try:
                    seed = int(os.environ.get(ENV_SEED, "0"))
                except ValueError:
                    seed = 0
                _plan = _parse(spec, seed)
        return _plan


def enabled() -> bool:
    return bool(_config())


def plan_doc() -> list[dict]:
    """The parsed plan with live fire counts, for ``/healthz`` and the
    drill harness."""
    plan = _config()
    if not plan:
        return []
    with _lock:
        return [f.doc() for faults in plan.values() for f in faults]


def inject(seam: str, arrays=None):
    """The seam entry point.  Returns ``None`` normally; for a fired
    ``nan`` fault returns a corrupted copy of ``arrays`` which the
    call site substitutes for the originals.  ``kill`` never returns;
    ``raise`` raises :class:`ChaosFault`."""
    plan = _plan
    if plan is None:
        plan = _config()
    if plan is False:
        return None
    faults = plan.get(seam)
    if not faults:
        return None
    out = None
    for f in faults:
        with _lock:
            fire = f.should_fire()
        if not fire:
            continue
        obs.count("chaos.inject", seam=seam, action=f.action)
        print(f"hpnn chaos: {f.action}@{seam} firing "
              f"(call {f.calls}, fire {f.fired})", file=sys.stderr)
        if f.action == "delay":
            time.sleep(f.ms / 1000.0)
        elif f.action == "raise":
            raise ChaosFault(f"chaos: raise@{seam}")
        elif f.action == "kill":
            sys.stderr.flush()
            obs.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        elif f.action == "nan" and arrays is not None:
            import numpy as np

            out = [np.array(a, copy=True) for a in arrays]
            for a in out:
                if a.size:
                    a.flat[0] = np.nan
                    break
            out = tuple(out)
    return out


def _reset_for_tests():
    """Forget the memoized plan (chained from
    ``obs.registry._reset_for_tests``)."""
    global _plan
    with _lock:
        _plan = None
