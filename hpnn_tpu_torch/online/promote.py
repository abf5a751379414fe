"""Gated atomic promotion of online-trained candidates (the port of
``hpnn_tpu/online/promote.py``: the gate, the promoter, rollback and
the regression watch carry over as they are; :func:`eval_loss` is one
batched torch forward).

A candidate earns residency only by passing BOTH gates:

1. **sentinel-clean** — a host finiteness sweep plus, when a numerics
   knob is armed, the full :func:`obs.probes.check_weights` flow
   (checksum event, ledger row, NaN tripwire, divergence sentinel).
   Under ``HPNN_NUMERICS=abort`` a dirty candidate raises
   ``NumericsError`` *inside the gate*; the gate converts that to a
   rejection — a poisoned candidate must never take down the resident
   serving process.
2. **held-out eval margin** — the candidate's loss on the held-out
   eval set must beat the resident version's by ``Gate.margin``
   (relative): ``cand < resident * (1 - margin)``.

Promotion is the serve registry's in-memory ``install`` path: a new
immutable ``Entry`` with a bumped version, engine warmed on the new
version and old executables evicted — no disk round-trip, and
in-flight batches finish on the entry they dispatched with (never a
torn read).  The prior entry is retained for rollback: a post-
promotion SLO breach or serve-side numerics regression inside the
``Gate.watch_s`` window re-installs the prior weights *object*, so
answers are bitwise-identical to the pre-promotion version (the
parity-mode closure maths over the exact same host arrays).

Durability: with a :class:`~hpnn_tpu_torch.online.wal.PromotionWAL` attached
(``HPNN_WAL_DIR``), every successful install — promotion or rollback —
is committed checkpoint-first to the WAL (``online.checkpoint``
event), so a killed process resumes the last promoted weights bitwise
(docs/resilience.md).  A durability failure is counted
(``online.checkpoint_failed``), never raised: losing persistence must
not take down the serving process.

Events: ``online.promote`` / ``online.reject`` / ``online.rollback``;
gauges ``online.candidate_loss`` / ``online.resident_loss`` /
``online.promote_latency_ms``.  Catalog: docs/online.md.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

import torch

from hpnn_tpu_torch import chaos, obs, runtime
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.obs.probes import NumericsError
from hpnn_tpu_torch.online.ingest import _env_float

REJECT_SENTINEL = "sentinel"
REJECT_MARGIN = "margin"
REJECT_EVAL = "eval"


class Gate:
    """Promotion-gate policy.  ``margin`` is the required *relative*
    eval improvement (``HPNN_ONLINE_MARGIN``, default 0.01);
    ``watch_s`` the post-promotion regression-watch window
    (``HPNN_ONLINE_WATCH_S``, default 30); ``min_eval_rows`` the
    smallest held-out set a promotion may be justified by."""

    def __init__(self, *, margin: float | None = None,
                 watch_s: float | None = None, min_eval_rows: int = 4):
        self.margin = float(margin if margin is not None
                            else _env_float("HPNN_ONLINE_MARGIN", 0.01))
        self.watch_s = float(watch_s if watch_s is not None
                             else _env_float("HPNN_ONLINE_WATCH_S", 30.0))
        self.min_eval_rows = int(min_eval_rows)


# one eval function per (model, topology, eval rows), keyed as the JAX
# package's jit cache is: candidate and resident share it, so the margin
# comparison is apples-to-apples.  Nothing is compiled: the function is
# the batched forward and the model's per-row error.
_EVAL_FNS: dict = {}
_EVAL_LOCK = threading.Lock()


def eval_loss(weights, X, T, *, model: str = "ann", device=None) -> float:
    """Mean per-sample training error of ``weights`` over the eval
    block — the gate's scoring function: one batched forward
    (``run_batch``) and the model's ``train_error`` on each row, on
    ``device`` (``runtime.resolve_device``: the card unless the caller
    asks for the CPU) in ``runtime.compute_dtype``, on the caller's
    current stream.  Reading the result waits for that stream
    only."""
    mod = snn if model == "snn" else ann
    key = (model,
           tuple(tuple(int(d) for d in np.shape(w)) for w in weights),
           int(np.asarray(X).shape[0]))
    with _EVAL_LOCK:
        fn = _EVAL_FNS.get(key)
    if fn is None:
        row_error = torch.func.vmap(mod.train_error)

        def fn(ws, Xb, Tb, _run=mod.run_batch, _err=row_error):
            return torch.mean(_err(_run(ws, Xb), Tb))

        with _EVAL_LOCK:
            fn = _EVAL_FNS.setdefault(key, fn)
    dev = runtime.resolve_device(device)
    dt = runtime.compute_dtype(dev)
    with torch.no_grad():
        ws = tuple(torch.as_tensor(np.asarray(w), device=dev, dtype=dt)
                   for w in weights)
        loss = fn(ws, torch.as_tensor(np.asarray(X), device=dev, dtype=dt),
                  torch.as_tensor(np.asarray(T), device=dev, dtype=dt))
        return float(loss)


class Promoter:
    """Per-kernel promotion state over one ``serve.Session``: the
    gate, the prior-entry store for rollback, and the post-promotion
    regression watch."""

    def __init__(self, session, *, gate: Gate | None = None,
                 clock=time.monotonic, wal=None):
        self.session = session
        # eval_loss runs on the serve engine's device
        self.device = session.engine.device
        self.gate = gate or Gate()
        self.wal = wal                # PromotionWAL | None (no disk)
        self._clock = clock
        self._lock = obs.lockwatch.lock("online.promote")
        self._prior: dict[str, object] = {}    # guarded: _lock
        self._watch: dict[str, dict] = {}      # guarded: _lock
        self.stats = {"promoted": 0, "rejected": 0,
                      "rollbacks": 0}          # guarded: _lock
        self.last_promote_latency_s: float | None = None  # guarded: _lock
        self.last_losses: dict[str, tuple] = {}           # guarded: _lock

    # ----------------------------------------------------------- verdict
    def _reject(self, name: str, reason: str, **fields) -> str:
        obs.event("online.reject", kernel=name, reason=reason, **fields)
        with self._lock:
            self.stats["rejected"] += 1
        return reason

    def consider(self, name: str, candidate_weights, eval_set, *,
                 step: int, trace=None) -> str:
        """Run the full gate over one candidate; returns "promoted"
        or the rejection reason ("sentinel" | "margin" | "eval").
        With spans armed the verdict runs under an
        ``online.promote_gate`` span parented to ``trace`` (the
        trainer's round context) — the tail of the ingest → trainer →
        promote causal chain (docs/observability.md)."""
        gspan = obs.spans.start("online.promote_gate", kernel=name,
                                step=step,
                                **obs.propagate.fields(trace))
        try:
            outcome = self._consider(name, candidate_weights, eval_set,
                                     step=step)
        except BaseException as exc:
            obs.spans.finish(gspan, failed=type(exc).__name__)
            raise
        obs.spans.finish(gspan, outcome=outcome)
        return outcome

    def _consider(self, name: str, candidate_weights, eval_set, *,
                  step: int) -> str:
        ws = tuple(np.asarray(w) for w in candidate_weights)
        # host finiteness sweep: always on — the gate itself must not
        # depend on any obs knob being armed
        if not all(np.isfinite(w).all() for w in ws):
            return self._reject(name, REJECT_SENTINEL, step=step)
        # full sentinel flow (ledger row, divergence, tripwire) when a
        # numerics knob is armed; an abort-mode trip is *handled* here
        try:
            verdict = obs.probes.check_weights(
                ws, step=step, where="online_gate")
        except NumericsError:
            return self._reject(name, REJECT_SENTINEL, step=step,
                                mode="abort")
        if verdict is not None and (not verdict["clean"]
                                    or verdict["divergent"]):
            return self._reject(name, REJECT_SENTINEL, step=step)

        if eval_set is None:
            return self._reject(name, REJECT_EVAL, step=step,
                                detail="no held-out eval data")
        X, T = eval_set
        if np.asarray(X).shape[0] < self.gate.min_eval_rows:
            return self._reject(name, REJECT_EVAL, step=step,
                                detail="held-out eval set too small")
        resident = self.session.registry.get(name)
        cand_loss = eval_loss(ws, X, T, model=resident.model,
                              device=self.device)
        res_loss = eval_loss(resident.kernel.weights, X, T,
                             model=resident.model, device=self.device)
        obs.gauge("online.candidate_loss", cand_loss, kernel=name)
        obs.gauge("online.resident_loss", res_loss, kernel=name)
        with self._lock:
            self.last_losses[name] = (cand_loss, res_loss)
        if not np.isfinite(cand_loss):
            return self._reject(name, REJECT_SENTINEL, step=step,
                                detail="non-finite eval loss")
        if not cand_loss < res_loss * (1.0 - self.gate.margin):
            return self._reject(name, REJECT_MARGIN, step=step,
                                cand_loss=cand_loss, res_loss=res_loss)

        # both gates passed: atomic in-memory promotion
        chaos.inject("online.promote")  # seam: pre-install failure
        t0 = self._clock()
        entry = self.session.install_kernel(
            name, kernel_mod.Kernel(weights=ws))
        dt = self._clock() - t0
        with self._lock:
            self._prior[name] = resident
            self._watch[name] = {"armed_at": self._clock(),
                                 "version": entry.version}
            self.stats["promoted"] += 1
            self.last_promote_latency_s = dt
        obs.event("online.promote", kernel=name,
                  from_version=resident.version,
                  to_version=entry.version, cand_loss=cand_loss,
                  res_loss=res_loss, install_s=round(dt, 6))
        obs.gauge("online.promote_latency_ms", round(dt * 1e3, 3),
                  kernel=name)
        self._persist(name, entry, reason="promote", step=step)
        return "promoted"

    def _persist(self, name: str, entry, *, reason: str,
                 step: int = 0) -> None:
        """Commit ``entry`` to the promotion WAL (checkpoint first,
        fsync'd log record second).  Best-effort by design: a full
        disk must not fail the promotion that already happened."""
        if self.wal is None:
            return
        chaos.inject("online.checkpoint")  # seam: mid-commit crash
        try:
            rec = self.wal.commit(name, entry.kernel.weights,
                                  version=entry.version,
                                  model=entry.model, reason=reason,
                                  step=step)
        except Exception as exc:
            obs.count("online.checkpoint_failed", kernel=name,
                      reason=type(exc).__name__)
            print(f"hpnn online: WAL commit failed for {name!r}: "
                  f"{exc!r}", file=sys.stderr)
            return
        obs.event("online.checkpoint", kernel=name,
                  version=entry.version, reason=reason,
                  ckpt=rec["ckpt"])

    # ---------------------------------------------------------- rollback
    def rollback(self, name: str, *, reason: str = "manual"):
        """Re-install the pre-promotion entry's weights (bitwise — the
        same host arrays) as a new version; returns the new Entry, or
        None when there is nothing to roll back to."""
        with self._lock:
            prior = self._prior.pop(name, None)
            self._watch.pop(name, None)
        if prior is None:
            return None
        current = self.session.registry.get(name)
        entry = self.session.install_kernel(name, prior.kernel)
        with self._lock:
            self.stats["rollbacks"] += 1
        obs.event("online.rollback", kernel=name,
                  from_version=current.version,
                  to_version=entry.version,
                  restored=prior.version, reason=reason)
        self._persist(name, entry, reason=f"rollback:{reason}")
        return entry

    def watching(self, name: str) -> bool:
        with self._lock:
            return name in self._watch

    def check_watch(self) -> list[str]:
        """Post-promotion regression scan: inside each armed watch
        window, a serve-side numerics regression (NaN outputs recorded
        by ``probes.note_serve``) or an SLO breach rolls the kernel
        back; a watch that survives its window disarms.  Returns the
        kernels rolled back this call."""
        now = self._clock()
        with self._lock:
            armed = list(self._watch.items())
        rolled = []
        for name, w in armed:
            if now - w["armed_at"] > self.gate.watch_s:
                with self._lock:
                    self._watch.pop(name, None)
                continue
            reason = None
            num = obs.probes.health_doc([name])
            kdoc = num.get("kernels", {}).get(name)
            if kdoc is not None and not kdoc.get("clean", True):
                reason = "numerics"
            if reason is None:
                slo = obs.slo.health_doc()
                if (slo.get("mode") == "on" and slo.get("served")
                        and slo.get("verdict") == "breach"):
                    reason = "slo"
            if reason is not None and self.rollback(
                    name, reason=reason) is not None:
                rolled.append(name)
        return rolled
