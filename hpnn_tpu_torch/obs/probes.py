"""Numerics probes + the sentinel (the port of ``hpnn_tpu/obs/probes.py``).

The reference's acceptance criterion is numerical consistency — abs-sums
agreeing to 1e-14 (vectors) / 1e-12 (weight matrices) across backends
(reference ChangeLog:33-38).  This module turns that offline criterion
into a runtime signal:

* **probes** — per-named-tensor abs-sum, absmax, L2, mean and NaN/Inf
  counts (:func:`_stats_matrix`), computed from host copies of the
  weights in float64, so a card run and a CPU run sum the same values in
  the same order.  The training step is untouched whether probes are on
  or off: the stats read the weights after it;
* **checksum ledger** — every check appends one row to the
  ``HPNN_LEDGER`` JSONL artifact (obs/ledger.py; diff tool:
  tools/ledger_diff.py);
* **NaN tripwire** — a non-finite value in any weight tensor emits
  ``numerics.nan``, dumps the flight ring and, under
  ``HPNN_NUMERICS=abort``, raises :class:`NumericsError`.

The JAX package also runs a cross-rank divergence sentinel over its
collectives; this package runs one process, so there is no second rank
to compare with until multi-process training is ported.

Knobs (each read once and memoized; all unset = zero overhead):

* ``HPNN_PROBES=1`` — per-tensor ``numerics.probe`` events and the
  ``numerics.nan_count`` / ``numerics.inf_count`` /
  ``numerics.absmax`` gauges;
* ``HPNN_NUMERICS=warn|abort`` — sentinel mode (default ``warn``);
* ``HPNN_LEDGER=<path>`` — the checksum ledger (obs/ledger.py).

Setting ANY of the three activates the per-check machinery
(:func:`enabled`); drivers gate their call sites on it.  stdout is never
written.
"""

from __future__ import annotations

import os
import threading

from hpnn_tpu_torch.obs import export, flight, ledger

ENV_PROBES = "HPNN_PROBES"
ENV_MODE = "HPNN_NUMERICS"

# the reference ChangeLog consistency criterion (ChangeLog:33-38):
# abs-sums agree to 1e-14 for vectors, 1e-12 for weight matrices
VEC_TOL = 1e-14
MAT_TOL = 1e-12

MODES = ("warn", "abort")


class NumericsError(RuntimeError):
    """The numerics sentinel tripped under ``HPNN_NUMERICS=abort``.

    Raised out of the check site (AFTER the events are emitted, the
    sink flushed, and the flight ring dumped), so it propagates out of
    the driver and the process exits non-zero with the postmortem
    already on disk."""


# None = env not read yet; False = inactive; dict = active config
_cfg: dict | bool | None = None
_cfg_lock = threading.Lock()

# last verdict of check_weights (the /healthz numerics document)
_last_verdict: dict | None = None
_verdict_lock = threading.Lock()


def _config():
    global _cfg
    cfg = _cfg
    if cfg is None:
        with _cfg_lock:
            if _cfg is None:
                probes_on = bool(os.environ.get(ENV_PROBES))
                mode = os.environ.get(ENV_MODE, "")
                if mode and mode not in MODES:
                    import sys

                    sys.stderr.write(
                        f"hpnn obs: unknown HPNN_NUMERICS mode {mode!r} "
                        "(want warn|abort); using warn\n")
                    mode = "warn"
                if not (probes_on or mode or ledger.enabled()):
                    _cfg = False
                else:
                    _cfg = {"probes": probes_on, "mode": mode or "warn"}
            cfg = _cfg
    return cfg


def enabled() -> bool:
    """True when any numerics knob is set (``HPNN_PROBES``,
    ``HPNN_NUMERICS``, or ``HPNN_LEDGER``).  Drivers gate their
    per-chunk/per-round check sites on this — a memoized constant-time
    read, like ``obs.enabled()``."""
    return bool(_config())


def mode() -> str:
    """The sentinel mode: ``"warn"`` (default) or ``"abort"``.
    ``"off"`` when the whole subsystem is inactive."""
    cfg = _config()
    return cfg["mode"] if cfg else "off"


def configure_mode(new_mode: str | None) -> None:
    """Programmatic twin of ``HPNN_NUMERICS`` (the CLI ``--numerics``
    flag): set or clear the mode and forget the memoized config."""
    if new_mode:
        os.environ[ENV_MODE] = new_mode
    else:
        os.environ.pop(ENV_MODE, None)
    _reset_for_tests()


def tolerance_for(shape) -> float:
    """The reference tolerance for one tensor: 1e-14 when it is
    vector-like (fewer than two dims of extent > 1), 1e-12 for a real
    matrix (ChangeLog:33-38).  ``tools/ledger_diff.py`` carries the
    same rule (kept stdlib-self-contained there on purpose)."""
    dims = [int(d) for d in shape]
    if len([d for d in dims if d > 1]) >= 2:
        return MAT_TOL
    return VEC_TOL


def _stats_matrix(weights):
    """(n_tensors, 6) float64 stats — [abs_sum, absmax, l2, mean,
    nan_count, inf_count] per tensor — over float64 host copies of
    ``weights`` (tensors on any device, or numpy arrays)."""
    import numpy as np
    import torch

    rows = []
    for w in weights:
        t = (w.detach() if isinstance(w, torch.Tensor)
             else torch.from_numpy(np.asarray(w)))
        t = t.to(device="cpu", dtype=torch.float64)
        a = t.abs()
        rows.append(torch.stack([
            a.sum(), a.max(), torch.sqrt((t * t).sum()), t.mean(),
            torch.isnan(t).sum().to(torch.float64),
            torch.isinf(t).sum().to(torch.float64)]))
    return torch.stack(rows).numpy()


def weight_names(n_layers: int) -> tuple:
    """The ledger's tensor names, ``w0`` .. ``w{n-1}`` (the JAX
    package's ``models.kernel.weight_names``)."""
    return tuple(f"w{i}" for i in range(n_layers))


def check_weights(weights, *, step, where: str, names=None) -> dict | None:
    """Run one numerics check over ``weights`` (a tuple of per-layer
    tensors or host arrays).

    Emits the ``numerics.checksum`` event (carrying the full checksum
    dict, so the flight ring always holds the last known-good
    checksums), per-tensor probes/gauges when ``HPNN_PROBES`` is set,
    appends the ledger row and runs the NaN tripwire.  Returns the
    verdict dict, or None when inactive.  Raises :class:`NumericsError`
    on a tripped sentinel under ``HPNN_NUMERICS=abort``."""
    cfg = _config()
    if not cfg:
        return None
    from hpnn_tpu_torch import obs

    ws = tuple(weights)
    if names is None:
        names = weight_names(len(ws))
    mat = _stats_matrix(ws)
    shapes = {n: [int(d) for d in w.shape] for n, w in zip(names, ws)}
    checksums = {n: float(mat[i, 0]) for i, n in enumerate(names)}
    nan_total = int(mat[:, 4].sum())
    inf_total = int(mat[:, 5].sum())
    clean = nan_total == 0 and inf_total == 0

    if cfg["probes"]:
        for i, n in enumerate(names):
            obs.event(
                "numerics.probe", tensor=n, step=step, where=where,
                abs_sum=float(mat[i, 0]), absmax=float(mat[i, 1]),
                l2=float(mat[i, 2]), mean=float(mat[i, 3]),
                nan=int(mat[i, 4]), inf=int(mat[i, 5]),
            )
        obs.gauge("numerics.nan_count", nan_total, step=step)
        obs.gauge("numerics.inf_count", inf_total, step=step)
        obs.gauge("numerics.absmax", float(mat[:, 1].max()), step=step)
    # the checksum event goes out BEFORE any failure event: the flight
    # ring then always carries the last clean checksums ahead of the
    # record that explains the failure
    obs.event("numerics.checksum", step=step, where=where, clean=clean,
              nan=nan_total, inf=inf_total, checksums=checksums)
    row = ledger.record(step=step, where=where, checksums=checksums,
                        shapes=shapes, nan=nan_total, inf=inf_total)
    verdict = {
        "step": step,
        "where": where,
        "row": row,
        "clean": clean,
        "nan": nan_total,
        "inf": inf_total,
        "divergent": False,
        "mode": cfg["mode"],
    }
    _publish(verdict)
    if not clean:
        obs.event("numerics.nan", step=step, where=where,
                  nan=nan_total, inf=inf_total)
        obs.flush()
        flight.dump("numerics.nan")
        if cfg["mode"] == "abort":
            raise NumericsError(
                f"{nan_total} NaN / {inf_total} Inf values in weights "
                f"at {where} step {step}")
    return verdict


def _publish(verdict: dict) -> None:
    global _last_verdict
    with _verdict_lock:
        _last_verdict = dict(verdict)
    export.set_health(numerics=dict(verdict))


def last_verdict() -> dict | None:
    """The most recent :func:`check_weights` verdict (the /healthz
    numerics document), or None before the first check."""
    with _verdict_lock:
        return dict(_last_verdict) if _last_verdict else None


def _reset_for_tests() -> None:
    """Forget the memoized knobs and the last verdict (chained from
    registry._reset_for_tests)."""
    global _cfg, _last_verdict
    with _cfg_lock:
        _cfg = None
    with _verdict_lock:
        _last_verdict = None
