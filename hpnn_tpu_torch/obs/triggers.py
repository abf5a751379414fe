"""Alert-triggered capture capsules (the ``HPNN_CAPSULE_DIR`` knob): the
port of ``hpnn_tpu/obs/triggers.py``, whose ``profile/`` window is a
``torch.profiler`` trace (obs/profiler.py) instead of ``jax.profiler``.

An ``alert.fire`` tells you *when* it went wrong; by the time a human
opens the dashboard the evidence has scrolled away.  This module
closes the alert→evidence loop: armed with ``HPNN_CAPSULE_DIR=<dir>``
it subscribes to the alert engine's fire path (``alerts._fire_hook``)
— and to a manual ``POST /v1/capture`` on the serve and collector
HTTP servers — and bundles a **forensic capsule** directory at the
moment of the fire:

    <dir>/capsule-<pid>-<seq>-<reason>/
        manifest.json   what was captured, durations, errors
        flight.jsonl    the flight-ring dump (when HPNN_FLIGHT armed)
        spans.jsonl     recent sampled/promoted request spans
                        (obs/forensics.py ring)
        gauges.json     the cumulative registry snapshot
        health.json     the process /healthz document
        drift.json      reference + live drift sketches, scores, and
                        window bounds (when HPNN_DRIFT armed;
                        obs/drift.py)
        meter.json, blame.json, conn.json
                        the per-tenant meter, the rolling blame
                        window and the connection census (each when
                        its plane is armed)
        profile/        an on-demand ``torch.profiler`` trace window
                        of the whole process (``trace.json``, bounded
                        by ``HPNN_CAPSULE_PROFILE_MS``); absent when
                        the process's one profiler is taken by
                        ``--profile`` or another capsule — the
                        manifest's ``profile_refused`` says so

Captures are **at-most-one-in-flight** (a second trigger during
assembly is counted, not queued) and rate-limited by
``HPNN_CAPSULE_COOLDOWN_S`` (default 30).  The trail is ordinary obs
records — ``forensics.capture`` marks the begin (synchronously, on
the triggering thread), ``forensics.capture_done`` the end, and
``forensics.capture_skipped`` counts suppressed triggers with a
``reason`` — so ``tools/check_obs_catalog.py --forensics`` can lint
the pairing.  Alert-triggered captures assemble on a daemon thread
(the gauge path that fired the alert must never block on profiler
I/O); manual HTTP captures assemble inline so the response can carry
the capsule path.  ``health_doc()`` is the capsule census joined into
the serve / collector / cluster-router ``/healthz`` documents.

Contract (the usual obs rules): unset ⇒ one env read ever, then
constant-time no-ops; never a stdout byte; torch imported lazily and
only inside the profile window — ``import hpnn_tpu_torch.obs`` stays
stdlib-only.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time

from hpnn_tpu_torch.obs import flight, registry

ENV_KNOB = "HPNN_CAPSULE_DIR"
ENV_PROFILE_MS = "HPNN_CAPSULE_PROFILE_MS"
ENV_COOLDOWN = "HPNN_CAPSULE_COOLDOWN_S"

DEFAULT_PROFILE_MS = 200.0
DEFAULT_COOLDOWN_S = 30.0
_MAX_KEPT = 32  # manifest summaries kept for the census

# None = env not read yet; False = disabled; dict = armed config
_cfg: dict | bool | None = None
_lock = threading.Lock()
_seq = itertools.count(1)

_in_flight = False
_last_done = 0.0      # monotonic time of the last finished capture
_captures: list[dict] = []
_skipped: dict[str, int] = {}


def _config() -> dict | None:
    global _cfg
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                d = os.environ.get(ENV_KNOB, "")
                if not d:
                    _cfg = False
                else:
                    try:
                        profile_ms = float(
                            os.environ.get(ENV_PROFILE_MS, "")
                            or DEFAULT_PROFILE_MS)
                        cooldown = float(
                            os.environ.get(ENV_COOLDOWN, "")
                            or DEFAULT_COOLDOWN_S)
                    except ValueError:
                        profile_ms = DEFAULT_PROFILE_MS
                        cooldown = DEFAULT_COOLDOWN_S
                    _cfg = {"dir": d,
                            "profile_ms": max(0.0, profile_ms),
                            "cooldown_s": max(0.0, cooldown)}
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when ``HPNN_CAPSULE_DIR`` is set.  First call reads the
    env; later calls are a memo hit."""
    return _config() is not None


def _skip(reason: str) -> None:
    with _lock:
        _skipped[reason] = _skipped.get(reason, 0) + 1
    registry.count("forensics.capture_skipped", reason=reason)


def _slug(reason: str) -> str:
    out = "".join(c if c.isalnum() else "-" for c in reason)
    return out.strip("-")[:48] or "capture"


def _begin(reason: str) -> str | None:
    """Admission: at-most-one-in-flight + cooldown, then mkdir + the
    synchronous ``forensics.capture`` begin event.  Returns the
    capsule path, or None when the trigger was suppressed."""
    global _in_flight
    cfg = _config()
    if cfg is None:
        return None
    now = time.monotonic()
    with _lock:
        if _in_flight:
            skip = "in_flight"
        elif _last_done and now - _last_done < cfg["cooldown_s"]:
            skip = "cooldown"
        else:
            skip = None
            _in_flight = True
    if skip is not None:
        _skip(skip)
        return None
    path = os.path.join(
        cfg["dir"], f"capsule-{os.getpid():x}-{next(_seq)}-"
                    f"{_slug(reason)}")
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        with _lock:
            _in_flight = False
        _skip("io_error")
        return None
    registry.event("forensics.capture", reason=reason, capsule=path)
    return path


def _profile_window(dirpath: str, ms: float) -> tuple[dict | None,
                                                      str | None]:
    """A bounded ``torch.profiler`` trace of the process into
    ``dirpath``: ``(doc, None)``, or ``(None, why)`` when it was refused
    (the process's one profiler is taken: it never nests), or
    ``(None, None)`` when disabled (``ms<=0``)."""
    if ms <= 0:
        return None, None
    from hpnn_tpu_torch.obs import profiler

    try:
        doc = profiler.window(dirpath, ms)
    except profiler.ProfilerBusy as exc:
        return None, str(exc)
    if doc["files"] == 0:
        return None, "the profiler wrote no file"
    return doc, None


def _assemble(path: str, reason: str, detail: dict | None,
              t0: float) -> dict:
    """Build the capsule artifacts + manifest (the slow half, off the
    trigger path for alert captures).  The in-flight slot is released
    in ``finally`` — an unexpected exception here (alert captures run
    on a daemon thread nobody joins) must never leave
    ``_in_flight=True`` forever, which would suppress every future
    capture as ``in_flight``."""
    global _in_flight, _last_done
    cfg = _config() or {}
    errors: list[str] = []
    files: list[str] = []

    def _write(name: str, text: str) -> None:
        try:
            with open(os.path.join(path, name), "w") as fp:
                fp.write(text)
            files.append(name)
        except OSError as exc:
            errors.append(f"{name}: {exc}")

    try:
        # flight ring: dump to its own path, copy the file in
        flight_path = None
        dump = flight.dump(f"capsule:{reason}")
        if dump:
            try:
                flight_path = os.path.join(path, "flight.jsonl")
                shutil.copyfile(dump, flight_path)
                files.append("flight.jsonl")
            except OSError as exc:
                flight_path = None
                errors.append(f"flight.jsonl: {exc}")

        from hpnn_tpu_torch.obs import blame, drift, export, forensics, meter

        spans = forensics.recent_spans()
        _write("spans.jsonl",
               "".join(json.dumps(r, default=str) + "\n"
                       for r in spans))
        snap = registry.snapshot_state()
        _write("gauges.json", json.dumps(snap, indent=1, default=str))
        _write("health.json",
               json.dumps(export.health(), indent=1, default=str))
        sketches = drift.sketch_doc()
        if sketches is not None:
            # the distribution at the moment it moved: reference +
            # live sketch dump, scores, window bounds (obs/drift.py;
            # absent when HPNN_DRIFT is unarmed)
            _write("drift.json",
                   json.dumps(sketches, indent=1, default=str))
        attribution = meter.sketch_doc()
        if attribution is not None:
            # who was spending what when it fired: per-tenant resource
            # sketches + the governed top-K export (obs/meter.py;
            # absent when HPNN_METER is unarmed)
            _write("meter.json",
                   json.dumps(attribution, indent=1, default=str))
        phase_split = blame.sketch_doc()
        if phase_split is not None:
            # where the tail time was going when it fired: the rolling
            # fleet + per-kernel phase-blame window (obs/blame.py;
            # absent when HPNN_BLAME is unarmed)
            _write("blame.json",
                   json.dumps(phase_split, indent=1, default=str))
        from hpnn_tpu_torch.serve import conn

        census = conn.sketch_doc()
        if census is not None:
            # who was on the wire when it fired: the connection-plane
            # census — live table, close-reason + guard-kill totals
            # (serve/conn.py; absent when HPNN_CONN_* is unarmed)
            _write("conn.json",
                   json.dumps(census, indent=1, default=str))

        profile, refused = _profile_window(os.path.join(path, "profile"),
                                           cfg.get("profile_ms", 0.0))
        duration = time.monotonic() - t0
        manifest = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "capsule": path,
            "duration_s": round(duration, 6),
            "files": sorted(files),
            "spans": len(spans),
            "flight": flight_path,
            "profile": profile,
        }
        if refused:
            manifest["profile_refused"] = refused
        if detail:
            manifest["alert"] = detail
        if errors:
            manifest["errors"] = errors
        _write("manifest.json",
               json.dumps(manifest, indent=1, default=str))
        registry.event("forensics.capture_done", reason=reason,
                       capsule=path, duration_s=manifest["duration_s"],
                       files=len(files), spans=len(spans),
                       profile=profile is not None)
        with _lock:
            _captures.append({
                "reason": reason, "capsule": path,
                "ts": manifest["ts"],
                "duration_s": manifest["duration_s"],
                "spans": manifest["spans"],
                "profile": profile is not None,
            })
            del _captures[:-_MAX_KEPT]
        return manifest
    finally:
        with _lock:
            _in_flight = False
            _last_done = time.monotonic()


def capture(reason: str, detail: dict | None = None) -> dict | None:
    """Synchronous capture (the manual ``POST /v1/capture`` path):
    returns the manifest, or None when disarmed or suppressed
    (in-flight / cooldown / unwritable dir — counted)."""
    t0 = time.monotonic()
    path = _begin(reason)
    if path is None:
        return None
    return _assemble(path, reason, detail, t0)


def capture_async(reason: str, detail: dict | None = None) -> bool:
    """Trigger-path capture: admission + begin event run on the
    caller's thread (so the at-most-one-in-flight decision and the
    ``forensics.capture`` record are synchronous with the trigger);
    assembly — profiler window included — runs on a daemon thread.
    True when a capture was admitted."""
    t0 = time.monotonic()
    path = _begin(reason)
    if path is None:
        return False
    threading.Thread(
        target=_assemble, args=(path, reason, detail, t0),
        name="hpnn-capsule", daemon=True).start()
    return True


def _on_alert(rec: dict) -> None:
    """The alert engine's fire hook (alerts._fire_hook)."""
    capture_async(f"alert:{rec.get('rule', '?')}", detail=rec)


def _install() -> None:
    """Arm the alert fire hook (called from ``registry._init`` when
    the knob is set).  Safe to call repeatedly."""
    if _config():
        from hpnn_tpu_torch.obs import alerts

        alerts._fire_hook = _on_alert


def http_capture(body: dict | None) -> tuple[int, dict]:
    """The shared ``POST /v1/capture`` implementation for the serve
    and collector HTTP servers: ``(status, payload)``.  404 when the
    knob is unarmed, 429 when suppressed, 200 with the manifest on
    success."""
    if _config() is None:
        return 404, {"error":
                     "capture capsules not armed (HPNN_CAPSULE_DIR)"}
    reason = "manual"
    if isinstance(body, dict) and body.get("reason"):
        reason = f"manual:{_slug(str(body['reason']))}"
    manifest = capture(reason)
    if manifest is None:
        with _lock:
            skipped = dict(_skipped)
        return 429, {"error": "capture suppressed",
                     "skipped": skipped}
    return 200, {"capsule": manifest["capsule"],
                 "manifest": manifest}


def health_doc() -> dict:
    """The capsule census for ``/healthz``."""
    cfg = _config()
    if cfg is None:
        return {"armed": False}
    with _lock:
        out = {
            "armed": True,
            "dir": cfg["dir"],
            "in_flight": _in_flight,
            "captures": len(_captures),
            "skipped": dict(_skipped),
        }
        if _captures:
            out["last"] = dict(_captures[-1])
    return out


def configure(dirpath: str | None) -> None:
    """Programmatic twin of the env knob (the CLI ``--capsule-dir``
    flag): (re)point capsules at ``dirpath`` — or disarm with None —
    and forget the memo.  Callers re-running ``obs.configure``
    afterwards also refresh the registry activation + hook arming."""
    if dirpath:
        os.environ[ENV_KNOB] = dirpath
    else:
        os.environ.pop(ENV_KNOB, None)
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _in_flight, _last_done
    with _lock:
        _cfg = None
        _in_flight = False
        _last_done = 0.0
        _captures.clear()
        _skipped.clear()
    from hpnn_tpu_torch.obs import alerts

    alerts._fire_hook = None
