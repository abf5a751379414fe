"""Chaos drills against the port: scripted disasters against a live
train-while-serve process, with the blast radius measured, not guessed.

The twin of the repo's ``tools/chaos_drill.py`` harness over
``hpnn_tpu_torch``, with five of its drills (docs/resilience.md); every
assertion and threshold is the original's:

* **kill9** — a real ``python -m hpnn_tpu_torch.cli.online_nn`` child
  under open-loop traffic (this package's ``tools/loadgen.py`` twin) is
  SIGKILLed after at least one promotion has committed to the WAL
  (``HPNN_WAL_DIR``), then restarted on the same port and WAL dir.  The
  restarted process must resume the last *committed* weights bitwise
  (``/healthz`` ``weights_sha`` against the supervisor's own read of the
  WAL checkpoint) behind the readiness gate, with the goodput dip,
  recovery seconds and lost requests measured from the record stream.
* **torn** — a conn-guarded in-process serve ``Session`` (``HPNN_CONN_*``)
  under clean traffic, attacked by slowloris, torn-body and fuzz
  clients at once: clean goodput dips at most 10% with zero clean
  ``lost``, every hostile connection accounted by close reason, every
  slowloris guard-killed, the ``conn.guard_kills`` rule fires a capsule
  carrying ``conn.json``, the sink passes the connection-plane lint
  (:func:`lint_conn`, a copy of ``tools/check_obs_catalog.py``'s), and
  no attacker thread hangs.
* **quota** — two gold victims and one rate-capped bronze offender
  share an in-process ``TenantSession``; the offender offers 10x its
  budget.  The victims hold 75% of their goodput with no shed, every
  offender refusal is ``shed reason=quota``, and the
  ``tenant.shed_rate`` rule fires.
* **hog** — four Zipf victims and a rate-capped hog at 20x the head's
  rate under ``HPNN_METER``: the sink's merged top-K names the hog
  within a second, the blame table (:func:`blame_table`, the port's
  ``obs.meter.merge_sketch_docs``) gives it the majority of
  device-seconds, the shed-rate rule fires, and the capsule carries
  ``meter.json``.
* **drift** — an in-process ``OnlineSession`` learns the synthetic-MNIST
  stream, ``HPNN_DRIFT`` is armed, then the labels are remapped
  (``online.streams.label_shift``): the held-out decay drives
  ``drift.score`` over a threshold rule, the alert lands a capsule with
  ``drift.json``, and serving loses nothing.

The child and the in-process sessions run on ``cuda`` unless
``--device cpu`` (``device="cpu"``) is given; the child gets
``PYTHONPATH`` = the checkout.  A drill that cannot run (the child never
becomes ready, no promotion commits in time) reports ``ok: false`` with
the reason under ``error``: there is no skip.  Drills the repo's tool
has and this twin lacks: reload, sentinel, replica, alert, worker,
capsule, tune (ROADMAP.md B6).

    python -m hpnn_tpu_torch.tools.chaos_drill --drill kill9 --device cpu
    python -m hpnn_tpu_torch.tools.chaos_drill --drill all --out drills.jsonl

Prints one JSON object ``{"drills": [...], "ok": bool}``; exits 1 unless
every drill is ok.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from hpnn_tpu_torch.tools import loadgen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNEL = "drill"

CONF = (f"[name] {KERNEL}\n[type] ANN\n[init] generate\n[seed] 7\n"
        "[input] 8\n[hidden] 5\n[output] 2\n[train] BP\n")


# ------------------------------------------------------------ plumbing


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str, timeout_s: float = 2.0):
    """-> (status, parsed-json-or-None); (None, None) when nothing
    answered (refused/reset — the connection-level loss class)."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, None
    except (OSError, http.client.HTTPException):
        return None, None
    finally:
        conn.close()


def http_post(port: int, path: str, body: dict,
              timeout_s: float = 5.0):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout_s)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, None
    except (OSError, http.client.HTTPException):
        return None, None
    finally:
        conn.close()


def weights_sha(weights) -> str:
    """Bitwise identity of a weight tuple — the same digest the
    online session publishes per kernel in ``/healthz``."""
    sha = hashlib.sha256()
    for w in weights:
        sha.update(np.ascontiguousarray(np.asarray(w)).tobytes())
    return sha.hexdigest()[:16]


def _device_arg(device) -> str:
    return "cuda" if device is None else str(device)


def _mode(device):
    """The serve mode a drill's in-process session takes: parity on the
    CPU (the JAX drills' mode), the card's captured graphs on cuda."""
    return "parity" if _device_arg(device) == "cpu" else None


class Child:
    """One ``python -m hpnn_tpu_torch.cli.online_nn`` child process under
    supervision, on ``device`` (``cuda`` unless ``"cpu"``)."""

    def __init__(self, workdir: str, port: int, *, wal_dir=None,
                 chaos=None, interval_s: float = 0.2,
                 rows: int = 16, batch: int = 8, epochs: int = 2,
                 margin: float = -0.5, log_name: str = "child.log",
                 device=None):
        self.workdir = workdir
        self.port = port
        conf_path = os.path.join(workdir, "nn.conf")
        if not os.path.exists(conf_path):
            with open(conf_path, "w") as fp:
                fp.write(CONF)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env.pop("HPNN_CHAOS", None)
        env.pop("HPNN_CHAOS_SEED", None)
        env.pop("HPNN_WAL_DIR", None)
        if wal_dir:
            env["HPNN_WAL_DIR"] = str(wal_dir)
        if chaos:
            env["HPNN_CHAOS"] = chaos
        self.log_path = os.path.join(workdir, log_name)
        self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hpnn_tpu_torch.cli.online_nn",
             "--device", _device_arg(device),
             "--port", str(port),
             "--interval-s", str(interval_s),
             "--rows", str(rows), "--batch", str(batch),
             "--epochs", str(epochs), "--margin", str(margin),
             conf_path],
            cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
            stdout=self._log, stderr=self._log)

    def wait_ready(self, timeout_s: float = 90.0) -> dict:
        """Poll ``/readyz`` until 200; returns
        ``{"ready": bool, "gated": saw-a-503, "waited_s": ...}``."""
        t0 = time.monotonic()
        gated = False
        while time.monotonic() - t0 < timeout_s:
            if self.proc.poll() is not None:
                break
            code, _doc = http_get(self.port, "/readyz",
                                  timeout_s=1.0)
            if code == 200:
                return {"ready": True, "gated": gated,
                        "waited_s": round(time.monotonic() - t0, 3)}
            if code == 503:
                gated = True
            time.sleep(0.05)
        return {"ready": False, "gated": gated,
                "waited_s": round(time.monotonic() - t0, 3)}

    def health(self) -> dict | None:
        code, doc = http_get(self.port, "/healthz")
        return doc if code == 200 else None

    def log_tail(self, n: int = 6) -> list[str]:
        try:
            with open(self.log_path, errors="replace") as fp:
                return fp.read().splitlines()[-n:]
        except OSError:
            return []

    def kill9(self) -> None:
        try:
            self.proc.send_signal(signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait(timeout=10)
        self._close_log()

    def terminate(self, timeout_s: float = 10.0) -> int | None:
        """SIGTERM (the graceful-drain path) and wait; returns the
        exit code (0 proves the drain handler ran to completion)."""
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._close_log()
        return self.proc.returncode

    def _close_log(self):
        try:
            self._log.close()
        except OSError:
            pass


# -------------------------------------------------------- measurement


def goodput_bins(records: list[dict], *, bin_s: float = 0.5) -> dict:
    """Per-bin ok counts keyed by bin start offset (seconds on the
    loadgen clock)."""
    bins: dict[float, int] = {}
    for r in records:
        b = round(int(r["t"] / bin_s) * bin_s, 3)
        bins.setdefault(b, 0)
        if r["status"] == "ok":
            bins[b] += 1
    return bins


def blast_radius(records: list[dict], t_kill: float, *,
                 bin_s: float = 0.5,
                 recovered_frac: float = 0.8) -> dict:
    """Goodput dip/recovery around a disruption at ``t_kill`` (same
    clock as the records' ``t``): baseline = median ok-count of the
    pre-kill bins, recovery = first post-kill bin back at
    ``recovered_frac`` of baseline."""
    bins = goodput_bins(records, bin_s=bin_s)
    pre = [n for b, n in sorted(bins.items()) if b + bin_s <= t_kill]
    base = float(np.median(pre)) if pre else 0.0
    post = [(b, n) for b, n in sorted(bins.items()) if b >= t_kill]
    recovery_s = None
    dip = base
    for b, n in post:
        dip = min(dip, n)
        if base > 0 and n >= recovered_frac * base:
            recovery_s = round(b + bin_s - t_kill, 3)
            break
    dip_pct = (round(100.0 * (base - dip) / base, 1) if base > 0
               else None)
    lost = sum(1 for r in records if r["status"] == "lost")
    shed = sum(1 for r in records if r["status"] == "shed")
    return {
        "baseline_ok_per_bin": base,
        "bin_s": bin_s,
        "goodput_dip_pct": dip_pct,
        "recovery_s": recovery_s,
        "lost": lost,
        "shed": shed,
        "requests": len(records),
    }


class _Load:
    """Background loadgen run with live record capture + early stop."""

    def __init__(self, port: int, *, rate: float = 40.0,
                 duration_s: float = 240.0, ingest_frac: float = 0.5,
                 retries: int = 3, seed: int = 0,
                 kernels: tuple = (KERNEL,), n_in: int = 8,
                 n_out: int = 2):
        self.records: list[dict] = []
        self.stop = threading.Event()
        self.summary: dict | None = None
        self.t0 = time.perf_counter()

        def run():
            self.summary = loadgen.run_open_loop(
                f"http://127.0.0.1:{port}", rate_rps=rate,
                duration_s=duration_s, process="poisson",
                kernels=tuple(kernels), rows_choices=(1, 2),
                n_in=n_in, timeout_s=2.0, max_retries=retries,
                retry_cap_s=0.25, n_workers=8, seed=seed,
                ingest_frac=ingest_frac, n_out=n_out, stop=self.stop,
                on_record=self.records.append)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def now(self) -> float:
        """Offset on the records' ``t`` clock (same perf_counter
        epoch, modulo loadgen's own setup time — well under a bin)."""
        return time.perf_counter() - self.t0

    def finish(self, settle_s: float = 0.0) -> list[dict]:
        if settle_s > 0:
            time.sleep(settle_s)
        self.stop.set()
        self.thread.join(timeout=30)
        return list(self.records)


def _wait(pred, timeout_s: float, interval_s: float = 0.1):
    """Poll ``pred()`` until truthy; returns its value or None."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        v = pred()
        if v:
            return v
        time.sleep(interval_s)
    return None


def _events(path: str) -> list[dict]:
    events = []
    with open(path) as fp:
        for line in fp:
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


def _manifest(capsule_dir: str):
    for dirpath, _dirs, files in os.walk(capsule_dir):
        if "manifest.json" in files:
            return os.path.join(dirpath, "manifest.json")
    return None


class _Env:
    """The drill's knobs set for its run and the environment restored
    as it was after it."""

    def __init__(self, keys):
        self.prev = {key: os.environ.get(key) for key in keys}

    def restore(self):
        for key, val in self.prev.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


# ---------------------------------------------------- reports (copies)

CONN_CLOSE_REASONS = ("eof", "timeout", "reset", "torn_body", "fuzz",
                      "drain", "guard")
CONN_KILL_REASONS = ("slowloris", "stall")
CONN_GAUGES = ("conn.active", "conn.oldest_s", "conn.guard_kills")


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _pos_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def lint_conn(path: str) -> list[str]:
    """The connection-plane lint of ``tools/check_obs_catalog.py
    --conn`` over one metrics sink (a copy: the port imports no repo
    tool).  ``conn.open``/``conn.close``/``conn.guard_kill`` count
    records paired by id (no reuse, no orphan or double close, close
    and kill reasons on their enums, byte ledgers non-negative ints,
    durations finite), the conn gauges finite and non-negative, every
    open closed by EOF, and at least one ``conn.*`` record.  Returns
    failure strings (empty = pass)."""
    import math

    failures: list[str] = []
    try:
        with open(path) as fp:
            lines = [ln for ln in fp if ln.strip()]
    except OSError as exc:
        return [f"cannot read sink {path!r}: {exc}"]
    n_conn = 0
    opened: set[str] = set()
    closed: set[str] = set()
    for i, ln in enumerate(lines):
        try:
            rec = json.loads(ln)
        except ValueError:
            continue  # torn tail line
        if not isinstance(rec, dict):
            continue
        ev = rec.get("ev")
        at = f"record {i + 1}"
        if ev in ("conn.open", "conn.close", "conn.guard_kill"):
            n_conn += 1
            if rec.get("kind") != "count":
                failures.append(
                    f"{at}: {ev} kind {rec.get('kind')!r} != 'count'")
            if not _pos_int(rec.get("n")):
                failures.append(
                    f"{at}: {ev} increment {rec.get('n')!r} is not a "
                    "positive int")
            cid = rec.get("id")
            if not isinstance(cid, str) or not cid:
                failures.append(
                    f"{at}: {ev} id {cid!r} is not a non-empty string")
                continue
            if ev == "conn.open":
                if cid in opened:
                    failures.append(
                        f"{at}: conn.open id {cid!r} reused — two "
                        "connections share one ledger")
                opened.add(cid)
                for key in ("ip", "plane"):
                    v = rec.get(key)
                    if not isinstance(v, str) or not v:
                        failures.append(
                            f"{at}: conn.open {key} {v!r} is not a "
                            "non-empty string")
            elif ev == "conn.close":
                if cid not in opened:
                    failures.append(
                        f"{at}: conn.close id {cid!r} pairs no "
                        "conn.open — an unadmitted death")
                elif cid in closed:
                    failures.append(
                        f"{at}: conn.close id {cid!r} closed twice")
                closed.add(cid)
                r = rec.get("reason")
                if r not in CONN_CLOSE_REASONS:
                    failures.append(
                        f"{at}: conn.close reason {r!r} not in "
                        f"{'/'.join(CONN_CLOSE_REASONS)}")
                for key in ("bytes_in", "bytes_out", "requests"):
                    v = rec.get(key)
                    if v is None:
                        continue  # per-IP-cap refusal: admit-time close
                    if (not isinstance(v, int) or isinstance(v, bool)
                            or v < 0):
                        failures.append(
                            f"{at}: conn.close {key} {v!r} is not a "
                            "non-negative int")
                d = rec.get("duration_s")
                if d is not None and (not _num(d)
                                      or not math.isfinite(d)
                                      or d < 0):
                    failures.append(
                        f"{at}: conn.close duration_s {d!r} is not a "
                        "finite non-negative number")
            else:
                if rec.get("reason") not in CONN_KILL_REASONS:
                    failures.append(
                        f"{at}: conn.guard_kill reason "
                        f"{rec.get('reason')!r} not in "
                        f"{'/'.join(CONN_KILL_REASONS)}")
                if cid not in opened:
                    failures.append(
                        f"{at}: conn.guard_kill id {cid!r} names no "
                        "opened connection")
        elif ev in CONN_GAUGES:
            n_conn += 1
            if rec.get("kind") != "gauge":
                failures.append(
                    f"{at}: {ev} kind {rec.get('kind')!r} != 'gauge'")
            v = rec.get("value")
            if not _num(v) or not math.isfinite(v) or v < 0:
                failures.append(
                    f"{at}: {ev} value {v!r} is not a finite "
                    "non-negative number")
    leaked = opened - closed
    if leaked:
        sample = ", ".join(sorted(leaked)[:4])
        failures.append(
            f"sink {path!r}: {len(leaked)} conn.open without a "
            f"paired conn.close ({sample}…) — every admitted "
            "connection must account its death (server shutdown "
            "drains leftovers with reason=drain)")
    if not n_conn:
        failures.append(
            f"sink {path!r} has no conn.* records — was any "
            "HPNN_CONN_* knob armed during this run?")
    return failures


def blame_table(paths: list[str]) -> dict:
    """The per-tenant device-seconds blame of ``tools/tenant_report.py``
    over the port's meter: each worker's latest cumulative
    ``meter.sketch`` (by path, pid and rank), merged by
    ``obs.meter.merge_sketch_docs`` with every tenant named.  Returns
    ``{"ranked": [tenant, ...] by estimated device-seconds, "share_pct":
    {tenant: % of the fleet total}, "total": device-seconds}``."""
    from hpnn_tpu_torch.obs import meter

    latest: dict = {}
    for path in paths:
        for rec in _events(path):
            if isinstance(rec, dict) and rec.get("ev") == "meter.sketch":
                latest[(path, rec.get("pid"), rec.get("rank"))] = rec
    docs = [latest[k] for k in sorted(latest, key=str)]
    n = max([len((d.get("axes", {}).get("device_s") or {}).get("entries") or {})
             for d in docs] or [1])
    merged = meter.merge_sketch_docs(docs, k=max(1, n))
    dev = merged["axes"].get("device_s", {})
    top = {t: v for t, v in (dev.get("top") or {}).items() if t != meter.OTHER}
    total = float(dev.get("total") or 0.0)
    return {"ranked": sorted(top, key=lambda t: (-top[t], t)),
            "share_pct": {t: round(100.0 * v / total, 2) if total > 0 else 0.0
                          for t, v in top.items()},
            "total": total}


# ------------------------------------------------------------- drills


def _shield_sigpipe() -> None:
    """SIGPIPE back to ignored (Python's startup default) before any
    drill traffic: the supervisor deliberately kills children that
    hold live sockets, and a host process that ran one of the CLI
    mains in-process would otherwise carry their SIG_DFL disposition
    — turning the drill's own measurement (a torn write, recorded as
    ``lost``) into supervisor death.  Must run on the main thread;
    loadgen's worker threads inherit the process disposition."""
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    except (ValueError, AttributeError):  # non-main thread / platform
        pass


def drill_kill9(workdir: str, *, rate: float = 40.0,
                promote_timeout_s: float = 60.0,
                ready_timeout_s: float = 90.0,
                seed: int = 0, device=None) -> dict:
    """SIGKILL mid-traffic after a WAL-committed promotion, restart
    on the same port + WAL dir, prove bitwise resume + measure the
    blast radius."""
    from hpnn_tpu_torch.online import wal as wal_mod

    _shield_sigpipe()
    out: dict = {"ev": "drill.kill9", "ok": False,
                 "device": _device_arg(device)}
    wal_dir = os.path.join(workdir, "wal")
    port = free_port()
    child = Child(workdir, port, wal_dir=wal_dir,
                  log_name="kill9-a.log", device=device)
    try:
        ready = child.wait_ready(ready_timeout_s)
        out["boot_ready_s"] = ready["waited_s"]
        if not ready["ready"]:
            out["error"] = "child never became ready"
            out["log_tail"] = child.log_tail()
            return out
        load = _Load(port, rate=rate, ingest_frac=0.5, seed=seed)

        def promoted():
            doc = child.health()
            if doc is None:
                return None
            on = doc.get("online", {})
            if on.get("promoter", {}).get("promoted", 0) < 1:
                return None
            w = wal_mod.PromotionWAL(wal_dir)
            return w.last_committed(KERNEL)

        rec = _wait(promoted, promote_timeout_s, interval_s=0.2)
        if rec is None:
            load.finish()
            out["error"] = "no WAL-committed promotion in time"
            return out
        # let post-promotion goodput establish the baseline bins
        time.sleep(1.5)
        t_kill = load.now()
        child.kill9()
        # ground truth from the supervisor's own read of the WAL
        restored = wal_mod.PromotionWAL(wal_dir).restore(KERNEL)
        if restored is None:
            load.finish()
            out["error"] = "WAL unreadable after kill"
            return out
        ws, rec = restored
        expect_sha = weights_sha(ws)
        child = Child(workdir, port, wal_dir=wal_dir,
                      log_name="kill9-b.log", device=device)
        ready = child.wait_ready(ready_timeout_s)
        out["readyz_gated"] = ready["gated"]
        out["restart_ready_s"] = ready["waited_s"]
        if not ready["ready"]:
            load.finish()
            out["error"] = "restarted child never became ready"
            out["log_tail"] = child.log_tail()
            return out
        # read the resident digest at the readiness edge, BEFORE the
        # settle traffic: the restarted trainer starts promoting new
        # versions within a round or two, and those are supposed to
        # differ from the restored checkpoint
        doc = child.health() or {}
        kdoc = doc.get("online", {}).get("kernels", {}).get(KERNEL, {})
        got_sha = kdoc.get("weights_sha")
        records = load.finish(settle_s=2.0)
        out.update(blast_radius(records, t_kill))
        out["wal_version"] = int(rec.get("version", -1))
        out["weights_sha"] = {"expect": expect_sha, "got": got_sha}
        out["restored_bitwise"] = bool(got_sha == expect_sha)
        out["restored_doc"] = (doc.get("online", {}).get("wal", {})
                               .get("restored"))
        out["ok"] = bool(out["restored_bitwise"]
                         and out["recovery_s"] is not None)
        return out
    finally:
        child.terminate()


def drill_drift(workdir: str, *, rate: float = 20.0,
                seed: int = 7, device=None) -> dict:
    """The drift plane's live proof (docs/observability.md "Drift
    detection"): an in-process train-while-serve session on the
    synthetic-MNIST stream, loadgen inference traffic flowing, a
    ``drift.score`` threshold rule and a capsule dir armed.  The
    session first *learns* the clean stream (a label shift is only
    visible to a model that learned the mapping), then ``HPNN_DRIFT``
    is armed so the sketch references freeze on the converged
    steady-state and the decay sentinel warms up, then the stream's
    labels are remapped (``streams.label_shift``).  The resident's
    held-out loss ramps, the sentinel z breaches ``HPNN_DRIFT_Z``,
    the normalized score crosses the rule → ``alert.fire`` → a
    capture capsule whose ``drift.json`` holds both the reference
    and the post-shift sketches — while serving answers throughout
    (zero lost)."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.online import streams
    from hpnn_tpu_torch.online.session import OnlineSession
    from hpnn_tpu_torch.serve import make_server

    _shield_sigpipe()
    out: dict = {"ev": "drill.drift", "ok": False,
                 "device": _device_arg(device)}
    sink = os.path.join(workdir, "drift-drill.metrics.jsonl")
    capsule_dir = os.path.join(workdir, "capsules")
    env = _Env(("HPNN_DRIFT", "HPNN_DRIFT_WINDOW", "HPNN_DRIFT_Z",
                "HPNN_ALERTS", "HPNN_CAPSULE_DIR",
                "HPNN_CAPSULE_PROFILE_MS", "HPNN_CAPSULE_COOLDOWN_S",
                "HPNN_METRICS"))
    os.environ.pop("HPNN_DRIFT", None)  # armed mid-drill, below
    os.environ["HPNN_ALERTS"] = ("drift@drift.score>1:"
                                 "for=0,cooldown=0,severity=warn")
    os.environ["HPNN_CAPSULE_DIR"] = capsule_dir
    os.environ["HPNN_CAPSULE_PROFILE_MS"] = "0"
    os.environ["HPNN_CAPSULE_COOLDOWN_S"] = "0"
    # Phase lengths, in trainer rounds of FEEDS stream samples each:
    # CONVERGE clean rounds to learn the mapping, WARMUP armed clean
    # rounds (sketch references freeze, sentinel EWMA seeds), then
    # shifted rounds until the alert fires.  The sentinel z asymptote
    # against a ramp is ~2 (obs/drift.py), so the drill arms
    # HPNN_DRIFT_Z below that.
    converge, warmup, max_shifted, feeds = 25, 12, 15, 80
    stream = streams.label_shift(
        streams.mnist_stream(7), (converge + warmup) * feeds,
        {i: (i + 1) % 10 for i in range(10)})
    session = server = None

    def _round():
        for _ in range(feeds):
            x, t = next(stream)
            session.feed(x, t)
        session.tick()

    try:
        obs.configure(sink)  # alert rule + capsule trigger armed
        session = OnlineSession(rows=64, batch=8, epochs=16,
                                holdout=4, seed=0, start=False,
                                serve_kwargs={"device": device})
        kern, _ = kernel_mod.generate(1, streams.MNIST_N_IN, [32],
                                      streams.MNIST_N_OUT)
        session.add_kernel("mnist", kern)
        server = make_server(session.serve)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed,
                     kernels=("mnist",), n_in=streams.MNIST_N_IN,
                     n_out=streams.MNIST_N_OUT)
        for _ in range(converge):     # learn the clean mapping
            _round()
        obs.drift.configure("1", window=64, z=1.2)
        for _ in range(warmup):       # freeze references, seed EWMA
            _round()
        # poll fired_total, not "active": drift.score is a
        # multi-series gauge (one emission per detector), so the
        # name-keyed threshold rule resolves the instant a calm
        # detector's low score lands after the breaching one
        if obs.alerts.health_doc().get("fired_total", 0) > 0:
            load.finish()
            out["error"] = "alert fired before the shift"
            return out
        t_shift = load.now()
        rounds = None
        for i in range(max_shifted):  # labels now lie
            _round()
            if obs.alerts.health_doc().get("fired_total", 0) > 0:
                rounds = i + 1
                break
        t_fire = load.now()
        manifest_path = (_wait(lambda: _manifest(capsule_dir), 10.0,
                               interval_s=0.05)
                         if rounds is not None else None)
        records = load.finish(settle_s=0.2)
        health = obs.drift.health_doc()
        obs.configure(None)   # close the sink for the audit below
        events = _events(sink)
        fires = [r for r in events if r.get("ev") == "alert.fire"
                 and r.get("rule") == "drift"]
        drifts = [r for r in events if r.get("ev") == "online.drift"]
        man, sketches = {}, None
        if manifest_path:
            with open(manifest_path) as fp:
                man = json.load(fp)
            dj = os.path.join(os.path.dirname(manifest_path),
                              "drift.json")
            if os.path.exists(dj):
                with open(dj) as fp:
                    sketches = json.load(fp)
        ingest = (sketches or {}).get("ingest") or {}
        out["detect_s"] = (round(t_fire - t_shift, 3)
                           if rounds is not None else None)
        out["rounds_to_detect"] = rounds
        out["requests"] = len(records)
        out["lost"] = sum(1 for r in records if r["status"] == "lost")
        out["capsule"] = man.get("capsule")
        out["capsule_reason"] = man.get("reason")
        out["drift_events"] = sorted(
            {f"{r.get('detector')}:{r.get('kernel')}" for r in drifts})
        out["eval_z"] = (health.get("eval", {}).get("mnist", {})
                         .get("z"))
        out["sketches"] = {"reference": bool(ingest.get("reference")),
                           "live": bool(ingest.get("live"))}
        out["ok"] = bool(rounds is not None and fires and drifts
                         and manifest_path
                         and str(man.get("reason", "")
                                 ).startswith("alert:drift")
                         and ingest.get("reference")
                         and ingest.get("live")
                         and out["requests"] > 0
                         and out["lost"] == 0)
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if session is not None:
            session.close()
        obs.configure(None)
        env.restore()


def _paced(session, tenant: str, x, rate_rps: float, duration_s: float,
           res: dict, *, latency: bool = False):
    """``rate_rps`` requests a second from ``tenant`` for ``duration_s``,
    each outcome tallied in ``res``."""
    from hpnn_tpu_torch.serve.batcher import QueueFull

    period = 1.0 / max(rate_rps, 1e-6)
    t0 = time.perf_counter()
    i = 0
    while i * period < duration_s:
        due = t0 + i * period
        i += 1
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_req = time.perf_counter()
        try:
            session.infer_for(tenant, KERNEL, x, timeout_s=2.0)
        except QueueFull as exc:  # Shed subclass: quota or queue
            res["shed"] += 1
            if latency:
                reason = getattr(exc, "reason", None) or "?"
                res["reasons"][reason] = res["reasons"].get(reason, 0) + 1
        except Exception as exc:
            res["errors"] += 1
            res["error_sample"] = repr(exc)
        else:
            res["ok"] += 1
            if latency:
                res["lat"].append(time.perf_counter() - t_req)


def drill_quota(workdir: str, *, rate: float = 100.0, seed: int = 9,
                phase_s: float = 1.5,
                offender_rate_rps: float = 40.0,
                overdrive: float = 10.0, device=None) -> dict:
    """Hostile-tenant drill (docs/tenancy.md): two well-behaved
    "gold" victims and one rate-capped "bronze" offender share one
    in-process TenantSession; after an undisturbed baseline the
    offender offers ``overdrive``x its admission budget.  Proves
    per-tenant isolation end to end: the victims' goodput and p99
    hold against their own baseline, every refusal the offender sees
    is a clean ``shed reason=quota`` carrying its tenant in the sink,
    and the ``tenant.shed_rate`` threshold rule fires."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.tenant import TenantSession, TenantSpec

    _shield_sigpipe()
    out: dict = {"ev": "drill.quota", "ok": False,
                 "device": _device_arg(device),
                 "offender_rate_rps": float(offender_rate_rps),
                 "overdrive": float(overdrive)}
    sink = os.path.join(workdir, "quota-drill.metrics.jsonl")
    env = _Env(("HPNN_ALERTS", "HPNN_METRICS"))
    os.environ["HPNN_ALERTS"] = ("quota_breach@tenant.shed_rate>0.5:"
                                 "for=0,cooldown=0,severity=warn")
    victims = ("v-gold-a", "v-gold-b")
    offender = "hog"
    specs = {v: TenantSpec(v, "gold") for v in victims}
    specs[offender] = TenantSpec(offender, "bronze",
                                 rate_rps=float(offender_rate_rps))
    session = None
    try:
        obs.configure(sink)   # re-reads every knob, arms the rule
        session = TenantSession(mode=_mode(device), fleet=True,
                                max_wait_ms=0.5, tenants=specs,
                                device=device)
        k, _ = kernel_mod.generate(seed + 1, 8, [5], 2)
        for tn in (*victims, offender):
            # same topology on purpose: the fleet batcher stacks the
            # tenants' dispatches, so isolation is enforced at
            # admission, not by accidental executable separation
            session.register_for(tn, KERNEL, k)
        x = np.random.RandomState(seed).standard_normal((2, 8))
        session.infer_for(victims[0], KERNEL, x)  # discarded warmup

        def fresh():
            return {"ok": 0, "shed": 0, "errors": 0,
                    "reasons": {}, "lat": []}

        def victim_wave(duration_s: float) -> dict:
            res = {v: fresh() for v in victims}
            threads = [threading.Thread(
                target=_paced, args=(session, v, x, rate / len(victims),
                                     duration_s, res[v]),
                kwargs={"latency": True}, daemon=True) for v in victims]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return res

        base = victim_wave(phase_s)
        hog_res = fresh()
        hog_thread = threading.Thread(
            target=_paced,
            args=(session, offender, x, offender_rate_rps * overdrive,
                  phase_s, hog_res),
            kwargs={"latency": True}, daemon=True)
        hog_thread.start()
        attack = victim_wave(phase_s)
        hog_thread.join()

        def agg(res: dict) -> tuple[int, list[float]]:
            return (sum(r["ok"] for r in res.values()),
                    [s for r in res.values() for s in r["lat"]])

        base_ok, base_lat = agg(base)
        atk_ok, atk_lat = agg(attack)
        census = obs.alerts.health_doc()
        obs.configure(None)   # close the sink for a complete audit
        events = _events(sink)
        fires = [r for r in events if r.get("ev") == "alert.fire"
                 and r.get("rule") == "quota_breach"]
        quota_sheds = [r for r in events
                       if r.get("ev") == "serve.shed"
                       and r.get("reason") == "quota"]
        victim_quota_sheds = [r for r in quota_sheds
                              if r.get("tenant") != offender]

        def p99(lat):
            return (round(float(np.percentile(np.asarray(lat) * 1e3, 99)), 3)
                    if lat else None)

        out["baseline_goodput_rps"] = round(base_ok / phase_s, 1)
        out["victim_goodput_rps"] = round(atk_ok / phase_s, 1)
        out["victim_goodput_ratio"] = (
            round(atk_ok / base_ok, 4) if base_ok else None)
        out["baseline_p99_ms"] = p99(base_lat)
        out["victim_p99_ms"] = p99(atk_lat)
        out["victim_shed"] = sum(r["shed"] for r in attack.values())
        out["victim_errors"] = sum(r["errors"] for r in attack.values())
        out["offender_offered"] = (hog_res["ok"] + hog_res["shed"]
                                   + hog_res["errors"])
        out["offender_ok"] = hog_res["ok"]
        out["offender_shed"] = hog_res["shed"]
        out["offender_shed_reasons"] = dict(
            sorted(hog_res["reasons"].items()))
        out["victim_quota_sheds_in_sink"] = len(victim_quota_sheds)
        out["alert_fired"] = bool(fires)
        out["fired_total"] = census.get("fired_total", 0)
        out["ok"] = bool(
            base_ok and atk_ok
            and out["victim_goodput_ratio"] is not None
            and out["victim_goodput_ratio"] >= 0.75
            and out["victim_shed"] == 0
            and hog_res["shed"] > 0
            and set(hog_res["reasons"]) == {"quota"}
            and not victim_quota_sheds
            and fires)
        return out
    finally:
        if session is not None:
            session.close()
        obs.configure(None)
        env.restore()


def drill_hog(workdir: str, *, rate: float = 12.0, seed: int = 11,
              phase_s: float = 1.5, warm_s: float = 0.6,
              zipf_x: float = 20.0,
              hog_cap_rps: float | None = None, device=None) -> dict:
    """Resource-hog attribution drill (docs/observability.md "Tenant
    metering"): a small zipf-weighted tenant population shares one
    in-process TenantSession with ``HPNN_METER`` armed; after an
    undisturbed warm phase one rate-capped tenant ("hog") offers
    ``zipf_x`` times the heaviest victim's rate.  Proves the metering
    plane end to end: the fleet-merged top-K (the sink's own
    cumulative ``meter.sketch`` stream) names the hog within a bounded
    detection window, :func:`blame_table` over the same sink blames it
    for the majority of device-seconds, the ``tenant.shed_rate``
    threshold rule fires on the hog's refusals, and the
    alert-triggered capsule carries ``meter.json``."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.tenant import TenantSession, TenantSpec

    _shield_sigpipe()
    if hog_cap_rps is None:
        # admit the hog at ~2.5x the victims' combined offered load:
        # enough to dominate the device-seconds blame table, while
        # the 20x offered overdrive keeps its shed rate over the
        # alert rule's 0.5 threshold at any --rate
        hog_cap_rps = 2.5 * rate
    out: dict = {"ev": "drill.hog", "ok": False,
                 "device": _device_arg(device),
                 "zipf_x": float(zipf_x),
                 "hog_cap_rps": float(hog_cap_rps)}
    sink = os.path.join(workdir, "hog-drill.metrics.jsonl")
    capsule_dir = os.path.join(workdir, "capsules")
    env = _Env(("HPNN_ALERTS", "HPNN_METRICS", "HPNN_METER",
                "HPNN_METER_TOPK", "HPNN_CAPSULE_DIR",
                "HPNN_CAPSULE_PROFILE_MS", "HPNN_CAPSULE_COOLDOWN_S"))
    os.environ["HPNN_ALERTS"] = ("hog_shed@tenant.shed_rate>0.5:"
                                 "for=0,cooldown=0,severity=warn")
    os.environ["HPNN_METER"] = "1"
    os.environ.pop("HPNN_METER_TOPK", None)
    os.environ["HPNN_CAPSULE_DIR"] = capsule_dir
    os.environ["HPNN_CAPSULE_PROFILE_MS"] = "0"
    os.environ["HPNN_CAPSULE_COOLDOWN_S"] = "0"
    victims = tuple(f"v-{i:02d}" for i in range(4))
    hog = "hog"
    weights = [1.0 / (i + 1) for i in range(len(victims))]
    scale = rate / sum(weights)
    victim_rates = [w * scale for w in weights]
    hog_rate = zipf_x * victim_rates[0]
    specs = {v: TenantSpec(v, "gold") for v in victims}
    specs[hog] = TenantSpec(hog, "bronze",
                            rate_rps=float(hog_cap_rps))
    session = None

    def _sink_top_device():
        """(latest ``meter.sketch`` record, its device_s leader) from
        the live sink — the same cumulative stream a collector
        merges for ``/meterz``."""
        latest = None
        try:
            with open(sink) as fp:
                for line in fp:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line mid-run
                    if rec.get("ev") == "meter.sketch":
                        latest = rec
        except OSError:
            return None, None
        if latest is None:
            return None, None
        merged = obs.meter.merge_sketch_docs([latest])
        top = (merged.get("axes", {}).get("device_s", {})
               .get("top") or {})
        named = {t: v for t, v in top.items() if t != "_other"}
        if not named:
            return latest, None
        return latest, max(named, key=lambda t: (named[t], t))

    def fresh():
        return {"ok": 0, "shed": 0, "errors": 0}

    try:
        obs.configure(sink)   # arms sink + rule + capsule + meter
        session = TenantSession(mode=_mode(device), fleet=True,
                                max_wait_ms=0.5, tenants=specs,
                                device=device)
        k, _ = kernel_mod.generate(seed + 1, 8, [5], 2)
        for tn in (*victims, hog):
            session.register_for(tn, KERNEL, k)
        x = np.random.RandomState(seed).standard_normal((2, 8))
        for tn in (*victims, hog):
            session.infer_for(tn, KERNEL, x)  # compile warmup
        # zero the sketches: the one-time executable builds above cost
        # orders of magnitude more than a steady-state dispatch and
        # would drown the traffic signal the drill attributes
        obs.meter.configure("1")

        res = {tn: fresh() for tn in (*victims, hog)}
        threads = [threading.Thread(
            target=_paced, args=(session, v, x, r, warm_s + phase_s, res[v]),
            daemon=True) for v, r in zip(victims, victim_rates)]
        for t in threads:
            t.start()
        time.sleep(warm_s)
        t_attack = time.time()   # registry record ts is time.time()
        hog_thread = threading.Thread(
            target=_paced, args=(session, hog, x, hog_rate, phase_s, res[hog]),
            daemon=True)
        hog_thread.start()
        detect_ts = None
        deadline = time.monotonic() + phase_s
        while time.monotonic() < deadline:
            rec, top = _sink_top_device()
            if top == hog:
                detect_ts = rec.get("ts")
                break
            time.sleep(0.02)
        for t in threads:
            t.join()
        hog_thread.join()
        obs.meter.emit_sketch()  # final cumulative sketch, unthrottled
        manifest_path = _wait(lambda: _manifest(capsule_dir), 10.0,
                              interval_s=0.05)
        census = obs.alerts.health_doc()
        obs.configure(None)   # close the sink for a complete audit
        events = _events(sink)
        fires = [r for r in events if r.get("ev") == "alert.fire"
                 and r.get("rule") == "hog_shed"]
        rep = blame_table([sink])
        blame_pct = float(rep["share_pct"].get(hog) or 0.0)
        admitted = {tn: r["ok"] for tn, r in res.items()}
        total_ok = sum(admitted.values())
        truth_pct = (round(100.0 * admitted[hog] / total_ok, 2)
                     if total_ok else 0.0)
        man, meter_json = {}, None
        if manifest_path:
            with open(manifest_path) as fp:
                man = json.load(fp)
            mj = os.path.join(os.path.dirname(manifest_path),
                              "meter.json")
            if os.path.exists(mj):
                with open(mj) as fp:
                    meter_json = json.load(fp)
        out["detect_s"] = (round(detect_ts - t_attack, 3)
                           if detect_ts is not None else None)
        out["ranked_top"] = rep["ranked"][0] if rep["ranked"] else None
        out["blame_pct"] = round(blame_pct, 2)
        out["truth_pct"] = truth_pct
        out["hog_ok"] = admitted[hog]
        out["hog_shed"] = res[hog]["shed"]
        out["victims_ok"] = total_ok - admitted[hog]
        out["errors"] = sum(r["errors"] for r in res.values())
        out["alert_fired"] = bool(fires)
        out["fired_total"] = census.get("fired_total", 0)
        out["capsule"] = man.get("capsule")
        out["capsule_reason"] = man.get("reason")
        out["capsule_meter_axes"] = sorted(
            (meter_json or {}).get("axes", {}))
        out["ok"] = bool(
            out["detect_s"] is not None and out["detect_s"] <= 1.0
            and out["ranked_top"] == hog
            and blame_pct >= 50.0
            and res[hog]["shed"] > 0
            and fires
            and manifest_path
            and meter_json is not None
            and meter_json.get("axes")
            and meter_json.get("export"))
        return out
    finally:
        if session is not None:
            session.close()
        obs.configure(None)
        env.restore()


def drill_torn(workdir: str, *, rate: float = 30.0, seed: int = 8,
               n_hostile: int = 3, device=None) -> dict:
    """The connection plane's live proof (docs/serving.md "Connection
    plane"): a conn-guarded in-process serve Session under clean
    loadgen traffic, then ``n_hostile`` attackers of EACH hostile
    class at once — slowloris header-tricklers (the byte-rate guard's
    prey), torn-body clients (Content-Length declared, peer hangs up
    mid-body), and fuzz clients (garbage request lines).  Asserts the
    blast radius stayed on the attackers: clean goodput dip ≤ 10%
    with zero clean ``lost``, every hostile connection accounted by
    close reason in the drill's own sink, every slowloris
    guard-killed (``conn.guard_kill reason=slowloris``) with the
    armed ``conn.guard_kills`` rule firing → a capture capsule whose
    ``conn.json`` carries the census, ``/connz`` live throughout,
    the sink passing :func:`lint_conn`, and no attacker thread hung."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import Session, conn as conn_mod, make_server

    _shield_sigpipe()
    out: dict = {"ev": "drill.torn", "ok": False,
                 "device": _device_arg(device),
                 "n_hostile": 3 * int(n_hostile)}
    sink = os.path.join(workdir, "torn-drill.metrics.jsonl")
    capsule_dir = os.path.join(workdir, "capsules")
    env = _Env(("HPNN_CONN_HDR_MS", "HPNN_CONN_BODY_MS",
                "HPNN_CONN_PER_IP", "HPNN_CONN_MIN_BPS",
                "HPNN_CONN_TABLE", "HPNN_ALERTS", "HPNN_CAPSULE_DIR",
                "HPNN_CAPSULE_COOLDOWN_S", "HPNN_METRICS"))
    # generous deadlines + per-IP room: every guard must be armed,
    # but CLEAN traffic (8 keep-alive loadgen workers, same IP as
    # the attackers) must never trip one — the drill measures guard
    # selectivity, not just guard existence
    os.environ["HPNN_CONN_HDR_MS"] = "4000"
    os.environ["HPNN_CONN_BODY_MS"] = "4000"
    os.environ["HPNN_CONN_PER_IP"] = "64"
    os.environ["HPNN_CONN_MIN_BPS"] = "256"
    os.environ["HPNN_CONN_TABLE"] = "256"
    os.environ["HPNN_CAPSULE_DIR"] = capsule_dir
    os.environ["HPNN_CAPSULE_COOLDOWN_S"] = "0"
    os.environ["HPNN_ALERTS"] = ("conn_guard@conn.guard_kills>0:"
                                 "for=0,cooldown=0,severity=warn")
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    session = server = None
    try:
        # warm compile BEFORE arming obs, the drill_capsule discipline
        session = Session(max_batch=16, n_buckets=2, max_wait_ms=0.5,
                          device=device)
        session.register_kernel(KERNEL, k)
        warm = np.linspace(-1.0, 1.0, 8)
        for _ in range(3):
            session.infer(KERNEL, warm, timeout_s=10.0)
        if session.engine.device.type == "cuda":
            # the process's first torch.profiler session starts CUPTI,
            # 20-35 s on an H100: paid here, not inside the capsule's
            # profile window after the alert fires
            from hpnn_tpu_torch.obs import profiler
            profiler.window(os.path.join(workdir, "profiler-warmup"), 10.0)
        obs.configure(sink)           # re-arms alerts + capsule hook
        conn_mod._reset_for_tests()   # re-reads the HPNN_CONN_* knobs
        server = make_server(session)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        url = f"http://127.0.0.1:{port}"
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        time.sleep(2.5)               # clean baseline bins
        t_attack = load.now()
        hostile: dict[str, dict] = {}
        h_lock = threading.Lock()

        def attack(mode: str):
            s = loadgen.run_hostile(
                url, mode=mode, n_conns=n_hostile, duration_s=6.0,
                interval_s=0.3, seed=seed)
            with h_lock:
                hostile[mode] = s

        attackers = [threading.Thread(target=attack, args=(m,),
                                      daemon=True)
                     for m in loadgen.HOSTILE_MODES]
        for t in attackers:
            t.start()
        fired = _wait(
            lambda: (obs.alerts.health_doc().get("fired_total")
                     or None), 15.0, interval_s=0.05)
        t_fire = load.now()
        manifest_path = _wait(lambda: _manifest(capsule_dir), 10.0,
                              interval_s=0.05)
        for t in attackers:
            t.join(timeout=15.0)
        code, connz = http_get(port, "/connz", timeout_s=2.0)
        records = load.finish(settle_s=1.0)
        server.shutdown()             # table.close drains leftovers,
        server.server_close()         # pairing every open in the sink
        server = None
        obs.configure(None)           # close the sink for the audit
        out.update(blast_radius(records, t_attack))
        out["clean_lost"] = out.pop("lost")
        out["hostile"] = hostile
        out["hung"] = sum(s.get("hung", 0) for s in hostile.values())
        out["fired"] = bool(fired)
        out["fire_s"] = round(t_fire - t_attack, 3) if fired else None
        out["connz_active"] = (connz or {}).get("active")
        man = {}
        if manifest_path:
            with open(manifest_path) as fp:
                man = json.load(fp)
            out["capsule"] = man.get("capsule")
            conn_json = os.path.join(os.path.dirname(manifest_path),
                                     "conn.json")
            out["capsule_conn"] = os.path.exists(conn_json)
        else:
            out["capsule_conn"] = False
        closes: dict[str, int] = {}
        kills: dict[str, int] = {}
        for rec in _events(sink):
            if rec.get("ev") == "conn.close":
                r = rec.get("reason", "?")
                closes[r] = closes.get(r, 0) + 1
            elif rec.get("ev") == "conn.guard_kill":
                r = rec.get("reason", "?")
                kills[r] = kills.get(r, 0) + 1
        out["close_reasons"] = dict(sorted(closes.items()))
        out["guard_kills"] = dict(sorted(kills.items()))
        # every hostile connection must land in a hostile close class
        # (clean keep-alive conns close eof/drain); reset absorbs the
        # races where the peer's FIN beats the short body read
        hostile_accounted = sum(
            closes.get(r, 0) for r in
            ("guard", "torn_body", "fuzz", "timeout", "reset"))
        out["hostile_accounted"] = hostile_accounted
        lint = lint_conn(sink)
        out["lint_failures"] = lint
        slow = hostile.get("slowloris", {}).get("outcomes", {})
        out["ok"] = bool(
            out["goodput_dip_pct"] is not None
            and out["goodput_dip_pct"] <= 10.0
            and out["clean_lost"] == 0
            and out["hung"] == 0
            and hostile_accounted >= 3 * int(n_hostile)
            and slow.get("killed", 0) == int(n_hostile)
            and kills.get("slowloris", 0) >= int(n_hostile)
            and out["fired"]
            and out["capsule_conn"]
            and isinstance(out["connz_active"], int)
            and not lint)
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if session is not None:
            session.close()
        obs.configure(None)
        env.restore()
        conn_mod._reset_for_tests()


DRILLS = {
    "kill9": drill_kill9,
    "drift": drill_drift,
    "quota": drill_quota,
    "hog": drill_hog,
    "torn": drill_torn,
}


def run_drills(names, *, workdir: str | None = None,
               rate: float = 40.0, device=None) -> list[dict]:
    """Each drill in ``names`` at ``rate`` (the repo tool's ``--rate``)
    in a work dir of its own (under ``workdir`` when given, else a
    temporary one); a drill that raises reports ``ok: false`` with the
    exception."""
    rows = []
    for name in names:
        kw = {"device": device, "rate": rate}
        with tempfile.TemporaryDirectory() as tmp:
            wd = os.path.join(workdir, name) if workdir else tmp
            os.makedirs(wd, exist_ok=True)
            t0 = time.perf_counter()
            try:
                row = DRILLS[name](wd, **kw)
            except Exception as exc:  # the drill could not run: a failure
                row = {"ev": f"drill.{name}", "ok": False,
                       "device": _device_arg(device),
                       "error": f"{type(exc).__name__}: {exc}"}
            row["seconds"] = round(time.perf_counter() - t0, 3)
            rows.append(row)
    return rows


# --------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="chaos drills against the port (kill9 / drift / "
                    "quota / hog / torn)")
    ap.add_argument("--drill", default="all",
                    choices=("all", *DRILLS))
    ap.add_argument("--rate", type=float, default=40.0,
                    help="loadgen offered load during the drill")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the child and the sessions run")
    ap.add_argument("--workdir",
                    help="keep each drill's conf/logs/WAL/sink under "
                         "WORKDIR/<drill> (default: a temp dir a drill)")
    ap.add_argument("--out", help="append drill JSONL rows here")
    args = ap.parse_args(argv)
    names = (list(DRILLS) if args.drill == "all" else [args.drill])
    rows = run_drills(names, workdir=args.workdir, rate=args.rate,
                      device=args.device)
    if args.out:
        with open(args.out, "a") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    for row in rows:
        sys.stderr.write(f"{row['ev']}: "
                         f"{'ok' if row.get('ok') else row}\n")
    print(json.dumps({"drills": rows,
                      "ok": all(r.get("ok") for r in rows)}))
    return 0 if all(r.get("ok") for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
