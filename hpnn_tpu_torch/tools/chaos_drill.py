"""Chaos drills against the port: scripted disasters against a live
train-while-serve process, with the blast radius measured, not guessed.

The twin of the repo's ``tools/chaos_drill.py`` over ``hpnn_tpu_torch``,
with all twelve of its drills (docs/resilience.md, docs/selftuning.md)
in the original's order; every assertion, rate, seed, window and
threshold is the original's:

* **kill9** — a real ``python -m hpnn_tpu_torch.cli.online_nn`` child
  under open-loop traffic (this package's ``tools/loadgen.py`` twin) is
  SIGKILLed after at least one promotion has committed to the WAL
  (``HPNN_WAL_DIR``), then restarted on the same port and WAL dir.  The
  restarted process must resume the last *committed* weights bitwise
  (``/healthz`` ``weights_sha`` against the supervisor's own read of the
  WAL checkpoint) behind the readiness gate, with the goodput dip,
  recovery seconds and lost requests measured from the record stream.
* **reload** — a child with ``raise@registry.reload:times=1`` armed and
  its trainer parked, its kernel seeded from the WAL: the checkpoint is
  rewritten under load and ``POST /v1/reload`` sent twice.  The first
  answers 500 (resident version kept), the second 200 with the new
  weights' ``weights_sha`` bitwise, and nothing is lost.
* **sentinel** — ``nan@train.round`` in the child corrupts every trained
  candidate: the gate rejects at least two, promotes none, and the
  version and ``weights_sha`` stay as they were with nothing lost.
* **replica** — an in-process 3-replica ``Router`` behind the real HTTP
  front end, then ``kill_replica(0)`` under load: goodput recovers,
  nothing arriving after the kill settles is lost, and the survivors
  answer bitwise as the fleet did before.
* **alert** — a ``router.ready_replicas`` threshold rule with a flight
  ring over a 2-replica ``Router``: the kill fires it (the flight dump
  attached) and ``spawn_replica()`` resolves it, each within 5 s.
* **worker** — a ``WorkerSupervisor`` over two ``online_nn`` worker
  processes sharing one WAL, a ``ClusterRouter`` as the HTTP edge, one
  worker SIGKILLed under load: nothing lost on the survivors, bitwise
  survivor answers, and the corpse replaced ready within 30 s.
* **capsule** — a ``Session`` with ``HPNN_SAMPLE`` 0.5, a 40 ms
  ``delay@serve.dispatch`` seam, an ``slo.p99_ms`` rule and a capsule
  dir: a manifest with spans and a profile lands within 10 s of the
  fire, and the tail report (:mod:`hpnn_tpu_torch.tools.tail_report`)
  over the sink blames ``dispatch`` for more than half of the tail.
* **tune** — in process on a scripted clock: a live compiled
  ``Session``, an ``Autoscaler`` over an in-memory fleet and a
  ``QuotaEnforcer`` under a ``Tuner`` fed synthetic blame windows.  Each
  blame class applies its matching rule, both bad moves roll back
  bitwise, and the sink passes :func:`lint_tune` (a copy of the repo's
  ``--tune`` lint).
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

The children, workers and in-process sessions run on ``cuda`` unless
``--device cpu`` (``device="cpu"``) is given; a child gets
``PYTHONPATH`` = the checkout.  A drill that cannot run (the child never
becomes ready, no promotion commits in time) reports ``ok: false`` with
the reason under ``error``: there is no skip.  The repo tool's
``run_bench_*`` fold-ins for ``bench.py`` are not here.

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


# closed enums the self-tuning plane (tune/engine.py) may emit
TUNE_ACTIONS = ("scale_up", "precision_down", "grow_buckets",
                "quota_squeeze")
TUNE_VERDICTS = ("apply", "veto", "dry_run", "no_actuator",
                 "watch_active", "cooldown", "burn_ok", "no_dominant",
                 "thin_window", "no_sensor")
TUNE_PHASES = ("queue", "dispatch", "spill", "shed_retry")
BLAME_PCT_GAUGES = ("blame.queue_pct", "blame.dispatch_pct",
                    "blame.spill_pct", "blame.shed_pct",
                    "blame.other_pct", "blame.gap_pct")


def lint_tune(path: str) -> list[str]:
    """The self-tuning audit-trail lint of ``tools/check_obs_catalog.py
    --tune`` over one metrics sink (a copy: the port imports no repo
    tool).  ``tune.apply`` has a non-empty ``id``, its ``action`` and
    ``phase`` on their enums, ``pct`` a finite share in [0, 100],
    ``prior`` and ``applied`` present, ``cooldown_s``/``watch_s`` finite
    and non-negative; ``tune.rollback`` pairs an earlier apply's ``id``
    with its action on the enum, a non-empty ``reason`` and ``restored``
    present; ``tune.decision`` has its verdict on the enum, ``roots`` a
    non-negative int and ``burn`` None or finite; ``tune.error`` names
    its error; the ``blame.*_pct`` gauges are finite shares and
    ``blame.window_roots`` finite and non-negative; and at least one
    ``tune.*`` record.  Returns failure strings (empty = pass)."""
    import math

    failures: list[str] = []
    try:
        with open(path) as fp:
            lines = [ln for ln in fp if ln.strip()]
    except OSError as exc:
        return [f"cannot read sink {path!r}: {exc}"]
    n_tune = 0
    apply_ids: set[str] = set()
    for i, ln in enumerate(lines):
        try:
            rec = json.loads(ln)
        except ValueError:
            continue  # torn tail line
        if not isinstance(rec, dict):
            continue
        ev = rec.get("ev")
        at = f"record {i + 1}"
        if ev == "tune.apply":
            n_tune += 1
            aid = rec.get("id")
            if not isinstance(aid, str) or not aid:
                failures.append(
                    f"{at}: tune.apply id {aid!r} is not a non-empty "
                    "string — an unnamed apply cannot be paired with "
                    "its rollback")
            else:
                apply_ids.add(aid)
            if rec.get("action") not in TUNE_ACTIONS:
                failures.append(
                    f"{at}: tune.apply action {rec.get('action')!r} "
                    f"not in {'/'.join(TUNE_ACTIONS)}")
            if rec.get("phase") not in TUNE_PHASES:
                failures.append(
                    f"{at}: tune.apply phase {rec.get('phase')!r} is "
                    "not an actionable blame class "
                    f"({'/'.join(TUNE_PHASES)})")
            pct = rec.get("pct")
            if (not _num(pct) or not math.isfinite(pct)
                    or not 0.0 <= pct <= 100.0):
                failures.append(
                    f"{at}: tune.apply pct {pct!r} is not a finite "
                    "share in [0, 100]")
            for key in ("prior", "applied"):
                if key not in rec:
                    failures.append(
                        f"{at}: tune.apply has no {key} field — "
                        "without the prior snapshot the move is not "
                        "reversible, without applied it is not "
                        "auditable")
            for key in ("cooldown_s", "watch_s"):
                v = rec.get(key)
                if not _num(v) or not math.isfinite(v) or v < 0:
                    failures.append(
                        f"{at}: tune.apply {key} {v!r} is not a "
                        "finite non-negative number")
        elif ev == "tune.rollback":
            n_tune += 1
            rid = rec.get("id")
            if not isinstance(rid, str) or not rid:
                failures.append(
                    f"{at}: tune.rollback id {rid!r} is not a "
                    "non-empty string")
            elif rid not in apply_ids:
                failures.append(
                    f"{at}: tune.rollback id {rid!r} pairs no "
                    "preceding tune.apply — an orphan rollback "
                    "restored nothing anyone applied")
            if rec.get("action") not in TUNE_ACTIONS:
                failures.append(
                    f"{at}: tune.rollback action "
                    f"{rec.get('action')!r} not in "
                    f"{'/'.join(TUNE_ACTIONS)}")
            reason = rec.get("reason")
            if not isinstance(reason, str) or not reason:
                failures.append(
                    f"{at}: tune.rollback reason {reason!r} is not a "
                    "non-empty string — an unexplained undo is not "
                    "an audit trail")
            if "restored" not in rec:
                failures.append(
                    f"{at}: tune.rollback has no restored field — "
                    "cannot verify the prior config came back")
        elif ev == "tune.decision":
            n_tune += 1
            if rec.get("verdict") not in TUNE_VERDICTS:
                failures.append(
                    f"{at}: tune.decision verdict "
                    f"{rec.get('verdict')!r} not in the closed enum "
                    f"({'/'.join(TUNE_VERDICTS)})")
            roots = rec.get("roots")
            if (not isinstance(roots, int) or isinstance(roots, bool)
                    or roots < 0):
                failures.append(
                    f"{at}: tune.decision roots {roots!r} is not a "
                    "non-negative int")
            burn = rec.get("burn")
            if burn is not None and (not _num(burn)
                                     or not math.isfinite(burn)):
                failures.append(
                    f"{at}: tune.decision burn {burn!r} is neither "
                    "None nor a finite number")
        elif ev == "tune.error":
            n_tune += 1
            err = rec.get("error")
            if not isinstance(err, str) or not err:
                failures.append(
                    f"{at}: tune.error error {err!r} is not a "
                    "non-empty string")
        elif ev in BLAME_PCT_GAUGES and rec.get("kind") == "gauge":
            v = rec.get("value")
            if (not _num(v) or not math.isfinite(v)
                    or not 0.0 <= v <= 100.0):
                failures.append(
                    f"{at}: {ev} value {v!r} is not a finite share "
                    "in [0, 100]")
        elif ev == "blame.window_roots" and rec.get("kind") == "gauge":
            v = rec.get("value")
            if not _num(v) or not math.isfinite(v) or v < 0:
                failures.append(
                    f"{at}: blame.window_roots value {v!r} is not a "
                    "finite non-negative number")
    if not n_tune:
        failures.append(
            f"sink {path!r} has no tune.* records — was HPNN_TUNE "
            "armed during this run?")
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


def drill_reload(workdir: str, *, rate: float = 40.0,
                 ready_timeout_s: float = 90.0,
                 seed: int = 1, device=None) -> dict:
    """Hot-reload under load, first attempt chaos-failed: rewrite the
    served checkpoint, POST /v1/reload twice (raise@registry.reload
    armed for one firing), prove the new weights landed with zero
    lost requests."""
    from hpnn_tpu_torch.fileio import checkpoint as ckpt_mod
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.online import wal as wal_mod

    _shield_sigpipe()
    out: dict = {"ev": "drill.reload", "ok": False,
                 "device": _device_arg(device)}
    wal_dir = os.path.join(workdir, "wal")
    # seed the WAL so the child's kernel is checkpoint-backed (the
    # hot-reload path needs a file to watch)
    k1, _ = kernel_mod.generate(11, 8, [5], 2)
    wal = wal_mod.PromotionWAL(wal_dir)
    rec = wal.commit(KERNEL, k1.weights, version=1, reason="seed")
    ckpt_path = os.path.join(wal_dir, rec["ckpt"])
    port = free_port()
    child = Child(workdir, port, wal_dir=wal_dir,
                  chaos="raise@registry.reload:times=1",
                  interval_s=60.0,  # trainer parked: reload is the act
                  log_name="reload.log", device=device)
    try:
        ready = child.wait_ready(ready_timeout_s)
        out["boot_ready_s"] = ready["waited_s"]
        if not ready["ready"]:
            out["error"] = "child never became ready"
            out["log_tail"] = child.log_tail()
            return out
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        time.sleep(1.5)           # baseline bins
        k2, _ = kernel_mod.generate(13, 8, [5], 2)
        ckpt_mod.dump_checkpoint(ckpt_path, KERNEL, k2.weights,
                                 version=2, meta={"reason": "drill"})
        t_act = load.now()
        code1, _ = http_post(port, "/v1/reload", {"kernel": KERNEL})
        code2, _ = http_post(port, "/v1/reload", {"kernel": KERNEL})
        records = load.finish(settle_s=1.5)
        doc = child.health() or {}
        kdoc = doc.get("online", {}).get("kernels", {}).get(KERNEL, {})
        out.update(blast_radius(records, t_act))
        out["reload_codes"] = [code1, code2]
        out["chaos_failed_first"] = bool(code1 == 500)
        out["weights_sha"] = {"expect": weights_sha(k2.weights),
                              "got": kdoc.get("weights_sha")}
        out["reloaded_bitwise"] = (out["weights_sha"]["got"]
                                   == out["weights_sha"]["expect"])
        out["ok"] = bool(out["chaos_failed_first"]
                         and code2 == 200
                         and out["reloaded_bitwise"]
                         and out["lost"] == 0)
        return out
    finally:
        child.terminate()


def drill_sentinel(workdir: str, *, rate: float = 40.0,
                   ready_timeout_s: float = 90.0,
                   reject_timeout_s: float = 60.0,
                   seed: int = 2, device=None) -> dict:
    """Sentinel abort under load: every candidate is NaN-corrupted
    (``nan@train.round``); the gate must reject them all while the
    resident version keeps serving untouched."""
    _shield_sigpipe()
    out: dict = {"ev": "drill.sentinel", "ok": False,
                 "device": _device_arg(device)}
    port = free_port()
    child = Child(workdir, port, chaos="nan@train.round",
                  log_name="sentinel.log", device=device)
    try:
        ready = child.wait_ready(ready_timeout_s)
        out["boot_ready_s"] = ready["waited_s"]
        if not ready["ready"]:
            out["error"] = "child never became ready"
            out["log_tail"] = child.log_tail()
            return out
        doc0 = child.health() or {}
        k0 = doc0.get("online", {}).get("kernels", {}).get(KERNEL, {})
        sha0, v0 = k0.get("weights_sha"), k0.get("version")
        load = _Load(port, rate=rate, ingest_frac=0.5, seed=seed)

        def rejected():
            doc = child.health()
            if doc is None:
                return None
            on = doc.get("online", {})
            return (on.get("promoter", {}).get("rejected", 0) >= 2
                    and on.get("trainer", {}).get("trained", 0) >= 2
                    or None)

        saw = _wait(rejected, reject_timeout_s, interval_s=0.2)
        records = load.finish(settle_s=0.5)
        doc = child.health() or {}
        on = doc.get("online", {})
        k1 = on.get("kernels", {}).get(KERNEL, {})
        out["rejected"] = on.get("promoter", {}).get("rejected", 0)
        out["promoted"] = on.get("promoter", {}).get("promoted", 0)
        out["version"] = {"before": v0, "after": k1.get("version")}
        out["weights_sha"] = {"before": sha0,
                              "after": k1.get("weights_sha")}
        out["lost"] = sum(1 for r in records
                          if r["status"] == "lost")
        out["requests"] = len(records)
        if not saw:
            out["error"] = "fewer than 2 rejected candidates in time"
        out["ok"] = bool(saw
                         and out["promoted"] == 0
                         and k1.get("version") == v0
                         and k1.get("weights_sha") == sha0
                         and out["lost"] == 0)
        return out
    finally:
        child.terminate()


def drill_replica(workdir: str, *, rate: float = 80.0,
                  n_replicas: int = 3, seed: int = 3,
                  device=None) -> dict:
    """Kill one of N router replicas under load: an in-process
    Router behind ``make_server``, loadgen flowing, then
    ``kill_replica(0)``.  The route-around contract: bounded goodput
    dip, full recovery, zero lost requests among arrivals after the
    kill settles, and bitwise-identical answers from survivors (on the
    card every replica's captured graphs share ``cuda:0``, so the
    survivors' answers are another engine's replays)."""
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import make_server
    from hpnn_tpu_torch.serve.router import Router

    _shield_sigpipe()
    out: dict = {"ev": "drill.replica", "ok": False,
                 "device": _device_arg(device),
                 "replicas": n_replicas, "killed_rank": 0}
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    probe = np.linspace(-1.0, 1.0, 8)
    router = Router(n_replicas, max_batch=16, max_wait_ms=0.5,
                    device=device)
    server = None
    try:
        router.register_kernel(KERNEL, k)
        before = np.asarray(router.infer(KERNEL, probe))
        server = make_server(router)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever,
                                  daemon=True)
        thread.start()
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        time.sleep(1.5)           # baseline bins
        t_kill = load.now()
        router.kill_replica(0)
        records = load.finish(settle_s=2.5)
        after = np.asarray(router.infer(KERNEL, probe))
        doc = router.health()
        out.update(blast_radius(records, t_kill))
        # the router is supposed to make the death invisible at the
        # edge: once the kill has settled (in-flight victims re-routed
        # or failed within a beat), NOTHING may be lost on survivors
        out["survivors_lost"] = sum(
            1 for r in records
            if r["status"] == "lost" and r["t"] >= t_kill + 0.25)
        out["live_replicas"] = doc["router"]["live_replicas"]
        out["survivor_bitwise"] = bool(np.array_equal(before, after))
        out["ok"] = bool(out["recovery_s"] is not None
                         and out["survivors_lost"] == 0
                         and out["live_replicas"] == n_replicas - 1
                         and out["survivor_bitwise"])
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        router.close()


def drill_alert(workdir: str, *, rate: float = 60.0,
                n_replicas: int = 2, seed: int = 4,
                device=None) -> dict:
    """Prove the alert plane live: a threshold rule on the router's
    ``router.ready_replicas`` gauge (obs/alerts.py), loadgen flowing,
    then ``kill_replica(0)``.  The gauge re-emits on the kill, the
    rule breaches, ``alert.fire`` lands with the flight-recorder dump
    attached; ``spawn_replica()`` (on the card: a whole bucket menu
    captured while the survivors replay) re-emits a healthy value and
    the rule resolves.  Asserts the fire/resolve pair is in the sink,
    the dump file exists, and both transitions happened within 5 s."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import make_server
    from hpnn_tpu_torch.serve.router import Router

    _shield_sigpipe()
    out: dict = {"ev": "drill.alert", "ok": False,
                 "device": _device_arg(device),
                 "replicas": n_replicas, "killed_rank": 0}
    sink = os.path.join(workdir, "alert-drill.metrics.jsonl")
    flight_path = os.path.join(workdir, "alert-flight.jsonl")
    env = _Env(("HPNN_ALERTS", "HPNN_FLIGHT", "HPNN_METRICS"))
    os.environ["HPNN_ALERTS"] = (
        f"replicas_down@router.ready_replicas<{n_replicas - 0.5}:"
        "for=0,cooldown=0,severity=crit")
    os.environ["HPNN_FLIGHT"] = flight_path
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    router = server = None
    try:
        obs.configure(sink)   # re-reads every knob, arms rule + ring
        router = Router(n_replicas, max_batch=16, max_wait_ms=0.5,
                        device=device)
        router.register_kernel(KERNEL, k)
        server = make_server(router)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        time.sleep(1.5)           # baseline bins under healthy fleet
        t_kill = load.now()
        router.kill_replica(0)    # gauge drops below the bound
        fired = _wait(lambda: (obs.alerts.health_doc().get("active")
                               or None), 5.0, interval_s=0.02)
        t_fire = load.now()
        t_spawn = time.perf_counter()
        router.spawn_replica()    # gauge back to healthy
        out["spawn_s"] = round(time.perf_counter() - t_spawn, 3)
        resolved = _wait(
            lambda: (obs.alerts.health_doc().get("active") == 0
                     or None), 5.0, interval_s=0.02)
        t_resolve = load.now()
        records = load.finish(settle_s=0.5)
        census = obs.alerts.health_doc()
        # close the sink so the audit reads a complete stream
        obs.configure(None)
        events = _events(sink)
        fires = [r for r in events if r.get("ev") == "alert.fire"
                 and r.get("rule") == "replicas_down"]
        resolves = [r for r in events if r.get("ev") == "alert.resolve"
                    and r.get("rule") == "replicas_down"]
        out.update(blast_radius(records, t_kill))
        out["fire_s"] = round(t_fire - t_kill, 3) if fired else None
        out["resolve_s"] = (round(t_resolve - t_kill, 3)
                            if resolved else None)
        out["resolved"] = bool(resolved and resolves)
        out["fired_total"] = census.get("fired_total", 0)
        out["flight_attached"] = bool(
            fires and fires[-1].get("flight")
            and os.path.exists(fires[-1]["flight"]))
        out["ok"] = bool(fired and fires
                         and out["resolved"]
                         and out["flight_attached"])
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if router is not None:
            router.close()
        obs.configure(None)
        env.restore()


def drill_worker(workdir: str, *, rate: float = 60.0,
                 n_workers: int = 2, seed: int = 5,
                 ready_timeout_s: float = 90.0, device=None) -> dict:
    """Kill one of N worker PROCESSES behind a ClusterRouter under
    load: a WorkerSupervisor over real ``python -m
    hpnn_tpu_torch.cli.online_nn`` children sharing one WAL, the router
    as the HTTP edge, then SIGKILL one worker mid-stream.  The
    cross-host route-around contract: bounded goodput dip, zero
    ``survivors_lost``, bitwise survivor answers, and the corpse
    REPLACED by the supervisor restart policy within 30 s
    (``replaced_s``; on the card the replacement's boot captures its
    bucket menus)."""
    from hpnn_tpu_torch.fleet import ClusterRouter, WorkerSupervisor
    from hpnn_tpu_torch.fleet.router import CheckpointPublisher
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.online import wal as wal_mod
    from hpnn_tpu_torch.serve import make_server

    _shield_sigpipe()
    out: dict = {"ev": "drill.worker", "ok": False,
                 "device": _device_arg(device), "workers": n_workers}
    conf_path = os.path.join(workdir, "nn.conf")
    with open(conf_path, "w") as fp:
        fp.write(CONF)
    wal_dir = os.path.join(workdir, "wal")
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    # seed the shared WAL so every worker restores (and can reload)
    # the same resident weights
    wal_mod.PromotionWAL(wal_dir).commit(KERNEL, k.weights, version=1,
                                         reason="seed")
    probe = np.linspace(-1.0, 1.0, 8)
    sup = WorkerSupervisor(
        conf_path, workdir=workdir, kind="online", wal_dir=wal_dir,
        args=("--interval-s", "600",   # trainer parked: the drill
                                       # injures processes, not weights
              "--device", _device_arg(device)),
        ready_timeout_s=ready_timeout_s)
    router = server = None
    try:
        t_boot = time.perf_counter()
        try:
            for _ in range(n_workers):
                sup.spawn()
        except (RuntimeError, OSError) as exc:
            out["error"] = f"worker cannot start: {exc}"
            return out
        out["boot_s"] = round(time.perf_counter() - t_boot, 3)
        router = ClusterRouter(
            supervisor=sup,
            publisher=CheckpointPublisher(wal_dir=wal_dir))
        before = np.asarray(router.infer(KERNEL, probe, timeout_s=10.0))
        server = make_server(router)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        time.sleep(1.5)           # baseline bins
        victim = sup.ranks()[0]
        out["killed_rank"] = victim
        t_kill = load.now()
        sup.kill9(victim)
        # the supervisor restart policy, timed: reap the corpse and
        # spawn its replacement (readiness-gated, so "replaced" means
        # SERVING, not just forked)
        def replace():
            t0 = time.perf_counter()
            got = sup.replace_dead()
            if got:   # the replacement's own spawn -> ready
                out["replacement_boot_s"] = round(time.perf_counter() - t0, 3)
            return got or None

        replaced = _wait(replace, 30.0, interval_s=0.05)
        t_replaced = load.now()
        records = load.finish(settle_s=2.5)
        after = np.asarray(router.infer(KERNEL, probe, timeout_s=10.0))
        out.update(blast_radius(records, t_kill))
        # the router is supposed to make the worker death invisible at
        # the edge: after the kill settles, nothing may be lost
        out["survivors_lost"] = sum(
            1 for r in records
            if r["status"] == "lost" and r["t"] >= t_kill + 0.25)
        out["replaced_s"] = (round(t_replaced - t_kill, 3)
                             if replaced else None)
        out["width_after"] = sup.width()
        out["survivor_bitwise"] = bool(np.array_equal(before, after))
        out["ok"] = bool(out["recovery_s"] is not None
                         and out["survivors_lost"] == 0
                         and out["replaced_s"] is not None
                         and out["width_after"] == n_workers
                         and out["survivor_bitwise"])
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if router is not None:
            router.close()
        sup.close()


def drill_capsule(workdir: str, *, rate: float = 12.0,
                  seed: int = 6, delay_ms: float = 40.0,
                  device=None) -> dict:
    """The tail-latency forensics plane's live proof
    (docs/observability.md "Forensics"): an in-process serve Session
    with the tail sampler armed (``HPNN_SAMPLE=0.5``), a chaos delay
    injected at the ``serve.dispatch`` seam, an ``slo.p99_ms``
    threshold rule, and a capsule dir.  Loadgen traffic drives p99
    over the bound → the alert fires → the capture trigger lands a
    capsule (spans + gauges + a real ``torch.profiler`` window).
    Asserts the capsule manifest landed within 10 s of the fire with a
    non-empty span ring and profile, and that the tail report
    (``hpnn_tpu_torch/tools/tail_report.py``) over the run's sink
    blames the **dispatch** phase for most of the tail — the injected
    seam, not a neighbor."""
    from hpnn_tpu_torch import chaos as chaos_mod
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import Session, make_server
    from hpnn_tpu_torch.tools import tail_report

    _shield_sigpipe()
    out: dict = {"ev": "drill.capsule", "ok": False,
                 "device": _device_arg(device), "delay_ms": delay_ms}
    # Keep the offered inter-arrival above the injected delay so
    # batches stay singletons: a backlogged queue would launder the
    # dispatch delay into queue time (and, for non-batch[0] members,
    # into cross-request gap) and the blame assertion below would
    # point at the wrong phase.
    rate = min(rate, 500.0 / max(delay_ms, 1.0))
    sink = os.path.join(workdir, "capsule-drill.metrics.jsonl")
    capsule_dir = os.path.join(workdir, "capsules")
    env = _Env(("HPNN_SAMPLE", "HPNN_CAPSULE_DIR",
                "HPNN_CAPSULE_PROFILE_MS", "HPNN_CAPSULE_COOLDOWN_S",
                "HPNN_ALERTS", "HPNN_SLO_MS", "HPNN_CHAOS",
                "HPNN_CHAOS_SEED", "HPNN_METRICS"))
    os.environ["HPNN_SAMPLE"] = "0.5"
    os.environ["HPNN_CAPSULE_DIR"] = capsule_dir
    os.environ["HPNN_CAPSULE_PROFILE_MS"] = "50"
    os.environ["HPNN_CAPSULE_COOLDOWN_S"] = "0"
    os.environ["HPNN_SLO_MS"] = str(delay_ms / 2.0)
    # for=1.0 holds the fire until the breach has been true for a
    # second of traffic, so the span ring has sampled roots by the
    # time the capsule's spans.jsonl is written (a for=0 rule can
    # fire off the very first completed request, before any sampled
    # root has closed, and capture an empty ring).
    os.environ["HPNN_ALERTS"] = (
        f"tail_p99@slo.p99_ms>{delay_ms / 2.0}:"
        "for=1.0,cooldown=0,severity=warn")
    os.environ["HPNN_CHAOS"] = f"delay@serve.dispatch:ms={delay_ms}"
    os.environ["HPNN_CHAOS_SEED"] = "1"
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    session = server = None
    try:
        # warm compile BEFORE arming obs: the first request's captures
        # would otherwise spike slo.p99_ms and fire the alert off the
        # warmup, not the injected seam
        session = Session(max_batch=16, n_buckets=2, max_wait_ms=0.5,
                          device=device)
        session.register_kernel(KERNEL, k)
        warm = np.linspace(-1.0, 1.0, 8)
        for _ in range(3):
            session.infer(KERNEL, warm, timeout_s=10.0)
        if session.engine.device.type == "cuda":
            # the process's first torch.profiler session starts CUPTI,
            # 20-35 s on an H100: paid here, not inside the 10 s
            # window between the fire and the capsule's manifest
            from hpnn_tpu_torch.obs import profiler
            profiler.window(os.path.join(workdir, "profiler-warmup"), 10.0)
        obs.configure(sink)   # re-reads every knob: sampler, rule,
        chaos_mod._reset_for_tests()  # capsule hook, chaos plan
        server = make_server(session)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        load = _Load(port, rate=rate, ingest_frac=0.0, seed=seed)
        fired = _wait(lambda: (obs.alerts.health_doc().get("active")
                               or None), 15.0, interval_s=0.02)
        t_fire = load.now()
        manifest_path = _wait(lambda: _manifest(capsule_dir), 10.0,
                              interval_s=0.05)
        t_capsule = load.now()
        records = load.finish(settle_s=0.2)
        census = obs.triggers.health_doc()
        obs.configure(None)   # close the sink for the audit below
        out["requests"] = len(records)
        out["fired"] = bool(fired)
        out["capture_s"] = (round(t_capsule - t_fire, 3)
                            if fired and manifest_path else None)
        man = {}
        if manifest_path:
            with open(manifest_path) as fp:
                man = json.load(fp)
        out["capsule"] = man.get("capsule")
        out["capsule_spans"] = man.get("spans", 0)
        profile = man.get("profile") or {}
        out["profile_files"] = profile.get("files", 0)
        out["captures_total"] = census.get("captures", 0)
        # the forensic half: the report over the run's own sink must
        # pin the tail on the injected seam
        rep = tail_report.analyze(tail_report.load_spans([sink]),
                                  top=5)
        out["sampled_roots"] = rep["requests"]
        out["blame_pct"] = rep["blame_pct"]
        out["dispatch_blame_pct"] = rep["blame_pct"].get("dispatch",
                                                         0.0)
        out["ok"] = bool(fired and manifest_path
                         and str(man.get("reason", "")
                                 ).startswith("alert:tail_p99")
                         and out["capsule_spans"] > 0
                         and out["profile_files"] > 0
                         and rep["requests"] > 0
                         and out["dispatch_blame_pct"] > 50.0)
        return out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if session is not None:
            session.close()
        obs.configure(None)
        env.restore()
        chaos_mod._reset_for_tests()


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


def drill_tune(workdir: str, *, rate: float = 0.0, seed: int = 13,
               n_roots: int = 24, device=None) -> dict:
    """The self-tuning plane's proof (docs/selftuning.md): drive the
    REAL online blame engine with a synthetic span stream per blame
    class, and a scripted-clock :class:`~hpnn_tpu_torch.tune.engine.Tuner`
    over real actuator targets must move the MATCHING knob, watch the
    tail recover, and roll a bad move back bitwise.

    Deterministic and in-process — no child, no wall-clock races
    (``rate`` is accepted for :func:`run_drills` signature parity and
    unused).  Per class: inject ``n_roots`` request roots whose
    subtree charges ~90% of the root time to that class, tick, assert
    ``tune.apply`` names ``RULE_OF[class]``, script the p99 down, and
    let the watch expire clean (``watch_pass``).  Then two bad moves:
    a second ``precision_down`` whose scripted p99 regresses past the
    rollback ratio inside the watch (restore must be the prior
    precision tag, registry version chain strictly monotone; on the
    card each move captures the kernel's graphs anew on the live
    session), and a second ``quota_squeeze`` rolled back directly
    (restored spec must be the exact pre-apply :class:`TenantSpec`
    tuple).  Finally the sink must pass :func:`lint_tune` (a copy of
    ``tools/check_obs_catalog.py --tune``)."""
    import itertools

    from hpnn_tpu_torch import obs, serve, tune
    from hpnn_tpu_torch.fleet import autoscaler as autoscaler_mod
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.obs import blame
    from hpnn_tpu_torch.tenant.quota import QuotaEnforcer, TenantSpec
    from hpnn_tpu_torch.tune.engine import RULE_OF

    _shield_sigpipe()
    out: dict = {"ev": "drill.tune", "ok": False,
                 "device": _device_arg(device)}
    sink = os.path.join(workdir, "tune-drill.metrics.jsonl")
    env = _Env(("HPNN_METRICS", "HPNN_BLAME", "HPNN_BLAME_WINDOW",
                "HPNN_TUNE"))

    class _MemFleet:
        """width()/ranks()/spawn()/drain_and_kill() in memory — the
        request_up/request_down surface with no real processes."""

        def __init__(self, width: int):
            self._ranks = list(range(width))
            self._next = width

        def width(self):
            return len(self._ranks)

        def ranks(self):
            return list(self._ranks)

        def spawn(self):
            self._ranks.append(self._next)
            self._next += 1

        def drain_and_kill(self, rank):
            self._ranks.remove(rank)

    ids = itertools.count(1)
    child_name = {"queue": "serve.batch.queue",
                  "dispatch": "serve.dispatch",
                  "spill": "serve.spill_reload",
                  "shed_retry": "serve.retry_wait"}

    def inject(phase: str) -> None:
        """``n_roots`` fresh request roots, ~90% of each charged to
        ``phase`` — fed through the real ``note_record`` tap
        (children close before their root, as in the span
        lifecycle)."""
        for _ in range(n_roots):
            root = f"r{next(ids)}"
            child = {"span": f"c{next(ids)}", "parent": root,
                     "name": child_name[phase], "t0": 0.0, "dt": 0.9}
            if phase == "shed_retry":
                child["failed"] = "Shed"
            blame.note_record(child)
            blame.note_record({"span": root, "parent": None,
                               "name": "serve.request", "t0": 0.0,
                               "dt": 1.0, "kernel": KERNEL})

    sess = None
    try:
        obs.configure(sink)
        sess = serve.Session(max_batch=8, n_buckets=2,
                             max_wait_ms=0.5, mode="compiled",
                             device=device)
        k, _ = kernel_mod.generate(seed, 8, [5], 2)
        sess.register_kernel(KERNEL, k)
        scaler = autoscaler_mod.Autoscaler(
            _MemFleet(2), None,
            policy=autoscaler_mod.Policy(min_width=1, max_width=4,
                                         up_step=1))
        quota = QuotaEnforcer(
            {"bronze": TenantSpec("bronze", "bronze", rate_rps=40.0)})
        policy = tune.Policy(cooldown_s=5.0, watch_s=2.0)
        clock = {"t": 1000.0}
        p99 = {"v": 100.0}

        def fresh_tuner():
            return tune.Tuner(
                sess, autoscaler=scaler, quota=quota, policy=policy,
                clock=lambda: clock["t"], p99_fn=lambda: p99["v"],
                burn_fn=lambda: 3.0)

        def one_round(phase: str, *, regress: bool) -> dict:
            """inject → tick → scripted watch; returns the round's
            verdict/action plus what check_watch did."""
            blame.configure("1", window=16)  # fresh window per class
            inject(phase)
            p99["v"] = 100.0
            tuner = fresh_tuner()
            t_apply = clock["t"]
            d = tuner.tick()
            if regress:
                clock["t"] = t_apply + policy.watch_s / 2
                p99["v"] = 300.0  # past before * 1.25 inside watch
            else:
                clock["t"] = t_apply + policy.watch_s + 0.1
                p99["v"] = 40.0   # recovered: watch expires clean
            rolled = tuner.check_watch()
            return {"verdict": d.get("verdict"),
                    "action": d.get("action"), "id": d.get("id"),
                    "rolled_back": rolled, "tuner": tuner}

        rounds: dict = {}
        for phase in ("queue", "dispatch", "spill", "shed_retry"):
            rounds[phase] = one_round(phase, regress=False)
        width_after = scaler.supervisor.width()
        buckets_after = tuple(sess.engine.buckets)
        squeezed_rate = quota.spec("bronze").rate_rps

        # bad move 1: a second precision notch (f32 -> bf16) whose
        # scripted p99 regresses inside the watch -> rollback must
        # restore the prior tag as a NEW version (chain monotone)
        v_before_bad = sess.registry.get(KERNEL).version
        prec_before_bad = sess.registry.get(KERNEL).precision
        bad_prec = one_round("dispatch", regress=True)
        ent = sess.registry.get(KERNEL)
        prec_restored = ent.precision == prec_before_bad
        versions_monotone = ent.version > v_before_bad

        # bad move 2: a second quota squeeze rolled back directly (the
        # bad-action path drills exercise) — the restored spec must be
        # the exact pre-apply tuple
        spec_before_bad = quota.spec("bronze")
        blame.configure("1", window=16)
        inject("shed_retry")
        p99["v"] = 100.0
        bad_quota_tuner = fresh_tuner()
        bad_quota = bad_quota_tuner.tick()
        bad_quota_rolled = bad_quota_tuner.rollback("drill_bad_action")
        quota_restored = quota.spec("bronze") == spec_before_bad

        blame.flush()
        obs.configure(None)  # close the sink for a complete audit

        events = _events(sink)
        applies = [r for r in events if r.get("ev") == "tune.apply"]
        rollbacks = [r for r in events
                     if r.get("ev") == "tune.rollback"]
        scale_ups = [r for r in events
                     if r.get("ev") == "fleet.scale_up"
                     and r.get("reason") == "tune:queue"]
        # warmup re-emits the resident version; the chain claim is
        # over the retags themselves (source=set): every move — the
        # two downshifts AND the rollback's restore — a fresh version
        prec_versions = [r.get("version") for r in events
                         if r.get("ev") == "serve.precision"
                         and r.get("source") == "set"]

        matched = sum(
            1 for phase in rounds
            if rounds[phase]["verdict"] == "apply"
            and rounds[phase]["action"] == RULE_OF[phase])
        out["applies"] = round(matched / 4.0, 3)
        out["actions"] = {p: rounds[p]["action"] for p in rounds}
        out["recovered"] = sum(
            1 for p in rounds if rounds[p]["rolled_back"] is None)
        out["width_after"] = width_after
        out["buckets_after"] = list(buckets_after)
        out["squeezed_rate_rps"] = squeezed_rate
        out["bad_prec_rolled_back"] = bad_prec["rolled_back"]
        out["precision_restored_bitwise"] = prec_restored
        out["version_chain_monotone"] = bool(
            versions_monotone
            and prec_versions == sorted(prec_versions)
            and len(set(prec_versions)) == len(prec_versions))
        out["bad_quota_rolled_back"] = bad_quota_rolled
        out["quota_restored_bitwise"] = quota_restored
        out["rollback_bitwise"] = (
            1.0 if (prec_restored and quota_restored) else 0.0)
        out["applies_in_sink"] = len(applies)
        out["rollbacks_in_sink"] = len(rollbacks)
        rollback_pairs_ok = (
            len(rollbacks) == 2
            and {r.get("id") for r in rollbacks}
            <= {a.get("id") for a in applies}
            and {r.get("reason") for r in rollbacks}
            == {"p99_regression", "drill_bad_action"})
        out["rollback_pairs_ok"] = rollback_pairs_ok
        lint = lint_tune(sink)
        out["lint_failures"] = lint
        out["ok"] = bool(
            matched == 4
            and out["recovered"] == 4
            and width_after == 3            # scale_up: 2 -> 3
            and len(buckets_after) == 3     # grow_buckets: 2 -> 3
            and squeezed_rate == 20.0       # quota_squeeze: 40 -> 20
            and bad_prec["rolled_back"] == "precision_down"
            and bad_quota["verdict"] == "apply"
            and bad_quota_rolled == "quota_squeeze"
            and out["rollback_bitwise"] == 1.0
            and out["version_chain_monotone"]
            and scale_ups
            and rollback_pairs_ok
            and not lint)
        return out
    finally:
        if sess is not None:
            sess.close()
        obs.configure(None)
        blame.configure(None)
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
    "reload": drill_reload,
    "sentinel": drill_sentinel,
    "replica": drill_replica,
    "alert": drill_alert,
    "worker": drill_worker,
    "capsule": drill_capsule,
    "drift": drill_drift,
    "quota": drill_quota,
    "hog": drill_hog,
    "tune": drill_tune,
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
        description="chaos drills against the port (kill9 / reload / "
                    "sentinel / replica / alert / worker / capsule / "
                    "drift / quota / hog / tune / torn)")
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
