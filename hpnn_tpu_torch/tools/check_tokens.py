"""Byte-stability lint for the port's stdout token protocol.

The twin of the repo's ``tools/check_tokens.py`` over ``hpnn_tpu_torch``.
The ``NN: `` / ``NN(WARN): `` / ``NN(ERR): `` / ``#DBG: acc[`` token lines
are the reference's de-facto metrics API (tutorial monitors grep them),
so the port's obs planes must never perturb them.  :func:`check` runs
the same 6-sample 8-5-2 ANN-BP train+eval round through the port's
``train/driver.py`` on ``device``, and asserts:

1. the plain run's stdout is **byte-identical** to the maximal
   instrumented run's: the JSONL sink, the flight ring, the probes, the
   numerics sentinel and checksum ledger, spans and cost, the SLO
   tracker, an armed chaos plan and WAL dir, a LIVE in-process collector
   with the push client armed, an alert rule that really fires on the
   round's own ``fuse.chunk_size`` gauge, the forensics sampler with a
   capsule dir the firing rule captures into, drift, metering, blame and
   tuning armed, every ``HPNN_CONN_*`` guard on the collector's sockets,
   the ``HPNN_ONLINE_*`` family with ``HPNN_SERVE_DTYPE=bf16``, and an
   export server whose ``/metrics`` is scraped inside the capture window;
2. the token lines match the golden shapes and no line smells of JSON;
3. serving is a bystander: a per-kernel ``Session``, an SLO-armed one
   with a forced ``Shed`` on a fake-clock batcher, a fleet-mode session
   with one coalesced two-member dispatch and a ``train_fleet`` round, a
   train-while-serve round (feed, tick through the gate, infer,
   rollback), a 2-replica ``Router`` round trip with a fenced install,
   and a 2-worker ``ClusterRouter`` round trip over HTTP with a fenced
   ``CheckpointPublisher`` install re-read by both workers write no
   stdout byte, and the next round's stdout is byte-identical again;
4. a ledger-only run prints the same bytes and records the same
   ``ledger.round`` rows as the probed run, row for row: the probes do
   not perturb the weights (on the card this needs kernel #1's reruns
   to be bitwise);
5. the instrumented run's sink carries the tentpole events, the
   collector received the pushed records and a capsule landed.

Three differences from the repo's lint, on purpose:

* the ``Router`` round trip runs without ``HPNN_COMPILE_CACHE_DIR``: the
  port refuses that knob (a CUDA graph cannot be written to disk,
  ``runtime.DEFERRED_ENV``);
* the sink's XLA-only ``device.live_arrays`` census is replaced by the
  port's own device gauges: ``device.compile_events`` everywhere, and
  ``device.hbm_bytes_in_use`` on the card (both in the documented
  catalog, docs/observability.md);
* on the card the golden shapes also take the reference's
  ``NN: [GPU] ANN total allocation: N (bytes)`` line, which the port's
  drivers print at ``-vv`` once the weights are on the card
  (``utils/debug.py``); the JAX lint runs only on the CPU, where no such
  line prints.

    python -m hpnn_tpu_torch.tools.check_tokens --device cpu
    python -m hpnn_tpu_torch.tools.check_tokens          # on the card

Exits 1 with one ``check_tokens: FAIL:`` line a failure on stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import threading
import time

TOKEN_PREFIXES = ("NN: ", "NN(WARN): ", "NN(ERR): ", "NN(DBG): ",
                  "#DBG: acc[")

# every stdout line of a -vv ANN train+eval round must match one of
# these (the token formats of train/driver.py)
GOLDEN = [
    re.compile(r"^NN: TRAINING FILE: .{1,16}\t"
               r" init= *[0-9.+-]+ (OK|NO) N_ITER= *\d+"
               r" final= *[0-9.+-]+( (SUCCESS!|FAIL!))?$"),
    re.compile(r"^NN: TESTING FILE: .{1,16}\t"
               r"( BEST CLASS idx=\d+ P= *[0-9.+-]+)?"
               r" \[(PASS|FAIL( idx=\d+)?)\]$"),
    re.compile(r"^NN\((WARN|ERR|DBG)\): .*$"),
    re.compile(r"^#DBG: acc\[.+\]=[0-9.]+$"),
    re.compile(r"^$"),
]
# ... and on the card, the reference's device-allocation token
# (``scuda_ann_allocate``, libhpnn src/ann.c:199; utils/debug.py)
GOLDEN_CUDA = [
    re.compile(r"^NN: \[GPU\] ANN total allocation: \d+ \(bytes\)$"),
]

# the sink events the instrumented round must carry
SINK_EVENTS = ("round.start", "driver.chunk_dispatch", "train.n_iter",
               "fuse.chunk_size", "round.end", "obs.summary",
               "device.compile_events", "numerics.probe",
               "numerics.checksum", "span.end", "compile.cost",
               "perf.flops_per_s", "alert.fire", "collector.push",
               "forensics.capture")
# ... and on the card, the allocator's census too
SINK_EVENTS_CUDA = ("device.hbm_bytes_in_use",)

# the HPNN_ONLINE_* family (docs/online.md) is read only inside
# online/ — setting it during a plain train+eval round must be inert:
# not a byte, not an event; HPNN_SERVE_DTYPE is read only by a serve
# Engine at construction
ONLINE_KNOBS = (("HPNN_ONLINE_BUFFER", "64"),
                ("HPNN_ONLINE_RESERVOIR", "8"),
                ("HPNN_ONLINE_HOLDOUT", "4"),
                ("HPNN_ONLINE_ROWS", "16"),
                ("HPNN_ONLINE_BATCH", "4"),
                ("HPNN_ONLINE_EPOCHS", "2"),
                ("HPNN_ONLINE_INTERVAL_S", "60"),
                ("HPNN_ONLINE_MARGIN", "0.0"),
                ("HPNN_ONLINE_WATCH_S", "5"),
                ("HPNN_ONLINE_SCAN_K", "4"),
                ("HPNN_SERVE_DTYPE", "bf16"))


def _tiny_conf(tmpdir: str):
    """A 6-sample 8->5->2 ANN BP round."""
    import numpy as np

    from hpnn_tpu_torch.config import NNConf, NNTrain, NNType
    from hpnn_tpu_torch.models import kernel as kernel_mod

    rng = np.random.RandomState(0)
    sdir = os.path.join(tmpdir, "samples")
    os.makedirs(sdir, exist_ok=True)
    for i in range(6):
        c = i % 2
        x = (1 - 2 * c) * np.r_[np.ones(4), -np.ones(4)] \
            + 0.1 * rng.normal(size=8)
        t = np.full(2, -1.0)
        t[c] = 1.0
        with open(os.path.join(sdir, f"s{i:05d}.txt"), "w") as fp:
            fp.write("[input] 8\n"
                     + " ".join(f"{v:.5f}" for v in x) + "\n")
            fp.write("[output] 2\n"
                     + " ".join(f"{v:.1f}" for v in t) + "\n")
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    return NNConf(name="t", type=NNType.ANN, seed=1, kernel=k,
                  train=NNTrain.BP, samples=sdir, tests=sdir)


def _run_round(tmpdir: str, metrics_path: str | None, probe=None, *,
               device: str = "cuda") -> str:
    """One train+eval round on ``device``, stdout captured; returns the
    capture.  ``probe`` (optional) runs after the round while stdout is
    still redirected and the obs state still live: the hook the export
    check uses to scrape /metrics inside the capture window."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.train import driver
    from hpnn_tpu_torch.utils import logging as log

    obs.configure(metrics_path)  # sets/clears HPNN_METRICS + memo
    conf = _tiny_conf(tmpdir)
    log.set_verbose(2)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            if not driver.train_kernel(conf, device=device):
                raise RuntimeError("train_kernel failed")
            driver.run_kernel(conf, device=device)
            if probe is not None:
                probe()
    finally:
        log.set_verbose(0)
        obs.configure(None)
    return buf.getvalue()


def _plane_modules():
    """The modules whose memos the instrumented run resets, in the
    order the repo's lint resets them."""
    from hpnn_tpu_torch import chaos, tune
    from hpnn_tpu_torch.obs import blame, drift, forensics, meter, triggers
    from hpnn_tpu_torch.online import wal

    return (chaos, wal, forensics, triggers, drift, meter, blame, tune)


def _instrumented_round(tmpdir: str, sink: str, ledger_b: str,
                        capsule_dir: str, wal_dir: str, scraped: dict,
                        device: str):
    """The maximal instrumented round; returns (stdout, collector)."""
    from hpnn_tpu_torch.obs import collector as collector_mod
    from hpnn_tpu_torch.serve import conn as conn_mod

    def probe():
        from urllib.request import urlopen

        from hpnn_tpu_torch.obs import export

        server = export.start_export_server(port=0)
        try:
            port = server.server_address[1]
            scraped["metrics"] = urlopen(
                f"http://127.0.0.1:{port}/metrics",
                timeout=10).read().decode()
        finally:
            export.stop_export_server(server)

    # the connection plane: every HPNN_CONN_* knob armed BEFORE the
    # collector starts, so the round's live push traffic flows through
    # the guarded socket path
    knobs = {"HPNN_CONN_HDR_MS": "5000", "HPNN_CONN_BODY_MS": "5000",
             "HPNN_CONN_PER_IP": "64", "HPNN_CONN_MIN_BPS": "1",
             "HPNN_CONN_TABLE": "64"}
    os.environ.update(knobs)
    conn_mod._reset_for_tests()
    coll_server = collector_mod.start_collector(
        path=os.path.join(tmpdir, "collector_merged.jsonl"))
    coll_port = coll_server.server_address[1]
    armed = {
        "HPNN_FLIGHT": os.path.join(tmpdir, "flight.jsonl"),
        "HPNN_PROBES": "1",
        "HPNN_NUMERICS": "warn",
        "HPNN_LEDGER": ledger_b,
        "HPNN_SPANS": "1",
        "HPNN_COST": "1",
        "HPNN_SLO_MS": "50",
        # an ARMED plan whose seam the train path never passes, and a
        # live WAL dir the round never commits to
        "HPNN_CHAOS": "delay@serve.dispatch:ms=0",
        "HPNN_CHAOS_SEED": "1",
        "HPNN_WAL_DIR": wal_dir,
        "HPNN_COLLECTOR": f"http://127.0.0.1:{coll_port}",
        "HPNN_COLLECTOR_FLUSH_S": "0.05",
        # fires on the round's own gauge, and pulls the capture trigger
        "HPNN_ALERTS": "lint_chunk@fuse.chunk_size>0:cooldown=0",
        "HPNN_SAMPLE": "1",
        "HPNN_CAPSULE_DIR": capsule_dir,
        "HPNN_CAPSULE_PROFILE_MS": "0",
        "HPNN_CAPSULE_COOLDOWN_S": "0",
        # their taps sit on serving and online paths a train round
        # never touches
        "HPNN_DRIFT": "1",
        "HPNN_METER": "1",
        "HPNN_BLAME": "1",
        "HPNN_TUNE": "1",
    }
    armed.update(ONLINE_KNOBS)
    knobs.update(armed)
    os.environ.update(armed)
    for mod in _plane_modules():
        mod._reset_for_tests()
    try:
        out = _run_round(os.path.join(tmpdir, "b"), sink, probe=probe,
                         device=device)
    finally:
        for knob in knobs:
            os.environ.pop(knob, None)
        conn_mod._reset_for_tests()
        for mod in _plane_modules():
            mod._reset_for_tests()
    return out, coll_server


def _check_collector(coll_server, failures: list) -> None:
    """The push client's final drain ran inside the round's
    ``obs.configure(None)``: give the collector a beat to absorb the
    last batch, then its received count must be real."""
    from hpnn_tpu_torch.obs import collector as collector_mod

    coll = coll_server.collector
    deadline = time.monotonic() + 5.0
    while coll.records_total == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    fleet_doc = coll.fleetz()
    collector_mod.stop_collector(coll_server)
    if coll.records_total <= 0:
        failures.append(
            "live collector received NO telemetry with HPNN_COLLECTOR "
            "armed — the push path is dead")
    elif not fleet_doc.get("workers"):
        failures.append(
            "collector /fleetz lists no workers after a pushed round "
            f"(records_total={coll.records_total})")


def _check_capsule(capsule_dir: str, failures: list) -> None:
    """The firing alert rule must also have pulled the capture trigger:
    an async capsule with a manifest under ``HPNN_CAPSULE_DIR``."""
    manifest_path = None
    deadline = time.monotonic() + 5.0
    while manifest_path is None and time.monotonic() < deadline:
        for dirpath, _dirs, files in os.walk(capsule_dir):
            if "manifest.json" in files:
                manifest_path = os.path.join(dirpath, "manifest.json")
                break
        else:
            time.sleep(0.05)
    if manifest_path is None:
        failures.append(
            "no capture capsule landed with HPNN_CAPSULE_DIR + a "
            "firing alert rule armed — the alert->capture hook is dead")
        return
    with open(manifest_path) as fp:
        man = json.load(fp)
    if not str(man.get("reason", "")).startswith("alert:"):
        failures.append(
            f"capsule manifest reason {man.get('reason')!r} is not "
            "alert-attributed")
    if "spans.jsonl" not in man.get("files", []):
        failures.append(
            "capsule manifest lists no spans.jsonl — the sampler ring "
            "never reached the capsule")


def _check_lines(plain: str, failures: list, device: str = "cpu") -> None:
    golden = GOLDEN + (GOLDEN_CUDA if device == "cuda" else [])
    if not plain.strip():
        failures.append("no stdout captured — the round emitted nothing")
    for line in plain.splitlines():
        if not any(g.match(line) for g in golden):
            failures.append(f"unexpected stdout line shape: {line!r}")
        if line and not line.startswith(TOKEN_PREFIXES):
            failures.append(f"non-token stdout line: {line!r}")
        if '"ev"' in line or '"kind"' in line or line.startswith("{"):
            failures.append(f"obs JSON leaked into stdout: {line!r}")


def _serve_bystander(tmpdir: str, device: str, failures: list) -> None:
    """Serving, the fleet, online learning, the Router and the cluster,
    each exercised to silence (module docstring, point 3)."""
    import numpy as np

    from hpnn_tpu_torch import obs, online, serve
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve import batcher as batcher_mod
    from hpnn_tpu_torch.train import fleet as fleet_mod

    sess = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=1.0,
                         device=device)
    k, _ = kernel_mod.generate(7, 8, [5], 2)
    sess.register_kernel("lint", k)
    sess.infer("lint", np.zeros(8))
    sess.close()

    # SLO tracking + load shedding armed, a request served and a Shed
    # forced on a fake-clock batcher — with the knobs ON
    os.environ["HPNN_SLO_MS"] = "50"
    os.environ["HPNN_SHED_AGE_MS"] = "5"
    obs.slo._reset_for_tests()
    shed_buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(shed_buf):
            ssess = serve.Session(max_batch=8, n_buckets=2,
                                  max_wait_ms=1.0, device=device)
            ssess.register_kernel("lint_slo", k)
            ssess.infer("lint_slo", np.zeros(8))
            ssess.close()
            fake = [0.0]
            b = batcher_mod.Batcher(lambda p: p, clock=lambda: fake[0],
                                    name="lint_shed", start=False)
            b.submit(np.zeros((1, 8)))
            fake[0] = 1.0  # oldest waiter now 1000 ms > 5 ms threshold
            try:
                b.submit(np.zeros((1, 8)))
                raise RuntimeError("expected Shed")
            except batcher_mod.Shed:
                pass
            b.close()
    finally:
        os.environ.pop("HPNN_SLO_MS", None)
        os.environ.pop("HPNN_SHED_AGE_MS", None)
        obs.slo._reset_for_tests()
    if shed_buf.getvalue():
        failures.append(
            "SLO tracking / load shedding wrote stdout: "
            f"{shed_buf.getvalue()[:120]!r}")

    fsess = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=1.0,
                          fleet=True, device=device)
    k2, _ = kernel_mod.generate(11, 8, [5], 2)
    fsess.register_kernel("lint_a", k)
    fsess.register_kernel("lint_b", k2)
    fsess.infer("lint_a", np.zeros(8))
    fsess.infer("lint_b", np.zeros(8))
    # one genuinely coalesced two-member group through the stacked
    # forward (sequential infers usually drain solo)
    fsess.engine.dispatch_fleet([("lint_a", np.zeros((1, 8))),
                                 ("lint_b", np.zeros((1, 8)))])
    fsess.close()

    rng = np.random.RandomState(5)
    Xf = rng.uniform(-1, 1, (4, 8)).astype(np.float64)
    Tf = np.full((4, 2), -1.0)
    Tf[np.arange(4), rng.randint(0, 2, 4)] = 1.0
    fleet_mod.train_fleet([k, k2], Xf, Tf, epochs=1, batch=2,
                          seeds=[1, 2], device=device)

    # train-while-serve with the whole HPNN_ONLINE_* family set: feed,
    # a synchronous round through the gate, a query, a rollback
    online_sink = os.path.join(tmpdir, "online.jsonl")
    for knob, val in ONLINE_KNOBS:
        os.environ[knob] = val
    online_buf = io.StringIO()
    try:
        obs.configure(online_sink)
        with contextlib.redirect_stdout(online_buf):
            osess = online.OnlineSession(
                serve_kwargs=dict(max_batch=8, n_buckets=2,
                                  max_wait_ms=1.0, device=device))
            osess.add_kernel("lint_online", k)
            orng = np.random.RandomState(3)
            Xo = orng.uniform(0.0, 1.0, (48, 8))
            osess.feed(Xo, np.tanh(Xo[:, :2]))
            osess.tick()
            osess.infer("lint_online", np.zeros(8))
            osess.rollback("lint_online")
            osess.close()
    finally:
        obs.configure(None)
        for knob, _ in ONLINE_KNOBS:
            os.environ.pop(knob, None)
    if online_buf.getvalue():
        failures.append(
            "online train-while-serve round wrote stdout: "
            f"{online_buf.getvalue()[:120]!r}")
    with open(online_sink) as fp:
        onames = {json.loads(ln).get("ev") for ln in fp if ln.strip()}
    for want in ("online.ingest", "online.buffer_depth",
                 "online.staleness_s", "online.round",
                 "online.train_loss", "online.candidate_loss",
                 "online.resident_loss"):
        if want not in onames:
            failures.append(f"online sink missing event {want!r}")
    if not {"online.promote", "online.reject"} & onames:
        failures.append(
            "online sink carries neither online.promote nor "
            "online.reject — the gate never ruled")

    # a 2-replica Router in compiled mode: fan-out register, routed
    # infers (one vector, a row block), a fenced install_kernel.  No
    # HPNN_COMPILE_CACHE_DIR: the port refuses it.
    router_buf = io.StringIO()
    with contextlib.redirect_stdout(router_buf):
        router = serve.Router(2, max_batch=8, n_buckets=1,
                              max_wait_ms=1.0, mode="compiled",
                              device=device)
        try:
            router.register_kernel("lint_router", k)
            router.infer("lint_router", np.zeros(8))
            router.infer("lint_router", np.zeros((3, 8)))
            k3, _ = kernel_mod.generate(13, 8, [5], 2)
            router.install_kernel("lint_router", k3)
            router.infer("lint_router", np.zeros(8))
        finally:
            router.close()
    if router_buf.getvalue():
        failures.append(
            "2-replica Router round trip wrote stdout: "
            f"{router_buf.getvalue()[:120]!r}")

    _cluster_round_trip(tmpdir, device, k, failures)


def _cluster_round_trip(tmpdir: str, device: str, k, failures) -> None:
    """Two in-process HTTP workers (Session + make_server on ephemeral
    ports, the wire surface a worker process exposes), a ClusterRouter
    fanning infers over them, and a fenced CheckpointPublisher install
    re-read by both workers over /v1/reload."""
    import numpy as np

    from hpnn_tpu_torch import serve
    from hpnn_tpu_torch.fileio import checkpoint as fileio_ckpt
    from hpnn_tpu_torch.fleet.client import WorkerHandle
    from hpnn_tpu_torch.fleet.router import CheckpointPublisher, ClusterRouter
    from hpnn_tpu_torch.models import kernel as kernel_mod
    from hpnn_tpu_torch.serve.server import make_server

    cluster_buf = io.StringIO()
    cluster_path = os.path.join(tmpdir, "lint_cluster.ckpt")
    fileio_ckpt.dump_checkpoint(cluster_path, "lint_cluster",
                                k.weights, version=1)
    with contextlib.redirect_stdout(cluster_buf):
        sessions, servers, handles = [], [], []
        try:
            for rank in range(2):
                sess = serve.Session(max_batch=8, n_buckets=1,
                                     max_wait_ms=0.5, device=device)
                sess.load_kernel("lint_cluster", cluster_path)
                srv = make_server(sess, port=0)
                threading.Thread(target=srv.serve_forever,
                                 daemon=True).start()
                sessions.append(sess)
                servers.append(srv)
                handles.append(WorkerHandle(
                    rank, "127.0.0.1", srv.server_address[1]))
            cluster = ClusterRouter(
                workers=handles,
                publisher=CheckpointPublisher(
                    {"lint_cluster": cluster_path},
                    versions={"lint_cluster": 1}))
            cluster.infer("lint_cluster", np.zeros(8))
            cluster.infer("lint_cluster", np.zeros((3, 8)))
            k4, _ = kernel_mod.generate(17, 8, [5], 2)
            cluster.install_kernel("lint_cluster", k4)
            cluster.infer("lint_cluster", np.zeros(8))
            cluster.close()
        finally:
            for srv in servers:
                srv.shutdown()
                srv.server_close()
            for sess in sessions:
                sess.close()
    if cluster_buf.getvalue():
        failures.append(
            "2-worker ClusterRouter round trip wrote stdout: "
            f"{cluster_buf.getvalue()[:120]!r}")


def _ledger_rounds(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as fp:
        return [
            {k: rec[k] for k in ("row", "step", "where", "nan", "inf",
                                 "checksums", "shapes")}
            for rec in (json.loads(ln) for ln in fp if ln.strip())
            if rec.get("ev") == "ledger.round"
        ]


def check(tmpdir: str, device: str = "cuda", *,
          stats: dict | None = None) -> list[str]:
    """Run the lint on ``device``; returns a list of failure strings
    (empty = pass).  ``stats``, when given, is filled with the count of
    token lines compared and of sink events."""
    failures: list[str] = []
    sink = os.path.join(tmpdir, "obs.jsonl")
    capsule_dir = os.path.join(tmpdir, "capsules")
    wal_dir = os.path.join(tmpdir, "wal")
    ledger_b = os.path.join(tmpdir, "ledger_b.jsonl")
    scraped: dict = {}
    plain = _run_round(os.path.join(tmpdir, "a"), None, device=device)
    instrumented, coll_server = _instrumented_round(
        tmpdir, sink, ledger_b, capsule_dir, wal_dir, scraped, device)

    from hpnn_tpu_torch.online import wal as wal_mod

    if plain != instrumented:
        failures.append(
            "stdout is NOT byte-identical with HPNN_METRICS + every obs, "
            "chaos, WAL, collector (live push), alert (firing rule), "
            "sampler, capsule, drift, meter, blame, tune, HPNN_CONN_*, "
            "HPNN_ONLINE_* and HPNN_SERVE_DTYPE=bf16 knob + export server "
            f"enabled (plain {len(plain)}B vs instrumented "
            f"{len(instrumented)}B)")
    if os.path.exists(os.path.join(wal_dir, wal_mod.WAL_NAME)):
        failures.append(
            "a plain train round wrote the promotion WAL — "
            "HPNN_WAL_DIR must be inert outside online/")
    _check_collector(coll_server, failures)
    _check_capsule(capsule_dir, failures)
    body = scraped.get("metrics", "")
    if "# TYPE" not in body or "hpnn_" not in body:
        failures.append(
            "live /metrics scrape is not Prometheus text exposition "
            f"(got {body[:80]!r})")
    _check_lines(plain, failures, device)

    _serve_bystander(tmpdir, device, failures)
    with_serve = _run_round(os.path.join(tmpdir, "c"), None,
                            device=device)
    if plain != with_serve:
        failures.append(
            "stdout is NOT byte-identical after exercising serve "
            "(per-kernel + fleet + 2-replica Router + 2-worker "
            "ClusterRouter over HTTP), train.fleet and online "
            f"(plain {len(plain)}B vs with-serve {len(with_serve)}B)")

    # the probes' zero-perturbation proof: a ledger-only run prints the
    # same bytes and records the same checksums as the probed run b
    # (which also had HPNN_SERVE_DTYPE=bf16 and HPNN_ONLINE_SCAN_K armed)
    ledger_d = os.path.join(tmpdir, "ledger_d.jsonl")
    os.environ["HPNN_LEDGER"] = ledger_d
    try:
        ledger_only = _run_round(os.path.join(tmpdir, "d"), None,
                                 device=device)
    finally:
        os.environ.pop("HPNN_LEDGER", None)
    if plain != ledger_only:
        failures.append(
            "stdout is NOT byte-identical with HPNN_LEDGER enabled "
            f"(plain {len(plain)}B vs ledger-only {len(ledger_only)}B)")
    rounds_b, rounds_d = _ledger_rounds(ledger_b), _ledger_rounds(ledger_d)
    if not rounds_b or not rounds_d:
        failures.append(
            f"ledger missing or empty (b={rounds_b and len(rounds_b)}, "
            f"d={rounds_d and len(rounds_d)})")
    elif rounds_b != rounds_d:
        failures.append(
            "probes are NOT zero-perturbation: probed ledger differs "
            f"from ledger-only ledger ({rounds_b} vs {rounds_d})")

    if stats is not None:
        stats["token_lines"] = len(plain.splitlines())
        stats["ledger_rows"] = len(rounds_b or ())
    if not os.path.exists(sink):
        failures.append("instrumented run produced no metrics sink")
        return failures
    with open(sink) as fp:
        recs = [json.loads(ln) for ln in fp if ln.strip()]
    if not recs:
        failures.append("metrics sink is empty")
    if stats is not None:
        stats["sink_events"] = len(recs)
    names = {r.get("ev") for r in recs}
    want = SINK_EVENTS + (SINK_EVENTS_CUDA if device == "cuda" else ())
    for ev in want:
        if ev not in names:
            failures.append(f"metrics sink missing event {ev!r}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="byte-stability lint of the port's stdout token "
                    "protocol under every obs plane")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the rounds, sessions and workers run")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmpdir:
        failures = check(tmpdir, device=args.device)
    if failures:
        for f in failures:
            sys.stderr.write(f"check_tokens: FAIL: {f}\n")
        return 1
    sys.stderr.write("check_tokens: OK — stdout tokens byte-stable, "
                     "sink populated\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
