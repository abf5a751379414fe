"""The port's serving planes (``hpnn_tpu_torch/obs/{alerts,forensics,
drift,blame,meter,triggers,collector}.py`` and ``hpnn_tpu_torch/tune``)
on the CPU, held against the JAX package's.

* the pure functions match exactly: alert rule evaluation, the drift
  sketches' values and verdicts, blame's split of the same span records,
  ``tune.decide`` over the verdict table of tests/test_tune.py, the
  meter governor's top-K plus ``_other``;
* with every plane armed on a CPU float64 session at 8-6-2 and
  784-300-10, answers are bitwise the plane-free session's and within
  1e-12 of ``hpnn_tpu``'s; ``/healthz`` and each plane's section carry
  the JAX documents' keys, as do ``/meterz`` and ``/tunez``; a
  ``POST /v1/capture`` capsule has the JAX file layout;
* the tuning plane's actuators work on the port's engine, and a
  rollback restores the prior policy bitwise;
* the port's ``HPNN_METRICS`` sink from such a run passes
  ``tools/check_obs_catalog.py``'s ``--forensics``, ``--drift``,
  ``--meter`` and ``--tune`` checks;
* the collector runs in-process on port 0; one profiler window at a
  time; ``serve_nn`` takes ``--sample`` and ``--capsule-dir``.

No test spawns a process.
"""

import http.client
import importlib.util
import json
import os
import threading

import numpy as np
import pytest

from hpnn_tpu import obs as jobs
from hpnn_tpu import serve as jserve
from hpnn_tpu import tune as jtune
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.obs import alerts as jalerts
from hpnn_tpu.obs import blame as jblame
from hpnn_tpu.obs import drift as jdrift
from hpnn_tpu.obs import meter as jmeter
from hpnn_tpu_torch import obs, runtime, serve, tune
from hpnn_tpu_torch.cli import serve_nn
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.obs import alerts, blame, drift, meter, profiler
from hpnn_tpu_torch.tenant import QuotaEnforcer, TenantSpec
from hpnn_tpu_torch.utils import logging as log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
SHAPES = {"8-6-2": (8, (6,), 2), "784-300-10": (784, (300,), 10)}
SERVE_KNOBS = ("HPNN_SERVE_MODE", "HPNN_SERVE_DTYPE", "HPNN_SERVE_FLEET",
               "HPNN_TENANTS", "HPNN_TENANT_SHARDS", "HPNN_TENANT_RESIDENT",
               "HPNN_TENANT_PAGE_DIR", "HPNN_DTYPE")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """Both packages' plane modules keep memoized process state: clear
    every knob and forget both packages' memos around the test."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, *SERVE_KNOBS):
        monkeypatch.delenv(knob, raising=False)
    _reset_both()
    yield
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    _reset_both()
    log.set_verbose(0)


def _reset_both():
    obs._reset_for_tests()
    jobs._reset_for_tests()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp if ln.strip()]


def _arm(monkeypatch, **env):
    for key, val in env.items():
        monkeypatch.setenv(key, str(val))
    _reset_both()


# ------------------------------------------------------------- alerts
ALERT_SPECS = [
    "hot@slo.p99_ms>50:cooldown=0",
    "cold@tenant.shed_rate<0.5:cooldown=0:severity=crit",
    "spike@perf.mfu:z=2:cooldown=0",
    "slow@slo.p99_ms>10:for=2:cooldown=5",
]


@pytest.mark.parametrize("spec", ALERT_SPECS)
def test_alert_rules_evaluate_as_the_jax_package(spec):
    """The same gauge series at the same clock through both packages'
    parsed rules: every breach verdict, its detail, and the rule state
    after each sample are equal."""
    mine, theirs = alerts._parse(spec), jalerts._parse(spec)
    assert sorted(mine) == sorted(theirs)
    rng = np.random.default_rng(3)
    series = np.concatenate([rng.uniform(0, 100, 40), [400.0, 0.0, 600.0, 1.0]])
    for gauge in mine:
        for t, v in enumerate(series):
            for a, b in zip(mine[gauge], theirs[gauge]):
                a.observe(float(v), float(t))
                b.observe(float(v), float(t))
                assert a.doc() == b.doc()
                assert (a.n, a.mean, a.var, a.breach_since) == \
                    (b.n, b.mean, b.var, b.breach_since)
        assert any(r.fired for r in mine[gauge])


# -------------------------------------------------------------- drift
def test_drift_sketches_match_the_jax_package(monkeypatch, tmp_path):
    """Seeded ingest rows, predictions and eval losses (with a shift
    half-way) through both packages' armed drift planes: the sketch
    documents and the health verdicts are equal."""
    docs = []
    for pkg, mod, sink in ((obs, drift, "p.jsonl"), (jobs, jdrift, "j.jsonl")):
        _arm(monkeypatch, HPNN_DRIFT="1", HPNN_DRIFT_WINDOW="32",
             HPNN_METRICS=str(tmp_path / sink))
        rng = np.random.RandomState(11)
        for i in range(12):
            loc = 4.0 if i >= 6 else 0.0
            mod.note_ingest(rng.normal(loc, 1.0, size=(16, 6)))
            out = rng.uniform(-1, 0, size=(16, 3))
            out[:, 2 if i >= 6 else 0] = 1.0
            mod.note_pred("k", out)
            mod.note_eval("k", 0.1 + (0.5 if i >= 9 else 0.0) + 0.01 * i)
        pkg.flush()
        docs.append((mod.sketch_doc(), mod.health_doc(),
                     [(r["ev"], r.get("detector"), r.get("value"))
                      for r in _read(tmp_path / sink)
                      if r["ev"] in ("drift.score", "online.drift")]))
    assert docs[0] == docs[1]
    assert docs[0][1]["over"]            # the shift breached


# -------------------------------------------------------------- blame
def _span_records(seed, n_roots=24):
    """Seeded request trees: queue, dispatch, retries and sheds under
    each ``serve.request`` root, children emitted before their root."""
    rng = np.random.RandomState(seed)
    recs, sid = [], 1
    for i in range(n_roots):
        root = sid + 1000
        t0, total = float(i), float(rng.uniform(1, 5))
        t = t0
        for name, failed in (("serve.queue", None), ("serve.dispatch", None),
                             ("serve.retry", "Shed" if i % 5 == 0 else None),
                             ("router.spill", None)):
            if rng.uniform() < 0.2:
                continue
            dt = float(rng.uniform(0.0, total / 4))
            rec = {"ev": "span.end", "kind": "event", "span": sid,
                   "parent": root, "name": name, "t0": t, "dt": dt}
            if failed:
                rec["failed"] = failed
            recs.append(rec)
            sid += 1
            t += dt
        recs.append({"ev": "span.end", "kind": "event", "span": root,
                     "parent": None, "name": "serve.request", "t0": t0,
                     "dt": total, "kernel": f"k{i % 3}"})
    return recs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_blame_split_matches_the_jax_package(monkeypatch, tmp_path, seed):
    recs = _span_records(seed)
    assert (blame.analyze([blame.normalize_record(r) for r in recs], top=5)
            == jblame.analyze([jblame.normalize_record(r) for r in recs], top=5))
    docs = []
    for mod in (blame, jblame):
        _arm(monkeypatch, HPNN_BLAME="1", HPNN_METRICS=str(tmp_path / "m.jsonl"))
        for r in recs:
            mod.note_record(dict(r))
        mod.flush()
        docs.append((mod.fleet_doc(), mod.kernel_doc(), mod.health_doc()))
    assert docs[0] == docs[1]
    assert docs[0][0]["roots"] == 24


# --------------------------------------------------------------- tune
def _sensor(phase="queue", pct=80.0, roots=32):
    pcts = {p: 0.0 for p in blame.PHASES}
    pcts[phase] = pct
    pcts["gap"] = 100.0 - sum(v for k, v in pcts.items() if k != "gap")
    return {"roots": roots, "pct": pcts}


# the verdict table of tests/test_tune.py: (sensor, burn, policy kwargs,
# now, last_apply_t, watch_active)
DECIDE_CASES = [
    (None, 3.0, {}, 0.0, None, False),
    (_sensor(roots=4), 3.0, {}, 0.0, None, True),
    (_sensor(roots=15), 3.0, {}, 0.0, None, False),
    (_sensor(), None, {}, 0.0, None, False),
    (_sensor(), 0.0, {}, 0.0, None, False),
    (_sensor(), 0.99, {}, 0.0, None, False),
    (_sensor(pct=39.9), 3.0, {}, 0.0, None, False),
    (_sensor(), 3.0, {"cooldown_s": 30.0}, 100.0, 80.0, False),
    (_sensor(), 3.0, {"cooldown_s": 30.0}, 120.0, 80.0, False),
    *[(_sensor(p), 3.0, {}, 0.0, None, False) for p in tune.RULE_OF],
    ({"roots": 32, "pct": {"queue": 45.0, "dispatch": 1.0, "spill": 0.0,
                           "shed_retry": 0.0, "other": 0.0, "gap": 54.0}},
     3.0, {}, 0.0, None, False),
]


@pytest.mark.parametrize("case", range(len(DECIDE_CASES)))
def test_tune_decide_matches_the_jax_package(case):
    sensor, burn, pol, now, last, watch = DECIDE_CASES[case]
    mine = tune.decide(sensor, burn, policy=tune.Policy(**pol), now=now,
                       last_apply_t=last, watch_active=watch)
    theirs = jtune.decide(sensor, burn, policy=jtune.Policy(**pol), now=now,
                          last_apply_t=last, watch_active=watch)
    assert mine == theirs
    assert mine["verdict"] in tune.engine.VERDICTS


def test_tune_tables_match_the_jax_package():
    assert tune.RULE_OF == jtune.RULE_OF and tune.ACTIONS == jtune.ACTIONS
    assert tune.engine.VERDICTS == jtune.engine.VERDICTS and tune.engine.DOWNSHIFT == jtune.engine.DOWNSHIFT
    env = {"HPNN_TUNE_DOMINANT_PCT": "55", "HPNN_TUNE_COOLDOWN_S": "7",
           "HPNN_TUNE_DRY": "1"}
    assert (tune.Policy.from_env(env).__dict__
            == jtune.Policy.from_env(env).__dict__)


# -------------------------------------------------------------- meter
@pytest.mark.parametrize("k", [2, 4, 16])
def test_meter_governor_matches_the_jax_package(monkeypatch, tmp_path, k):
    """A Zipf-headed tenant mix through both packages' armed meters:
    the governed top-K + ``_other`` export, the census and the gauge
    labels are equal, and every export conserves its axis total."""
    rng = np.random.RandomState(k)
    tenants = [f"t{i:02d}" for i in range(12)]
    w = 1.0 / np.arange(1, 13) ** 1.2
    picks = rng.choice(12, size=300, p=w / w.sum())
    docs = []
    for mod in (meter, jmeter):
        _arm(monkeypatch, HPNN_METER="1", HPNN_METER_TOPK=str(k),
             HPNN_METRICS=str(tmp_path / "m.jsonl"))
        for j, i in enumerate(picks):
            t = tenants[i]
            mod.note_request(t, 1 + j % 4)
            mod.note_dispatch(f"{t}:k", 1e-3 * (1 + j % 7))
            mod.note_queue(f"{t}:k", 1e-4 * (j % 5))
            if j % 11 == 0:
                mod.note_shed(t)
        census = mod.meterz_doc()
        census.pop("status", None)
        docs.append((mod.export_doc(), census,
                     [mod.tenant_label(t) for t in tenants]))
    assert docs[0] == docs[1]
    for axis, tops in docs[0][0].items():
        assert len(tops) <= k + 1
        assert sum(tops.values()) == pytest.approx(docs[0][1]["axes"][axis]["total"])


# ------------------------------------------------------ armed session
def _kernel(shape, seed=17):
    n_in, hid, n_out = SHAPES[shape]
    return km.generate(seed, n_in, list(hid), n_out)[0]


def _rows(shape, seed=5, n=24):
    rng = np.random.RandomState(seed)
    n_in = SHAPES[shape][0]
    return [rng.uniform(-1, 1, (1 + i % 4, n_in)) for i in range(n)]


def _armed_env(tmp_path, url=None, profile_ms="0"):
    env = {"HPNN_METRICS": str(tmp_path / "serve.jsonl"),
           "HPNN_ALERTS": "lat@slo.p99_ms>10000:cooldown=0",
           "HPNN_SAMPLE": "1", "HPNN_CAPSULE_DIR": str(tmp_path / "caps"),
           "HPNN_CAPSULE_PROFILE_MS": profile_ms,
           "HPNN_CAPSULE_COOLDOWN_S": "0", "HPNN_DRIFT": "1",
           "HPNN_BLAME": "1", "HPNN_METER": "1", "HPNN_TUNE": "1",
           "HPNN_TUNE_DRY": "1", "HPNN_SLO_MS": "1000"}
    if url:
        env.update(HPNN_COLLECTOR=url, HPNN_COLLECTOR_FLUSH_S="0.05")
    return env


def _answers(sess, xs):
    return [np.asarray(sess.infer("k", x)) for x in xs]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_plane_armed_answers_bitwise(monkeypatch, tmp_path, shape):
    k = _kernel(shape)
    xs = _rows(shape)
    plain = serve.Session(device="cpu", max_batch=8, n_buckets=2)
    plain.register_kernel("k", k)
    want = _answers(plain, xs)
    plain.close()
    _arm(monkeypatch, **_armed_env(tmp_path))
    armed = serve.Session(device="cpu", max_batch=8, n_buckets=2)
    armed.register_kernel("k", k)
    got = _answers(armed, xs)
    health = armed.health()
    armed.close()
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert all(health[p]["armed"] for p in ("alerts", "sampler", "capsules",
                                            "drift", "blame", "tune"))
    jsess = jserve.Session(max_batch=8, n_buckets=2)
    jsess.register_kernel("k", jkm.Kernel(tuple(np.asarray(w) for w in k.weights)))
    theirs = _answers(jsess, xs)
    jsess.close()
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(got, theirs))
    print(f"\n{shape}: max |port - hpnn_tpu| with every plane armed {err:.3e}")
    assert err <= TOL


def _health_and_docs(sess):
    server = serve.make_server(sess) if sess.__module__.startswith(
        "hpnn_tpu_torch") else jserve.make_server(sess)
    host, port = server.server_address[:2]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    out = {}
    try:
        cn = http.client.HTTPConnection(host, port, timeout=30)
        for path in ("/healthz", "/meterz", "/tunez"):
            cn.request("GET", path)
            resp = cn.getresponse()
            out[path] = (resp.status, json.loads(resp.read()))
        cn.request("POST", "/v1/capture", body=json.dumps({"reason": "probe"}))
        resp = cn.getresponse()
        out["/v1/capture"] = (resp.status, json.loads(resp.read()))
        cn.close()
    finally:
        server.shutdown()
        server.server_close()
    return out


def _keys(doc, depth=2):
    """The key tree of a JSON document, ``depth`` levels down (values
    that are per-run names, like kernel names, are not compared)."""
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in doc.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_health_and_plane_documents_have_the_jax_keys(monkeypatch, tmp_path,
                                                      shape):
    """``/healthz`` (and each plane's section), ``/meterz``, ``/tunez``
    and a capture's manifest, from both packages' armed sessions under
    the same load: the same keys."""
    k = _kernel(shape)
    xs = _rows(shape, n=40)
    docs = []
    for pkg in ("port", "jax"):
        sub = tmp_path / pkg
        sub.mkdir()
        _arm(monkeypatch, **_armed_env(sub))
        if pkg == "port":
            sess = serve.Session(device="cpu", max_batch=8, n_buckets=2)
            sess.register_kernel("k", k)
        else:
            sess = jserve.Session(max_batch=8, n_buckets=2)
            sess.register_kernel("k", jkm.Kernel(tuple(np.asarray(w)
                                                       for w in k.weights)))
        _answers(sess, xs)
        (obs if pkg == "port" else jobs).blame.flush()
        docs.append(_health_and_docs(sess))
        sess.close()
    mine, theirs = docs
    for path in ("/healthz", "/meterz", "/tunez", "/v1/capture"):
        assert mine[path][0] == theirs[path][0] == 200, path
    hm, hj = mine["/healthz"][1], theirs["/healthz"][1]
    assert sorted(hm) == sorted(hj)
    for plane in ("alerts", "sampler", "capsules", "drift", "blame", "tune", "slo"):
        assert _keys(hm[plane], 1) == _keys(hj[plane], 1), plane
    assert _keys(mine["/meterz"][1], 2) == _keys(theirs["/meterz"][1], 2)
    assert _keys(mine["/tunez"][1], 2) == _keys(theirs["/tunez"][1], 2)
    mm, mj = mine["/v1/capture"][1]["manifest"], theirs["/v1/capture"][1]["manifest"]
    assert sorted(mm) == sorted(mj)
    assert mm["files"] == mj["files"]


def test_capture_capsule_has_the_jax_layout(monkeypatch, tmp_path):
    """A ``POST /v1/capture`` capsule of the armed port session holds
    the JAX capsule's files, and its ``profile/`` window is a
    ``torch.profiler`` trace."""
    _arm(monkeypatch, **_armed_env(tmp_path, profile_ms="20"))
    sess = serve.Session(device="cpu", max_batch=8, n_buckets=2)
    sess.register_kernel("k", _kernel("8-6-2"))
    _answers(sess, _rows("8-6-2", n=40))
    docs = _health_and_docs(sess)
    sess.close()
    code, body = docs["/v1/capture"]
    assert code == 200
    cap = body["capsule"]
    assert sorted(os.listdir(cap)) == sorted(
        ["manifest.json", "spans.jsonl", "gauges.json", "health.json",
         "drift.json", "meter.json", "blame.json", "profile"])
    manifest = json.load(open(os.path.join(cap, "manifest.json")))
    assert manifest["profile"]["files"] >= 1 and "profile_refused" not in manifest
    assert json.load(open(os.path.join(cap, "profile", "trace.json")))["traceEvents"]
    assert [json.loads(ln) for ln in open(os.path.join(cap, "spans.jsonl"))]


def test_capsule_profile_window_refuses_while_profile_runs(monkeypatch, tmp_path):
    """``torch.profiler`` is one per process: a capsule taken while the
    ``--profile`` trace holds it records the refusal and nests nothing."""
    _arm(monkeypatch, HPNN_CAPSULE_DIR=str(tmp_path / "caps"),
         HPNN_CAPSULE_PROFILE_MS="10", HPNN_CAPSULE_COOLDOWN_S="0")
    with profiler.trace(str(tmp_path / "prof")):
        with pytest.raises(profiler.ProfilerBusy):
            with profiler.trace(str(tmp_path / "prof2")):
                pass
        manifest = obs.triggers.capture("busy")
    assert manifest["profile"] is None
    assert "another torch.profiler trace" in manifest["profile_refused"]
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    after = obs.triggers.capture("free")          # the slot came back
    assert after["profile"]["files"] >= 1


def test_collector_receives_the_port_records_in_process(monkeypatch, tmp_path):
    server = obs.collector.start_collector(host="127.0.0.1", port=0,
                                           path=str(tmp_path / "merged.jsonl"))
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        _arm(monkeypatch, **_armed_env(tmp_path, url=url))
        sess = serve.Session(device="cpu", max_batch=8, n_buckets=2)
        sess.register_kernel("k", _kernel("8-6-2"))
        _answers(sess, _rows("8-6-2", n=16))
        sess.close()
        obs.flush()
        obs.collector._reset_for_tests()      # drains the push queue
    finally:
        obs.collector.stop_collector(server)
    merged = _read(tmp_path / "merged.jsonl")
    assert any(r.get("ev") == "serve.request" for r in merged)
    assert {r.get("pid") for r in merged} == {os.getpid()}


# ---------------------------------------------------------- the tuner
def _compiled_session():
    sess = serve.Session(device="cpu", mode="compiled", max_batch=8, n_buckets=2,
                         start=True)
    sess.register_kernel("k", _kernel("8-6-2"))
    return sess


def _feed(phase, mod=blame, n=16):
    child = {"queue": "serve.batch.queue", "dispatch": "serve.dispatch",
             "spill": "serve.spill_reload", "shed_retry": "serve.retry"}[phase]
    for i in range(n):
        rec = {"span": 2 * i + 1, "parent": 2 * i + 2, "name": child,
               "t0": 0.0, "dt": 0.9}
        if phase == "shed_retry":
            rec["failed"] = "Shed"
        mod.note_record(rec)
        mod.note_record({"span": 2 * i + 2, "parent": None,
                         "name": "serve.request", "t0": 0.0, "dt": 1.0,
                         "kernel": "k"})


def _tuner(**kw):
    return tune.Tuner(kw.pop("session", None), policy=tune.Policy(),
                      clock=lambda: 0.0, p99_fn=lambda: 1.0,
                      burn_fn=lambda: 3.0, **kw)


def test_precision_down_captures_the_new_policy_and_rolls_back_bitwise(
        monkeypatch, tmp_path):
    _arm(monkeypatch, HPNN_BLAME="1", HPNN_METRICS=str(tmp_path / "m.jsonl"))
    _feed("dispatch")
    sess = _compiled_session()
    try:
        x = _rows("8-6-2", n=1)[0]
        before = np.asarray(sess.infer("k", x))
        v0 = sess.registry.get("k").version
        t = _tuner(session=sess)
        d = t.tick()
        assert d["verdict"] == "apply" and d["action"] == "precision_down"
        entry = sess.registry.get("k")
        assert entry.precision == "f32" and entry.version == v0 + 1
        keys = [key for key in sess.engine._compiled if key[1] == v0 + 1]
        assert sorted(key[4] for key in keys) == ["f32", "f32"]
        low = np.asarray(sess.infer("k", x))
        assert 0.0 < float(np.max(np.abs(low - before))) < 1e-5
        assert t.rollback("unit") == "precision_down"
        assert sess.registry.get("k").precision is None
        assert np.array_equal(np.asarray(sess.infer("k", x)), before)
    finally:
        sess.close()


def test_grow_buckets_swaps_the_menu_and_keeps_the_old_graphs(monkeypatch, tmp_path):
    _arm(monkeypatch, HPNN_BLAME="1", HPNN_METRICS=str(tmp_path / "m.jsonl"))
    _feed("spill")
    sess = _compiled_session()
    try:
        prior = tuple(sess.engine.buckets)
        n0 = sess.engine.compiled_count()
        t = _tuner(session=sess)
        assert t.tick()["action"] == "grow_buckets"
        assert len(sess.engine.buckets) == len(prior) + 1
        assert sess.engine.compiled_count() == n0      # nothing dropped
        x = _rows("8-6-2", n=1)[0][:1]
        out = np.asarray(sess.infer("k", x))           # the new small bucket
        assert sess.engine.compiled_count() == n0 + 1
        assert t.rollback("unit") == "grow_buckets"
        assert tuple(sess.engine.buckets) == prior
        assert np.array_equal(np.asarray(sess.infer("k", x)), out)
    finally:
        sess.close()


def test_quota_squeeze_needs_the_tenant_host(monkeypatch, tmp_path):
    """A plain Session wires no quota actuator; a TenantSession rebuilds
    its tuner over the quota enforcer, whose squeeze rolls back to the
    exact prior spec; scale_up has no autoscaler in the port."""
    _arm(monkeypatch, HPNN_BLAME="1", HPNN_TUNE="1", HPNN_TUNE_DRY="1",
         HPNN_METRICS=str(tmp_path / "m.jsonl"))
    from hpnn_tpu_torch.tenant import TenantSession

    plain = serve.Session(device="cpu", start=False)
    assert sorted(plain.tuner._actuators) == ["grow_buckets", "precision_down"]
    plain.close()
    host = TenantSession(device="cpu", start=False, tenants={
        "bronze": TenantSpec("bronze", "bronze", rate_rps=40.0)})
    assert sorted(host.tuner._actuators) == ["grow_buckets", "precision_down",
                                             "quota_squeeze"]
    host.close()
    _feed("shed_retry")
    quota = QuotaEnforcer({"bronze": TenantSpec("bronze", "bronze", rate_rps=40.0)})
    before = quota.spec("bronze")
    t = _tuner(quota=quota)
    d = t.tick()
    assert d["verdict"] == "apply" and d["action"] == "quota_squeeze"
    assert quota.spec("bronze").rate_rps == pytest.approx(20.0)
    assert t.rollback("unit") == "quota_squeeze"
    assert quota.spec("bronze") == before
    blame._reset_for_tests()
    _arm(monkeypatch, HPNN_BLAME="1")
    _feed("queue")
    assert _tuner().tick()["verdict"] == "no_actuator"


def test_a_shed_storm_on_the_tenant_host_answers_differently_by_package(
        monkeypatch, tmp_path):
    """The same shed storm through both packages' ``TenantSession``:
    the port's host rebuilds its tuner over its quota, so the storm
    applies ``quota_squeeze``; the JAX host sets its quota after
    ``Session.__init__`` built the tuner, so the same storm answers
    ``no_actuator`` (a fault of the reference, ROADMAP.md "Faults in
    the reference": the JAX ``Session`` says a host that owns a quota
    rebuilds its tuner).  Both answers are pinned side by side."""
    from hpnn_tpu import tenant as jtenant
    from hpnn_tpu_torch.tenant import TenantSession

    _arm(monkeypatch, HPNN_BLAME="1", HPNN_TUNE="1", HPNN_TUNE_DRY="0",
         HPNN_METRICS=str(tmp_path / "m.jsonl"))
    mine = TenantSession(device="cpu", start=False, tenants={
        "bronze": TenantSpec("bronze", "bronze", rate_rps=40.0)})
    theirs = jtenant.TenantSession(start=False, tenants={
        "bronze": jtenant.TenantSpec("bronze", "bronze", rate_rps=40.0)})
    try:
        verdicts = []
        for host, mod in ((mine, blame), (theirs, jblame)):
            _feed("shed_retry", mod=mod)
            t = host.tuner
            t._clock, t._p99_fn, t._burn_fn = (lambda: 0.0), (lambda: 1.0), (lambda: 3.0)
            verdicts.append(t.tick())
        assert verdicts[0]["verdict"] == "apply"
        assert verdicts[0]["action"] == "quota_squeeze"
        assert verdicts[1]["verdict"] == "no_actuator"
        assert mine.quota.spec("bronze").rate_rps == pytest.approx(20.0)
        assert theirs.quota.spec("bronze").rate_rps == pytest.approx(40.0)
    finally:
        mine.close()
        theirs.close()


# ----------------------------------------------------------- the lint
def test_catalog_lint_passes_on_the_port_sink(monkeypatch, tmp_path):
    """The port's armed serve run (tail sampler, drift, meter, blame and
    a live tuner that applies and rolls back) writes a sink that
    ``check_obs_catalog.py`` accepts with --forensics, --drift, --meter
    and --tune."""
    cat = _tool("check_obs_catalog")
    env = _armed_env(tmp_path)
    env.update(HPNN_TUNE_DRY="0", HPNN_DRIFT_WINDOW="16")
    _arm(monkeypatch, **env)
    sess = _compiled_session()
    try:
        rng = np.random.RandomState(9)
        for i in range(64):
            x = rng.normal(4.0 if i >= 32 else 0.0, 1.0, (1 + i % 3, 8))
            sess.infer("k", x)
        obs.triggers.capture("lint")
        obs.blame.flush()
        _feed("spill", n=16)
        sess.tuner.stop()
        t = tune.Tuner(sess, policy=tune.Policy(), clock=lambda: 0.0,
                       p99_fn=lambda: 1.0, burn_fn=lambda: 3.0)
        assert t.tick()["verdict"] == "apply"
        assert t.rollback("unit") == "grow_buckets"
    finally:
        sess.close()
    obs.flush()
    sink = str(tmp_path / "serve.jsonl")
    names = {r["ev"] for r in _read(sink)}
    assert {"tune.apply", "tune.rollback", "drift.score", "meter.sketch",
            "forensics.capture_done"} <= names
    for flag, fn in (("--forensics", cat.lint_forensics), ("--drift", cat.lint_drift),
                     ("--meter", cat.lint_meter), ("--tune", cat.lint_tune)):
        assert fn(sink) == [], flag
        assert cat.main([flag, sink]) == 0, flag


# ------------------------------------------------------------ the CLI
def test_serve_nn_takes_sample_and_capsule_dir(monkeypatch, tmp_path, capsys):
    """``--sample``/``--capsule-dir`` arm their planes (the JAX CLI's
    twins of ``HPNN_SAMPLE``/``HPNN_CAPSULE_DIR``); ``-h`` then stops
    before a server binds."""
    caps = str(tmp_path / "caps")
    assert serve_nn.main(["--device", "cpu", "--sample", "0.5",
                          "--capsule-dir", caps, "-h"]) == 0
    assert os.environ["HPNN_SAMPLE"] == "0.5"
    assert os.environ["HPNN_CAPSULE_DIR"] == caps
    assert obs.forensics.enabled() and obs.triggers.health_doc()["armed"]
    assert "usage:" in capsys.readouterr().out
