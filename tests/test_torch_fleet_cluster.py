"""The port's serving fleet (``hpnn_tpu_torch/fleet/``) held against the
JAX package's (``hpnn_tpu/fleet/``) case for case, on the CPU.

* the autoscaler's pure decision core, ``Policy`` (and its 13
  ``HPNN_FLEET_*`` knobs) and the control loop: every case of
  ``tests/test_fleet_cluster.py`` run on BOTH packages with the same
  inputs, plus a sweep on which the two ``decide`` agree;
* the in-process cluster (real HTTP workers in this process) on port
  sessions (``device="cpu"``, float64 parity mode): answers bitwise the
  port's per-row forward and within 4.4e-16 of the JAX cluster's on the
  same kernels (the two packages' ``exp`` differ in the last bit on some
  inputs), the ``make_server`` edge answering route for route as a JAX
  ``ClusterRouter`` edge does, and the fenced install old-or-new;
* the OS-process fleet: two REAL port ``online_nn`` worker processes
  (``--device cpu``) under a ``WorkerSupervisor`` sharing one promotion
  WAL — admission, the ``--cluster`` lint of the supervisor's sink,
  ``{rank}`` sinks, the fenced install across processes (each worker's
  reload captures on its trainer thread), the collector, crash reap and
  replace (the replacement restores the last WAL version bitwise), and
  the SIGTERM drain.  The JAX package's own copies of these six fail on
  this box (its supervisor gives its workers no ``PYTHONPATH``); the
  port's supervisor puts the checkout first on it;
* the refusals: ``HPNN_COMPILE_CACHE_DIR`` (the port has no compile
  cache), a worker that cannot start, a worker left on ``cuda``;
* the tuner's ``scale_up`` actuator over a fleet with an autoscaler.

Every process test runs under its own time limit (``_time_limit``), so
no hung worker holds the suite.
"""

import contextlib
import http.client
import importlib.util
import json
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from hpnn_tpu import fleet as jfleet
from hpnn_tpu import obs as jobs
from hpnn_tpu import serve as jserve
from hpnn_tpu.fileio import checkpoint as jckpt
from hpnn_tpu_torch import fleet, obs, runtime, serve, tune
from hpnn_tpu_torch.fileio import checkpoint
from hpnn_tpu_torch.fleet.router import CheckpointPublisher
from hpnn_tpu_torch.models import ann
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.obs import blame
from hpnn_tpu_torch.online import wal as wal_mod
from hpnn_tpu_torch.serve import compile_cache, conn
from hpnn_tpu_torch.serve.batcher import Shed

ROOT = os.path.join(os.path.dirname(__file__), "..")

CONF = ("[name] drill\n[type] ANN\n[init] generate\n[seed] 7\n"
        "[input] 8\n[hidden] 5\n[output] 2\n[train] BP\n")

# the two packages' forwards differ by at most this on these kernels
# (measured 2.2e-16: the last bit of exp on some inputs)
CROSS_TOL = 4.4e-16


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """Clear the knobs and the memos around each test, and leave the
    environment as the test found it: a ``configure`` exports its knob
    (``HPNN_BLAME``, ``HPNN_METRICS``), which would arm the next test's
    registry in this process."""
    env = dict(os.environ)
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, "HPNN_WAL_DIR",
                 "HPNN_TUNE", "HPNN_BLAME", "HPNN_SERVE_MODE",
                 "HPNN_SERVE_DTYPE", "HPNN_DTYPE", "HPNN_SERVE_RATE_CAP",
                 *(k for k, _f, _c in fleet.Policy._ENV_FIELDS)):
        monkeypatch.delenv(knob, raising=False)
    _reset()
    yield
    for knob in set(os.environ) - set(env):
        del os.environ[knob]
    os.environ.update(env)
    _reset()


def _reset():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    obs.slo._reset_for_tests()
    conn._reset_for_tests()
    compile_cache._reset_for_tests()
    wal_mod._reset_for_tests()
    blame._reset_for_tests()
    tune._reset_for_tests()


@contextlib.contextmanager
def _time_limit(seconds, what):
    """Raise ``TimeoutError`` in this (main) thread after ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"{what} took more than {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _kernel(seed=7, n_in=8, hiddens=(5,), n_out=2):
    return km.generate(seed, n_in, list(hiddens), n_out)[0]


def _ref(k, X):
    """The port's per-row forward: what its parity mode answers."""
    ws = [torch.from_numpy(np.asarray(w)) for w in k.weights]
    return np.stack([ann.run(ws, torch.from_numpy(np.asarray(x))).numpy()
                     for x in np.atleast_2d(X)])


def _read_sink(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp if ln.strip()]


def _load_catalog_tool():
    spec = importlib.util.spec_from_file_location(
        "check_obs_catalog",
        os.path.join(ROOT, "tools", "check_obs_catalog.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ================================================== pure decision core
PKGS = {"jax": types.SimpleNamespace(fleet=jfleet, obs=jobs),
        "port": types.SimpleNamespace(fleet=fleet, obs=obs)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _p(pkg, **kw):
    base = dict(min_width=1, max_width=4, up_outstanding=8.0,
                down_outstanding=1.0, up_burn=1.0, down_burn=0.5,
                up_step=2, down_step=1, up_cooldown_s=3.0,
                down_cooldown_s=15.0, down_for_s=5.0)
    base.update(kw)
    return pkg.fleet.Policy(**base)


def test_decide_scales_up_fast_on_queue_depth(pkg):
    w, reason = pkg.fleet.decide([(10.0, 12.0, 0.0, None)], width=1,
                                 policy=_p(pkg), now=10.0)
    assert (w, reason) == (3, "queue")


def test_decide_burn_dominates_queue_depth(pkg):
    w, reason = pkg.fleet.decide([(0.0, 0.0, 0.0, 2.0)], width=1,
                                 policy=_p(pkg), now=0.0)
    assert (w, reason) == (3, "burn")
    _w, reason = pkg.fleet.decide([(0.0, 50.0, 0.0, 2.0)], width=1,
                                  policy=_p(pkg), now=0.0)
    assert reason == "burn"


def test_decide_shed_triggers_up(pkg):
    samples = [(0.0, 0.5, 0.0, None), (1.0, 0.5, 3.0, None)]
    w, reason = pkg.fleet.decide(samples, width=2, policy=_p(pkg), now=1.0)
    assert (w, reason) == (4, "shed")


def test_decide_up_clamps_at_max_width(pkg):
    w, reason = pkg.fleet.decide([(0.0, 99.0, 0.0, None)], width=3,
                                 policy=_p(pkg, max_width=4), now=0.0)
    assert (w, reason) == (4, "queue")
    w, reason = pkg.fleet.decide([(0.0, 99.0, 0.0, None)], width=4,
                                 policy=_p(pkg, max_width=4), now=0.0)
    assert (w, reason) == (4, "queue_at_max")


def test_decide_up_cooldown_blocks_thrash(pkg):
    w, reason = pkg.fleet.decide([(10.0, 99.0, 0.0, None)], width=2,
                                 policy=_p(pkg, up_cooldown_s=3.0), now=10.0,
                                 last_up_t=8.5)
    assert (w, reason) == (2, "queue_cooldown")
    w, _ = pkg.fleet.decide([(12.0, 99.0, 0.0, None)], width=2,
                            policy=_p(pkg, up_cooldown_s=3.0), now=12.0,
                            last_up_t=8.5)
    assert w == 4


def test_decide_down_requires_sustained_calm(pkg):
    pol = _p(pkg, down_for_s=5.0, down_cooldown_s=0.1)
    decide = pkg.fleet.decide
    calm = [(t, 0.2, 0.0, None) for t in range(0, 11)]
    assert decide(calm[-3:], width=3, policy=pol, now=10.0) == (3, "calm_unproven")
    assert decide(calm, width=3, policy=pol, now=10.0) == (2, "calm")
    dirty = calm[:-2] + [(9.0, 0.2, 1.0, None), (10.0, 0.2, 0.0, None)]
    assert decide(dirty, width=3, policy=pol, now=10.0) == (4, "shed")
    busy = [(float(t), 4.0, 0.0, None) for t in range(0, 11)]
    assert decide(busy, width=3, policy=pol, now=10.0) == (3, "steady")


def test_decide_down_cooldown_and_min_clamp(pkg):
    pol = _p(pkg, down_for_s=2.0, down_cooldown_s=15.0)
    decide = pkg.fleet.decide
    calm = [(float(t), 0.0, 0.0, None) for t in range(0, 11)]
    assert decide(calm, width=2, policy=pol, now=10.0,
                  last_down_t=5.0) == (2, "down_cooldown")
    assert decide(calm, width=2, policy=pol, now=10.0,
                  last_up_t=5.0) == (2, "down_cooldown")
    assert decide(calm, width=1, policy=pol, now=10.0) == (1, "steady")


def test_decide_burn_vetoes_scale_down(pkg):
    pol = _p(pkg, down_for_s=2.0, down_cooldown_s=0.1, down_burn=0.5)
    warm = [(float(t), 0.0, 0.0, 0.8) for t in range(0, 11)]
    assert pkg.fleet.decide(warm, width=3, policy=pol, now=10.0) == (3, "burn_veto")


def test_policy_from_env(pkg):
    Policy = pkg.fleet.Policy
    env = {"HPNN_FLEET_MIN": "2", "HPNN_FLEET_MAX": "6",
           "HPNN_FLEET_UP_BURN": "1.5", "HPNN_FLEET_DOWN_COOLDOWN_S": "30"}
    pol = Policy.from_env(env)
    assert (pol.min_width, pol.max_width) == (2, 6)
    assert pol.up_burn == 1.5 and pol.down_cooldown_s == 30.0
    assert pol.up_step == 2
    assert Policy.from_env(env, max_width=9).max_width == 9
    with pytest.raises(ValueError):
        Policy.from_env({"HPNN_FLEET_MAX": "lots"})
    with pytest.raises(ValueError):
        Policy.from_env({"HPNN_FLEET_MIN": "5", "HPNN_FLEET_MAX": "2"})


def test_decide_edge_inputs(pkg):
    decide = pkg.fleet.decide
    assert decide([], width=2, policy=_p(pkg), now=0.0) == (2, "no_data")
    assert decide([(0.0, 0.0, 0.0, None)], width=0, policy=_p(pkg),
                  now=0.0) == (1, "below_min")
    w, _reason = decide([{"t": 0.0, "outstanding": 99.0, "shed": 0, "burn": None}],
                        width=1, policy=_p(pkg), now=0.0)
    assert w == 3


def _ramp(slope, n=4, t0=0.0, base=0.5):
    return [(t0 + t, base + slope * t, 0.0, None) for t in range(n)]


@pytest.mark.parametrize("case", ["fires", "off_by_default", "two_points",
                                  "narrow", "shallow"])
def test_decide_slope_trigger(pkg, case):
    """The predictive ramp trigger: fires below the level thresholds,
    is off by default, and needs >= 3 points over half its window and a
    ramp past ``up_slope``."""
    pol = _p(pkg, up_slope=1.0, slope_for_s=3.0)
    samples, want = {
        "fires": (_ramp(2.0), (3, "slope")),
        "off_by_default": (_ramp(2.0), (1, "steady")),
        "two_points": (_ramp(2.0, n=2, t0=2.0), (1, "steady")),
        "narrow": ([(2.4, 0.5, 0.0, None), (2.7, 1.1, 0.0, None),
                    (3.0, 1.7, 0.0, None)], (1, "steady")),
        "shallow": (_ramp(0.4), (1, "steady")),
    }[case]
    if case == "off_by_default":
        pol = _p(pkg)
    assert pkg.fleet.decide(samples, width=1, policy=pol, now=3.0) == want


def test_decide_slope_loses_to_level_triggers(pkg):
    pol = _p(pkg, up_slope=0.1, slope_for_s=3.0)
    hot = [(t, 9.0 + t, 0.0, None) for t in range(4)]
    assert pkg.fleet.decide(hot, width=1, policy=pol, now=3.0)[1] == "queue"
    burning = [(t, 0.5 + 2.0 * t, 0.0, 2.0) for t in range(4)]
    assert pkg.fleet.decide(burning, width=1, policy=pol, now=3.0)[1] == "burn"


def test_slope_policy_from_env(pkg):
    Policy = pkg.fleet.Policy
    pol = Policy.from_env({"HPNN_FLEET_UP_SLOPE": "1.5",
                           "HPNN_FLEET_SLOPE_FOR_S": "4"})
    assert pol.up_slope == 1.5 and pol.slope_for_s == 4.0
    assert Policy.from_env({}).up_slope == 0.0
    with pytest.raises(ValueError):
        Policy.from_env({"HPNN_FLEET_UP_SLOPE": "-1"})
    with pytest.raises(ValueError):
        Policy.from_env({"HPNN_FLEET_SLOPE_FOR_S": "0"})


def test_policy_knobs_and_defaults_equal_the_jax_package():
    """The same 13 knobs, fields and defaults (``hpnn_tpu/config.py``)."""
    import dataclasses

    assert fleet.Policy._ENV_FIELDS == jfleet.Policy._ENV_FIELDS
    assert len(fleet.Policy._ENV_FIELDS) == 13
    assert dataclasses.asdict(fleet.Policy()) == dataclasses.asdict(jfleet.Policy())
    env = {k: str(i + 2) for i, (k, _f, _c) in enumerate(fleet.Policy._ENV_FIELDS)}
    env["HPNN_FLEET_MIN"], env["HPNN_FLEET_MAX"] = "1", "9"
    assert (dataclasses.asdict(fleet.Policy.from_env(env))
            == dataclasses.asdict(jfleet.Policy.from_env(env)))


def test_decide_agrees_across_packages_on_a_sweep():
    """Seeded random windows, widths, clocks and policies: both
    packages' ``decide`` give the same (width, reason)."""
    rng = np.random.RandomState(14)
    for _ in range(400):
        n = int(rng.randint(0, 8))
        t = np.sort(rng.uniform(0.0, 12.0, n))
        samples = [(float(t[i]), float(rng.choice([0.0, 0.5, 3.0, 12.0])),
                    float(rng.choice([0.0, 0.0, 2.0])),
                    rng.choice([None, 0.2, 0.7, 1.5]))
                   for i in range(n)]
        kw = dict(min_width=1, max_width=int(rng.randint(1, 6)),
                  up_step=int(rng.randint(1, 3)),
                  up_slope=float(rng.choice([0.0, 0.5])),
                  down_for_s=float(rng.choice([2.0, 5.0])),
                  down_cooldown_s=float(rng.choice([0.1, 15.0])))
        call = dict(width=int(rng.randint(0, 6)), now=12.0,
                    last_up_t=rng.choice([None, 10.0]),
                    last_down_t=rng.choice([None, 2.0]))
        got = fleet.decide(samples, policy=fleet.Policy(**kw), **call)
        want = jfleet.decide(samples, policy=jfleet.Policy(**kw), **call)
        assert got == want, (samples, kw, call)


# ============================================= control loop (no procs)
class _FakeSupervisor:
    def __init__(self):
        self._ranks = [0]
        self._next = 1
        self.spawned = 0
        self.drained: list = []

    def replace_dead(self):
        return []

    def width(self):
        return len(self._ranks)

    def ranks(self):
        return sorted(self._ranks)

    def spawn(self):
        self._ranks.append(self._next)
        self._next += 1
        self.spawned += 1

    def drain_and_kill(self, rank, **kw):
        self._ranks.remove(rank)
        self.drained.append(rank)


def test_autoscaler_loop_scales_up_then_down(pkg, tmp_path):
    sup = _FakeSupervisor()
    clock_now = [0.0]
    signal_now = [(20.0, 0.0, None)]
    scaler = pkg.fleet.Autoscaler(
        sup, router=None,
        policy=_p(pkg, max_width=3, up_step=2, up_cooldown_s=1.0,
                  down_for_s=3.0, down_cooldown_s=5.0),
        signals=lambda: signal_now[0], clock=lambda: clock_now[0])
    sink = tmp_path / "scale.jsonl"
    pkg.obs.configure(str(sink))
    try:
        assert scaler.tick() == (3, "queue")
        assert sup.spawned == 2
        signal_now[0] = (0.0, 0.0, None)
        for t in range(1, 12):
            clock_now[0] = float(t)
            scaler.tick()
        assert sup.width() == 1
        assert sup.drained == [2, 1]
    finally:
        pkg.obs.configure(None)
    recs = _read_sink(sink)
    ups = [r for r in recs if r["ev"] == "fleet.scale_up"]
    downs = [r for r in recs if r["ev"] == "fleet.scale_down"]
    assert len(ups) == 1 and (ups[0]["from_width"], ups[0]["to_width"],
                              ups[0]["reason"]) == (1, 3, "queue")
    assert [d["to_width"] for d in downs] == [2, 1]
    assert _load_catalog_tool().lint_cluster(str(sink)) == []


def test_autoscaler_request_up_down_external_pushes(pkg, tmp_path):
    sup = _FakeSupervisor()
    clock_now = [10.0]
    scaler = pkg.fleet.Autoscaler(sup, router=None,
                                  policy=_p(pkg, max_width=3, up_step=1,
                                            up_cooldown_s=5.0),
                                  signals=lambda: (20.0, 0.0, None),
                                  clock=lambda: clock_now[0])
    sink = tmp_path / "push.jsonl"
    pkg.obs.configure(str(sink))
    try:
        assert scaler.request_up(reason="tune:queue") == (1, 2)
        assert scaler.tick()[1] == "queue_cooldown"
        assert scaler.request_up(reason="tune:queue") == (2, 3)
        assert scaler.request_up(reason="tune:queue") is None
        assert scaler.request_down(1, reason="tune:rollback") == (3, 1)
        assert sup.width() == 1 and sup.drained == [2, 1]
        assert scaler.request_down(1, reason="tune:rollback") is None
    finally:
        pkg.obs.configure(None)
    recs = _read_sink(sink)
    assert [(u["from_width"], u["to_width"], u["reason"]) for u in recs
            if u["ev"] == "fleet.scale_up"] == [(1, 2, "tune:queue"),
                                                (2, 3, "tune:queue")]
    assert [(d["from_width"], d["to_width"], d["reason"]) for d in recs
            if d["ev"] == "fleet.scale_down"] == [(3, 1, "tune:rollback")]
    assert _load_catalog_tool().lint_cluster(str(sink)) == []


# ===================================== in-process fleet (HTTP workers)
def _start_inproc_fleet(tmp_path, *, package="port", n=2, seed=7):
    """N real ``make_server`` workers in this process (threads, real
    HTTP) of one package, over one checkpoint file, behind that
    package's ``ClusterRouter``."""
    k = _kernel(seed=seed)
    path = os.path.join(str(tmp_path), f"fleet-{package}.ckpt")
    if package == "port":
        checkpoint.dump_checkpoint(path, "V", k.weights, version=1, meta={})
        make = lambda: serve.Session(max_batch=16, max_wait_ms=0.5, device="cpu")  # noqa: E731
        srv_mod, fl_mod, pub_cls = serve, fleet, CheckpointPublisher
    else:
        jckpt.dump_checkpoint(path, "V", k.weights, version=1, meta={})
        make = lambda: jserve.Session(max_batch=16, max_wait_ms=0.5)  # noqa: E731
        srv_mod, fl_mod = jserve, jfleet
        pub_cls = jfleet.router.CheckpointPublisher
    sessions, servers, handles = [], [], []
    for i in range(n):
        s = make()
        s.load_kernel("V", path)
        srv = srv_mod.make_server(s)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        sessions.append(s)
        servers.append(srv)
        handles.append(fl_mod.WorkerHandle(i, "127.0.0.1", srv.server_address[1]))
    pub = pub_cls({"V": path}, versions={"V": 1})
    router = fl_mod.ClusterRouter(workers=handles, publisher=pub)
    ns = types.SimpleNamespace(router=router, handles=handles, servers=servers,
                               sessions=sessions, publisher=pub, ckpt_path=path, k=k)

    def close():
        router.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for s in sessions:
            s.close()

    ns.close = close
    return ns


def test_cluster_round_trip_bitwise(tmp_path):
    """The port's cluster answers bitwise its per-row forward, and
    within CROSS_TOL of the JAX cluster over the same kernel."""
    fl = _start_inproc_fleet(tmp_path)
    jfl = _start_inproc_fleet(tmp_path, package="jax")
    try:
        rng = np.random.RandomState(3)
        vec = rng.uniform(-1, 1, 8)
        out = fl.router.infer("V", vec)
        assert out.shape == (2,)
        assert np.array_equal(out, _ref(fl.k, vec)[0])
        assert np.max(np.abs(out - np.asarray(jfl.router.infer("V", vec)))) <= CROSS_TOL
        for rows in (1, 3, 8):
            X = rng.uniform(-1, 1, (rows, 8))
            got = fl.router.infer("V", X)
            assert np.array_equal(got, _ref(fl.k, X))
            assert np.max(np.abs(got - np.asarray(jfl.router.infer("V", X)))) <= CROSS_TOL
        with pytest.raises(KeyError):
            fl.router.infer("nope", vec)
        with pytest.raises(KeyError):
            fl.router.ingest_hook("V", np.zeros((2, 8)), np.zeros((2, 2)))
    finally:
        fl.close()
        jfl.close()


def _edge_call(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    hdrs = dict(headers or {})
    payload = None
    if body is not None:
        payload = json.dumps(body)
        hdrs["Content-Type"] = "application/json"
    c.request(method, path, body=payload, headers=hdrs)
    r = c.getresponse()
    raw = r.read()
    c.close()
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = raw.decode("utf-8", "replace")
    return r.status, doc


EDGE_ROUTES = [
    ("GET", "/healthz", None, None),
    ("GET", "/readyz", None, None),
    ("GET", "/metrics", None, None),
    ("GET", "/connz", None, None),
    ("GET", "/tenantz", None, None),
    ("GET", "/meterz", None, None),
    ("GET", "/tunez", None, None),
    ("GET", "/nowhere", None, None),
    ("POST", "/v1/infer", {"kernel": "V", "inputs": [0.0] * 8}, None),
    ("POST", "/v1/infer", {"kernel": "V", "inputs": [0.0] * 8}, {"X-Tenant": "t1"}),
    ("POST", "/v1/infer", {"kernel": "nope", "inputs": [0.0] * 8}, None),
    ("POST", "/v1/infer", {"kernel": "V", "inputs": "x"}, None),
    ("POST", "/v1/reload", {"kernel": "V"}, None),
    ("POST", "/v1/reload", {"kernel": "nope"}, None),
    ("POST", "/v1/capture", {"reason": "probe"}, None),
    ("POST", "/ingest", {"inputs": [[0.0] * 8], "targets": [[0.0] * 2]}, None),
]


def test_cluster_is_session_shaped(tmp_path):
    """The census methods, and the port's ``make_server`` edge over the
    cluster answering each route with the status a JAX ClusterRouter
    edge answers it with (nothing raises in the handler)."""
    fl = _start_inproc_fleet(tmp_path)
    jfl = _start_inproc_fleet(tmp_path, package="jax")
    edges = []
    try:
        assert fl.router.kernels() == ["V"]
        assert fl.router.is_ready()
        doc = fl.router.health()
        assert doc["ready"] is True and doc["status"] == "ok"
        assert doc["cluster"]["n_workers"] == 2
        assert set(doc["workers"]) == {"w0", "w1"}
        assert all(w["ready"] is True and w["outstanding"] == 0
                   for w in doc["workers"].values())
        assert all(name.startswith(("w0/", "w1/")) for name in doc["batchers"])
        rdoc = fl.router.ready_doc()
        assert rdoc["ready"] is True and set(rdoc["workers"]) == {"w0", "w1"}
        for srv_mod, router in ((serve, fl.router), (jserve, jfl.router)):
            edge = srv_mod.make_server(router)
            threading.Thread(target=edge.serve_forever, daemon=True).start()
            edges.append(edge)
        port_edge, jax_edge = (e.server_address[1] for e in edges)
        for method, path, body, hdrs in EDGE_ROUTES:
            got, gdoc = _edge_call(port_edge, method, path, body, hdrs)
            want, _ = _edge_call(jax_edge, method, path, body, hdrs)
            assert got == want, (method, path, got, want, gdoc)
        status, body = _edge_call(port_edge, "POST", "/v1/infer",
                                  {"kernel": "V", "inputs": [0.0] * 8})
        assert status == 200
        assert np.array_equal(np.asarray(body["outputs"]), _ref(fl.k, np.zeros(8))[0])
    finally:
        for e in edges:
            e.shutdown()
            e.server_close()
        fl.close()
        jfl.close()


def test_cluster_routes_around_dead_worker(tmp_path):
    fl = _start_inproc_fleet(tmp_path)
    sink = str(tmp_path / "route.jsonl")
    try:
        fl.servers[0].shutdown()
        fl.servers[0].server_close()
        fl.sessions[0].close()
        obs.configure(sink)
        try:
            out = fl.router.infer("V", np.zeros(8))
        finally:
            obs.configure(None)
        assert np.array_equal(out, _ref(fl.k, np.zeros(8))[0])
        gone = [r for r in _read_sink(sink) if r["ev"] == "cluster.shed_around"]
        assert gone and gone[0]["rank"] == 0 and gone[0]["reason"] == "gone"
        obs.configure(sink)
        try:
            fl.router.infer("V", np.zeros(8))
        finally:
            obs.configure(None)
        routes = [r for r in _read_sink(sink) if r["ev"] == "cluster.route"]
        assert routes[-1]["rank"] == 1
    finally:
        fl.close()


def test_cluster_all_dead_raises_shed(tmp_path):
    """All workers gone: a retriable ``Shed(no_worker)`` (the JAX router
    lets the last ``WorkerGone`` escape; both are allowed by its test)."""
    fl = _start_inproc_fleet(tmp_path)
    try:
        for srv in fl.servers:
            srv.shutdown()
            srv.server_close()
        for s in fl.sessions:
            s.close()
        with pytest.raises(Shed) as exc:
            fl.router.infer("V", np.zeros(8))
        assert exc.value.reason == "no_worker"
        with pytest.raises(Shed) as exc:
            fleet.ClusterRouter(workers=[]).infer("V", np.zeros(8))
        assert exc.value.reason == "no_worker"
    finally:
        fl.close()


def test_cluster_install_fence_old_or_new_inproc(tmp_path):
    fl = _start_inproc_fleet(tmp_path)
    sink = str(tmp_path / "fence.jsonl")
    try:
        X = np.linspace(-1.0, 1.0, 24).reshape(3, 8)
        k_versions = [fl.k] + [_kernel(seed=s) for s in (11, 13, 17)]
        allowed = [_ref(k, X) for k in k_versions]
        stop = threading.Event()
        torn: list = []

        def infer_loop():
            while not stop.is_set():
                out = np.asarray(fl.router.infer("V", X, timeout_s=10.0))
                if not any(np.array_equal(out, a) for a in allowed):
                    torn.append(out)
                    return

        threads = [threading.Thread(target=infer_loop) for _ in range(4)]
        obs.configure(sink)
        try:
            for t in threads:
                t.start()
            for k_new in k_versions[1:]:
                time.sleep(0.05)
                fl.router.install_kernel("V", k_new)
            time.sleep(0.1)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            obs.configure(None)
        assert not torn, "torn read: an answer matched no version"
        final = allowed[-1]
        assert np.array_equal(fl.router.infer("V", X), final)
        for h in fl.handles:
            assert np.array_equal(h.infer("V", X), final)
        fences = [r for r in _read_sink(sink) if r["ev"] == "cluster.fence"]
        assert len(fences) == 3
        assert all(f["op"] == "install" and f["workers"] == 2 for f in fences)
    finally:
        fl.close()


# ================================================= the tuner's actuator
class _InprocSupervisor:
    """A supervisor whose workers are port Sessions behind real HTTP in
    this process: the shape ``ClusterRouter`` and ``Autoscaler`` need."""

    def __init__(self, path):
        self.path = path
        self.workers = {}
        self._next = 0

    def spawn(self):
        s = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=0.5, device="cpu")
        s.load_kernel("V", self.path)
        srv = serve.make_server(s)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        h = fleet.WorkerHandle(self._next, "127.0.0.1", srv.server_address[1])
        self.workers[self._next] = (s, srv, h)
        self._next += 1

    def drain_and_kill(self, rank, **kw):
        s, srv, h = self.workers.pop(rank)
        h.close()
        srv.shutdown()
        srv.server_close()
        s.close()

    def replace_dead(self):
        return []

    def width(self):
        return len(self.workers)

    def ranks(self):
        return sorted(self.workers)

    def handles(self):
        return [self.workers[r][2] for r in self.ranks()]

    def close(self):
        for r in self.ranks():
            self.drain_and_kill(r)


@pytest.mark.parametrize("with_autoscaler", [True, False])
def test_tuner_scale_up_grows_the_fleet(tmp_path, monkeypatch, with_autoscaler):
    """A queue-dominated tail over a fleet: with an autoscaler the
    tuner answers ``apply`` to ``scale_up`` and the fleet grows by one
    policy step; without one it answers ``no_actuator``."""
    path = str(tmp_path / "k.ckpt")
    checkpoint.dump_checkpoint(path, "V", _kernel().weights, version=1)
    monkeypatch.setenv("HPNN_TUNE", "1")
    tune._reset_for_tests()
    blame.configure("1", window=16)
    sup = _InprocSupervisor(path)
    sup.spawn()
    router = fleet.ClusterRouter(supervisor=sup)
    try:
        scaler = (fleet.Autoscaler(sup, router, policy=fleet.Policy(
            min_width=1, max_width=4, up_step=1)) if with_autoscaler else None)
        ids = iter(range(10**6))
        for _ in range(32):   # 32 request roots, 90% queue wait each
            root = f"r{next(ids)}"
            blame.note_record({"span": f"c{next(ids)}", "parent": root,
                               "name": "serve.queue_wait", "t0": 0.0, "dt": 0.9})
            blame.note_record({"span": root, "parent": None, "name": "serve.request",
                               "t0": 0.0, "dt": 1.0, "kernel": "V"})
        tuner = tune.for_session(router, autoscaler=scaler,
                                 policy=tune.Policy(cooldown_s=5.0, watch_s=2.0),
                                 p99_fn=lambda: 100.0, burn_fn=lambda: 3.0)
        d = tuner.tick()
        assert d["action"] == "scale_up"
        if with_autoscaler:
            assert d["verdict"] == "apply" and (d["target"], d["applied"]) == ("fleet", 2)
            assert sup.width() == 2 and len(router.workers()) == 2
            assert np.array_equal(router.infer("V", np.zeros(8)),
                                  _ref(_kernel(), np.zeros(8))[0])
        else:
            assert d["verdict"] == "no_actuator" and sup.width() == 1
    finally:
        router.close()
        sup.close()


# ========================================= OS-process fleet (accept.)
PROC_LIMIT_S = 120


@pytest.fixture(scope="module")
def proc_fleet(tmp_path_factory):
    """Two REAL port online_nn worker processes on the CPU under a
    WorkerSupervisor, sharing one promotion WAL, a live in-process
    collector, and {rank}-expanded metrics sinks."""
    from hpnn_tpu_torch.obs import collector as collector_mod

    workdir = str(tmp_path_factory.mktemp("proc_fleet"))
    conf_path = os.path.join(workdir, "nn.conf")
    with open(conf_path, "w") as fp:
        fp.write(CONF)
    wal_dir = os.path.join(workdir, "wal")
    k_seed = _kernel(seed=11)
    rec = wal_mod.PromotionWAL(wal_dir).commit("drill", k_seed.weights, version=1,
                                               reason="seed")
    coll_srv = collector_mod.start_collector()
    spawn_sink = os.path.join(workdir, "supervisor.jsonl")
    sup = fleet.WorkerSupervisor(
        conf_path, workdir=workdir, kind="online", wal_dir=wal_dir,
        collector=f"http://127.0.0.1:{coll_srv.server_address[1]}",
        args=("--device", "cpu", "--interval-s", "600"),
        ready_timeout_s=90.0, drain_timeout_s=20.0,
        env={"HPNN_COLLECTOR_FLUSH_S": "0.1",
             "HPNN_METRICS": os.path.join(workdir, "w{rank}.jsonl")})
    obs.configure(spawn_sink)
    try:
        with _time_limit(2 * PROC_LIMIT_S, "spawning two online_nn workers"):
            sup.spawn()
            sup.spawn()
    except BaseException:
        sup.close()
        collector_mod.stop_collector(coll_srv)
        raise
    finally:
        obs.configure(None)
    pub = CheckpointPublisher(wal_dir=wal_dir)
    router = fleet.ClusterRouter(supervisor=sup, publisher=pub)
    ns = types.SimpleNamespace(
        supervisor=sup, router=router, publisher=pub, wal_dir=wal_dir,
        ckpt_path=os.path.join(wal_dir, rec["ckpt"]), workdir=workdir,
        k_seed=k_seed, spawn_sink=spawn_sink, collector=coll_srv)
    yield ns
    with _time_limit(PROC_LIMIT_S, "closing the fleet"):
        router.close()
        sup.close()
        collector_mod.stop_collector(coll_srv)


def _ensure_width(fl, n=2):
    while fl.supervisor.width() < n:
        fl.supervisor.spawn()


def test_supervisor_admits_ready_workers(proc_fleet):
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "admission"):
        assert fl.supervisor.width() == 2
        handles = fl.supervisor.handles()
        assert [h.rank for h in handles] == [0, 1]
        assert all(h.ready() for h in handles)
        ups = [r for r in _read_sink(fl.spawn_sink) if r["ev"] == "fleet.worker_up"]
        assert {r["rank"] for r in ups} == {0, 1}
        assert len({r["port"] for r in ups}) == 2
        assert all(r["pid"] > 0 and r["spawn_s"] >= 0.0 and r["kind"] == "online"
                   for r in ups)
        assert _load_catalog_tool().lint_cluster(fl.spawn_sink) == []
        pids = set()
        for rank in (0, 1):
            sink = os.path.join(fl.workdir, f"w{rank}.jsonl")
            assert os.path.exists(sink), "per-worker {rank} sink missing"
            pids |= {r.get("pid") for r in _read_sink(sink) if r.get("pid")}
        assert len(pids) >= 2
        # the restored kernel: every worker serves the WAL's version 1
        X = np.linspace(-1.0, 1.0, 8)
        for h in handles:
            assert np.array_equal(np.asarray(h.infer("drill", X, timeout_s=10.0)),
                                  _ref(fl.k_seed, X)[0])


def test_cluster_round_trip_across_processes(proc_fleet):
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "round trip"):
        _ensure_width(fl)
        k_known = _kernel(seed=23)
        fl.router.install_kernel("drill", k_known)
        X = np.linspace(-1.0, 1.0, 24).reshape(3, 8)
        assert np.array_equal(np.asarray(fl.router.infer("drill", X, timeout_s=10.0)),
                              _ref(k_known, X))
        vec = np.linspace(-0.5, 0.5, 8)
        assert np.array_equal(np.asarray(fl.router.infer("drill", vec, timeout_s=10.0)),
                              _ref(k_known, vec)[0])


def test_fleet_promotion_fence_across_processes(proc_fleet):
    """Concurrent infers across two worker PROCESSES answer bitwise
    old-or-new weights, never torn, during a churning install sequence;
    every worker converges on the last version."""
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "fenced installs"):
        _ensure_width(fl)
        X = np.linspace(-1.0, 1.0, 24).reshape(3, 8)
        k_base = _kernel(seed=31)
        fl.router.install_kernel("drill", k_base)
        churn = [_kernel(seed=s) for s in (37, 41, 43)]
        allowed = [_ref(k, X) for k in [k_base] + churn]
        stop = threading.Event()
        torn, errors, served = [], [], [0]

        def infer_loop():
            while not stop.is_set():
                try:
                    out = np.asarray(fl.router.infer("drill", X, timeout_s=10.0))
                except Exception as exc:
                    errors.append(exc)
                    return
                if not any(np.array_equal(out, a) for a in allowed):
                    torn.append(out)
                    return
                served[0] += 1

        threads = [threading.Thread(target=infer_loop) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for k_new in churn:
                time.sleep(0.1)
                entry = fl.router.install_kernel("drill", k_new)
            time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors[0]
        assert not torn, "torn read across worker processes"
        assert served[0] > 0
        final = allowed[-1]
        assert np.array_equal(np.asarray(fl.router.infer("drill", X, timeout_s=10.0)),
                              final)
        for h in fl.supervisor.handles():
            assert np.array_equal(np.asarray(h.infer("drill", X, timeout_s=10.0)), final)
            doc = h.health()["online"]["kernels"]["drill"]
            assert doc["version"] == entry.version


def test_collector_covers_whole_fleet(proc_fleet):
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "collector"):
        _ensure_width(fl)
        for _ in range(4):
            fl.router.infer("drill", np.zeros(8), timeout_s=10.0)
        deadline = time.monotonic() + 10.0
        workers = {}
        while time.monotonic() < deadline:
            workers = fl.collector.collector.fleetz().get("workers", {})
            if len(workers) >= 2:
                break
            time.sleep(0.2)
        assert len(workers) >= 2, f"collector saw only {list(workers)}"


def test_crash_is_reaped_and_replaced(proc_fleet):
    """SIGKILL one worker: the router routes around it, the supervisor
    reaps and replaces it, and the replacement restores the last WAL
    version bitwise."""
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "crash and replace"):
        _ensure_width(fl)
        sink = os.path.join(fl.workdir, "crash.jsonl")
        victim, survivor = fl.supervisor.ranks()[:2]
        X = np.linspace(-1.0, 1.0, 8)
        before = np.asarray(fl.supervisor.workers[survivor].handle.infer(
            "drill", X, timeout_s=10.0))
        obs.configure(sink)
        try:
            fl.supervisor.kill9(victim)
            fl.supervisor.workers[victim].proc.wait(timeout=10)
            out = np.asarray(fl.router.infer("drill", X, timeout_s=10.0))
            assert np.array_equal(out, before)
            replaced = fl.supervisor.replace_dead()
            assert len(replaced) == 1 and fl.supervisor.width() == 2
            assert replaced[0].handle.ready()
        finally:
            obs.configure(None)
        recs = _read_sink(sink)
        downs = [r for r in recs if r["ev"] == "fleet.worker_down"]
        ups = [r for r in recs if r["ev"] == "fleet.worker_up"]
        assert downs and downs[0]["rank"] == victim and downs[0]["reason"] == "crash"
        assert ups and ups[0]["rank"] == replaced[0].rank
        assert np.array_equal(np.asarray(replaced[0].handle.infer(
            "drill", X, timeout_s=10.0)), before)
        last = max(r["version"] for r in wal_mod.PromotionWAL(fl.wal_dir).records()
                   if r["kernel"] == "drill")
        wal = replaced[0].handle.health()["online"]["wal"]
        assert wal["restored"] == {"drill": last}


def test_drain_and_kill_sigterm_exits_clean(proc_fleet):
    fl = proc_fleet
    with _time_limit(PROC_LIMIT_S, "drain"):
        _ensure_width(fl)
        sink = os.path.join(fl.workdir, "drain.jsonl")
        victim = fl.supervisor.ranks()[-1]
        obs.configure(sink)
        try:
            rc = fl.supervisor.drain_and_kill(victim)
        finally:
            obs.configure(None)
        assert rc == 0
        assert victim not in fl.supervisor.ranks()
        downs = [r for r in _read_sink(sink) if r["ev"] == "fleet.worker_down"]
        assert downs and downs[0]["rank"] == victim
        assert downs[0]["reason"] == "scale_down" and downs[0]["escalated"] is False
        out = fl.router.infer("drill", np.zeros(8), timeout_s=10.0)
        assert np.asarray(out).shape == (2,)


# ============================================================ refusals
@pytest.mark.parametrize("where", ["environ", "env", "cache_dir"])
def test_supervisor_refuses_a_compile_cache(tmp_path, monkeypatch, where):
    """``HPNN_COMPILE_CACHE_DIR`` from the caller's environment, the
    overlay or ``cache_dir=`` is refused when the supervisor is built,
    with the port's refusal message; no worker is spawned."""
    conf = tmp_path / "nn.conf"
    conf.write_text(CONF)
    kw = {}
    if where == "environ":
        monkeypatch.setenv("HPNN_COMPILE_CACHE_DIR", "xla_cache")
    elif where == "env":
        kw["env"] = {"HPNN_COMPILE_CACHE_DIR": "xla_cache"}
    else:
        kw["cache_dir"] = "xla_cache"
    with pytest.raises(NotImplementedError,
                       match="HPNN_COMPILE_CACHE_DIR=xla_cache selects XLA's persistent"):
        fleet.WorkerSupervisor(str(conf), workdir=str(tmp_path / "w"), **kw)
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("case", ["bad_conf", "cuda_without_a_card"])
def test_a_worker_that_cannot_start_raises_with_its_log(tmp_path, case):
    """A worker that exits before ready makes ``spawn`` raise with its
    log tail, and is not admitted: a conf with no kernel, or a worker
    left on ``cuda`` (the default) on a machine without one."""
    conf = tmp_path / "nn.conf"
    if case == "bad_conf":
        conf.write_text("[name] drill\n[type] ANN\n")
        args, want = ("--device", "cpu"), "FAILED to read NN configuration"
    else:
        conf.write_text(CONF)
        args, want = (), "CUDA is not available"
    sup = fleet.WorkerSupervisor(str(conf), workdir=str(tmp_path / "w"),
                                 kind="serve", args=args, ready_timeout_s=60.0)
    with _time_limit(PROC_LIMIT_S, "a failing spawn"):
        with pytest.raises(RuntimeError, match=want) as exc:
            sup.spawn()
    assert "before ready" in str(exc.value) and sup.width() == 0
    sup.close()


def test_worker_env_puts_the_checkout_on_pythonpath(tmp_path, monkeypatch):
    conf = tmp_path / "nn.conf"
    conf.write_text(CONF)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    sup = fleet.WorkerSupervisor(str(conf), workdir=str(tmp_path / "w"),
                                 env={"HPNN_METRICS": "m{rank}.jsonl"})
    env = sup._worker_env(3)
    first, rest = env["PYTHONPATH"].split(os.pathsep, 1)
    assert os.path.samefile(first, ROOT) and rest == "/elsewhere"
    assert env["HPNN_METRICS"] == "m3.jsonl"
    assert "HPNN_COMPILE_CACHE_DIR" not in env


def test_a_worker_binds_its_own_port_and_the_supervisor_reads_it(tmp_path):
    """Workers bind port 0 and the supervisor reads the port from the
    worker's own ``listening on`` line, past what an earlier run left in
    a reused log; two spawns may run at once."""
    conf = tmp_path / "nn.conf"
    conf.write_text(CONF)
    work = tmp_path / "w"
    work.mkdir()
    (work / "worker-r0.log").write_text("serve_nn: listening on 127.0.0.1:1\n")
    sup = fleet.WorkerSupervisor(str(conf), workdir=str(work), kind="serve",
                                 args=("--device", "cpu"), ready_timeout_s=60.0)
    try:
        with _time_limit(PROC_LIMIT_S, "two spawns at once"):
            threads = [threading.Thread(target=sup.spawn) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert sup.ranks() == [0, 1]
        ports = [sup.workers[r].port for r in sup.ranks()]
        assert 1 not in ports and len(set(ports)) == 2
        for h in sup.handles():
            assert h.port == sup.workers[h.rank].port and h.ready()
            out = h.infer("drill", np.zeros(8), timeout_s=10.0)
            assert np.asarray(out).shape == (2,)
    finally:
        with _time_limit(PROC_LIMIT_S, "closing"):
            sup.close()


def test_edge_readiness_is_asked_once_a_window(tmp_path):
    """A ready answer from the workers holds for ``READY_TTL_S``: the
    edge's per-request gate does not poll every worker's ``/readyz``;
    a lapsed window or a not-ready answer asks again."""
    fl = _start_inproc_fleet(tmp_path)
    now = [0.0]
    asked = []
    router = fleet.ClusterRouter(workers=fl.router.workers(), clock=lambda: now[0])
    ttl = fleet.router.READY_TTL_S
    try:
        for h in router.workers():
            ready = h.ready
            h.ready = lambda *a, _r=ready, _h=h, **kw: (asked.append(_h.rank), _r(*a, **kw))[1]
        assert router.is_ready() and len(asked) == 1
        now[0] = 0.9 * ttl
        assert router.is_ready() and len(asked) == 1
        now[0] = ttl
        assert router.is_ready() and len(asked) == 2
        router.mark_unready("drain")
        assert not router.is_ready() and len(asked) == 2
        router.mark_ready()
        for h in router.workers():
            h.ready = lambda *a, **kw: False
        now[0] = 2.5 * ttl
        assert not router.is_ready()
        assert not router.is_ready()
    finally:
        fl.close()
