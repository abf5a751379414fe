"""The port's serving stack (``hpnn_tpu_torch/serve``, ``cli/serve_nn``,
``tools/bench_serve``) on the CPU, held against the JAX package's.

* the bucket menu, ``fleet_key`` and ``quantize_weights`` are the JAX
  functions' bit for bit;
* parity mode (float64): ``Engine.dispatch`` agrees with ``hpnn_tpu``'s
  within 1e-12 and is bitwise the port's own per-row ``run``; fleet
  dispatch is bitwise per-kernel dispatch;
* compiled mode on the CPU (float64) agrees with ``hpnn_tpu``'s
  within 1e-12;
* bf16/int8 quant error stays inside docs/performance.md's bounds;
* one forward per (kernel, bucket) after warmup, through 64 concurrent
  requests; hot reload, evict, batcher semantics, a chaos fault, the
  router; ``serve_nn`` over HTTP; the refusals.

No test spawns a process.  Card-only cases live in test_torch_cuda.py.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from hpnn_tpu import obs as jobs
from hpnn_tpu import serve as jserve
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.serve import engine as jengine
from hpnn_tpu_torch import chaos, obs, runtime, serve
from hpnn_tpu_torch.cli import serve_nn
from hpnn_tpu_torch.models import ann, snn
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.serve import batcher as batcher_mod
from hpnn_tpu_torch.serve import compile_cache, conn, engine
from hpnn_tpu_torch.serve.registry import Registry
from hpnn_tpu_torch.tools import bench_serve

TOL = 1e-12
ROWS = (1, 3, 8, 13, 64, 100)
SHAPES = {"8-6-2": (8, (6,), 2), "784-300-10": (784, (300,), 10)}
# every knob the serve stack reads; each test starts with none set
SERVE_KNOBS = ("HPNN_CHAOS", "HPNN_CHAOS_SEED", "HPNN_SERVE_MODE",
               "HPNN_SERVE_DTYPE", "HPNN_SERVE_FLEET", "HPNN_SERVE_REPLICAS",
               "HPNN_SERVE_RATE_CAP", "HPNN_SHED_AGE_MS", "HPNN_SHED_P99_MS",
               "HPNN_CONN_HDR_MS", "HPNN_CONN_BODY_MS", "HPNN_CONN_PER_IP",
               "HPNN_CONN_MIN_BPS", "HPNN_CONN_TABLE", "HPNN_DTYPE")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """Clear every knob of both packages and forget their memos (obs,
    chaos, slo, conn, the forward-cache census) around each test."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, *SERVE_KNOBS):
        monkeypatch.delenv(knob, raising=False)
    _reset_all()
    yield
    _reset_all()


def _reset_all():
    obs._reset_for_tests()   # chains chaos, slo, propagate, lockwatch
    jobs._reset_for_tests()
    chaos._reset_for_tests()
    obs.slo._reset_for_tests()
    conn._reset_for_tests()
    compile_cache._reset_for_tests()


def _weights(shape, seed):
    """Seeded float64 layers of ``shape`` (n_in, hiddens, n_out)."""
    n_in, hiddens, n_out = shape
    rng = np.random.RandomState(seed)
    sizes = [n_in, *hiddens, n_out]
    return tuple(rng.uniform(-1.0, 1.0, (o, i)) / np.sqrt(i)
                 for i, o in zip(sizes[:-1], sizes[1:]))


def _kernels(shape, seed):
    """The same weights as a port Kernel and a JAX Kernel."""
    w = _weights(shape, seed)
    return km.Kernel(w), jkm.Kernel(tuple(a.copy() for a in w))


def _per_row(kernel, model, X):
    """The port's direct per-row ``run`` (float64, CPU)."""
    mod = snn if model == "snn" else ann
    w, _ = km.to_torch(kernel.weights, device="cpu", dtype=torch.float64)
    return np.stack([mod.run(w, torch.tensor(x)).numpy() for x in X])


def _read(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp if ln.strip()]


# ------------------------------------------------------------- pure functions
@pytest.mark.parametrize("max_batch", [1, 2, 3, 7, 8, 16, 33, 64, 100, 512])
@pytest.mark.parametrize("n_buckets", [1, 2, 4, 6, 12])
def test_bucket_menu_and_bucket_for_match_jax(max_batch, n_buckets):
    menu = engine.bucket_menu(max_batch, n_buckets)
    assert menu == jengine.bucket_menu(max_batch, n_buckets)
    for rows in range(1, 2 * max(menu) + 2):
        assert engine.bucket_for(menu, rows) == jengine.bucket_for(menu, rows)


@pytest.mark.parametrize("model", ["ann", "snn"])
@pytest.mark.parametrize("shape", [(8, (6,), 2), (8, (5, 4), 3), (16, (8,), 4)])
def test_fleet_key_matches_jax(model, shape):
    k, jk = _kernels(shape, 3)
    entry = Registry().register("k", k, model=model)
    jentry = jserve.Registry().register("k", jk, model=model)
    assert engine.fleet_key(entry) == jengine.fleet_key(jentry)


@pytest.mark.parametrize("bits", range(2, 9))
def test_quantize_weights_bitwise_jax(bits):
    w = _weights((16, (8,), 4), 5) + (np.zeros((2, 4)),)
    q, s = engine.quantize_weights(w, bits=bits)
    jq, js = jengine.quantize_weights(w, bits=bits)
    assert all(a.dtype == np.int8 and np.array_equal(a, b) for a, b in zip(q, jq))
    assert s == js
    with pytest.raises(ValueError):
        engine.quantize_weights(w, bits=1)


# ------------------------------------------------------------- parity mode
@pytest.mark.parametrize("model", ["ann", "snn"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_parity_dispatch_matches_jax_and_per_row_run(model, shape):
    """Parity mode in float64: within 1e-12 of hpnn_tpu's dispatch
    (``-s`` prints the largest difference), bitwise the port's per-row
    run, whatever the rows were coalesced with."""
    k, jk = _kernels(SHAPES[shape], 11)
    reg, jreg = Registry(), jserve.Registry()
    reg.register("k", k, model=model)
    jreg.register("k", jk, model=model)
    eng = engine.Engine(reg, max_batch=64, device="cpu")
    jeng = jengine.Engine(jreg, max_batch=64)
    assert eng.mode == jeng.mode == "parity"
    rng = np.random.RandomState(7)
    blocks = [rng.uniform(-1.0, 1.0, (r, SHAPES[shape][0])) for r in ROWS]
    outs = eng.dispatch("k", blocks)
    jouts = jeng.dispatch("k", blocks)
    worst = 0.0
    for x, out, jout in zip(blocks, outs, jouts):
        assert out.dtype == np.float64 and out.shape == jout.shape
        assert np.array_equal(out, _per_row(k, model, x))
        worst = max(worst, float(np.max(np.abs(out - np.asarray(jout)))))
    print(f"[parity {model} {shape}] max |port - hpnn_tpu| = {worst:.3e}")
    assert worst <= TOL
    # alone, each block gets the same bits as coalesced
    for x, out in zip(blocks, outs):
        assert np.array_equal(eng.dispatch("k", [x])[0], out)


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_parity_fleet_dispatch_bitwise_per_kernel(model):
    shape = SHAPES["8-6-2"]
    reg = Registry()
    for i in range(3):
        reg.register(f"k{i}", km.Kernel(_weights(shape, 20 + i)), model=model)
    eng = engine.Engine(reg, max_batch=16, n_buckets=3, device="cpu")
    eng.warmup()
    rng = np.random.RandomState(4)
    payloads = [(f"k{i % 3}", rng.uniform(-1, 1, (1 + i % 5, 8))) for i in range(9)]
    outs = eng.dispatch_fleet(payloads)
    for (name, x), out in zip(payloads, outs):
        assert np.array_equal(out, eng.dispatch(name, [x])[0])


# ------------------------------------------------------------- compiled mode
@pytest.mark.parametrize("model", ["ann", "snn"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_compiled_mode_on_cpu_matches_jax(model, shape):
    """Compiled mode's batched forward (eager on the CPU) in float64,
    padded to the bucket, against hpnn_tpu's compiled executables."""
    k, jk = _kernels(SHAPES[shape], 13)
    reg, jreg = Registry(), jserve.Registry()
    reg.register("k", k, model=model)
    jreg.register("k", jk, model=model)
    eng = engine.Engine(reg, max_batch=64, mode="compiled", device="cpu")
    jeng = jengine.Engine(jreg, max_batch=64, mode="compiled")
    rng = np.random.RandomState(8)
    blocks = [rng.uniform(-1.0, 1.0, (r, SHAPES[shape][0])) for r in ROWS]
    worst = 0.0
    for x, out, jout in zip(blocks, eng.dispatch("k", blocks),
                            jeng.dispatch("k", blocks)):
        assert out.shape == (x.shape[0], SHAPES[shape][2])
        worst = max(worst, float(np.max(np.abs(out - np.asarray(jout)))))
        assert float(np.max(np.abs(out - _per_row(k, model, x)))) <= TOL
    print(f"[compiled {model} {shape}] max |port - hpnn_tpu| = {worst:.3e}")
    assert worst <= TOL


def test_compiled_fleet_matches_per_kernel_on_cpu():
    shape = SHAPES["8-6-2"]
    reg = Registry()
    for i in range(4):
        reg.register(f"k{i}", km.Kernel(_weights(shape, 30 + i)), model="snn")
    eng = engine.Engine(reg, max_batch=16, mode="compiled", device="cpu")
    rng = np.random.RandomState(5)
    payloads = [(f"k{i % 4}", rng.uniform(-1, 1, (1 + i % 3, 8))) for i in range(8)]
    for (name, x), out in zip(payloads, eng.dispatch_fleet(payloads)):
        assert np.max(np.abs(out - eng.dispatch(name, [x])[0])) <= TOL


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_run_batch_over_stacked_weights_is_each_members(model):
    """The fleet forward is the model's own ``run_batch`` over (N, n, m)
    weights: each member's slice of it is that member's ``run_batch``
    within 1e-12 (a batched product may sum in another order)."""
    mod = snn if model == "snn" else ann
    members = [km.to_torch(_weights((8, (6, 5), 3), 40 + i), device="cpu",
                           dtype=torch.float64)[0] for i in range(3)]
    stacked = tuple(torch.stack([w[l] for w in members]) for l in range(3))
    xs = torch.from_numpy(np.random.RandomState(9).uniform(-1, 1, (3, 4, 8)))
    got = mod.run_batch(stacked, xs)
    for j, w in enumerate(members):
        assert float(torch.max(torch.abs(got[j] - mod.run_batch(w, xs[j])))) <= TOL


@pytest.mark.parametrize("mode", ["parity", "compiled"])
def test_a_cache_hit_takes_no_engine_lock(mode):
    """A dispatch whose forward is cached never waits on the engine lock
    that a capture holds; a miss does, and is built once."""
    shape = SHAPES["8-6-2"]
    reg = Registry()
    reg.register("k", km.Kernel(_weights(shape, 3)))
    reg.register("late", km.Kernel(_weights(shape, 4)))
    eng = engine.Engine(reg, max_batch=8, mode=mode, device="cpu")
    eng.warmup(["k"])
    x = np.random.RandomState(2).uniform(-1, 1, (3, 8))
    done = {}

    def run(name):
        done[name] = eng.run_rows(reg.get(name), x)

    with eng._lock:  # what a capture holds
        hit = threading.Thread(target=run, args=("k",))
        hit.start()
        hit.join(timeout=30)
        assert "k" in done, "a cache hit waited on the engine lock"
        miss = threading.Thread(target=run, args=("late",))
        miss.start()
        miss.join(timeout=0.2)
        assert miss.is_alive() and "late" not in done
    miss.join(timeout=30)
    assert "late" in done and eng.compiled_count() == len(eng.buckets) + 1
    late = {k: v for k, v in eng.cache_stats().items() if k.startswith("late/")}
    assert [(v["hits"], v["misses"]) for v in late.values()] == [(0, 1)]


# ------------------------------------------------------------- precision
def test_bf16_and_int8_quant_err_within_documented_bounds():
    """docs/performance.md: bf16 < 1e-1, int8 < 2e-1 against the float64
    per-row reference, measured by the warmup probe and on fresh rows;
    4-bit weights never beat 8-bit."""
    k = km.Kernel(_weights((16, (8,), 4), 9))
    rng = np.random.RandomState(1)
    X = rng.uniform(-1, 1, (8, 16))
    for prec, bound in (("bf16", 1e-1), ("int8", 2e-1)):
        reg = Registry()
        reg.register("m", k, precision=prec)
        eng = engine.Engine(reg, mode="compiled", max_batch=8, n_buckets=2,
                            device="cpu")
        eng.warmup()
        doc = eng.precision_doc()["kernels"]["m"]
        assert doc["precision"] == prec and 0.0 < doc["quant_err"] < bound
        got = eng.run_rows(reg.get("m"), X)
        assert got.dtype == np.float64
        assert np.max(np.abs(got - _per_row(k, "ann", X))) < bound

    def dequant_err(bits):
        q, s = engine.quantize_weights(k.weights, bits=bits)
        return max(float(np.max(np.abs(w - a.astype(np.float64) * sc)))
                   for w, a, sc in zip(k.weights, q, s))

    assert dequant_err(4) >= dequant_err(8) > 0.0


def test_parity_mode_ignores_precision_policy(monkeypatch):
    monkeypatch.setenv("HPNN_SERVE_DTYPE", "bf16")
    k = km.Kernel(_weights((8, (6,), 2), 2))
    reg = Registry()
    reg.register("m", k)
    eng = engine.Engine(reg, max_batch=8, n_buckets=2, device="cpu")
    X = np.random.RandomState(2).uniform(-1, 1, (5, 8))
    assert np.array_equal(eng.run_rows(reg.get("m"), X), _per_row(k, "ann", X))


# ------------------------------------------------------------- session
@pytest.mark.parametrize("mode", ["parity", "compiled"])
def test_64_concurrent_requests_one_forward_per_bucket(tmp_path, mode):
    """After warmup the serve.compile count is kernels x buckets and
    stays there through 64 concurrent mixed-size requests (the JAX
    package's acceptance test, tests/test_serve.py)."""
    sink = tmp_path / "obs.jsonl"
    obs.configure(str(sink))
    k = km.Kernel(_weights((8, (5,), 2), 9))
    sess = serve.Session(max_batch=64, n_buckets=4, max_wait_ms=2.0,
                         mode=mode, device="cpu")
    try:
        sess.register_kernel("k", k)
        assert list(sess.engine.buckets) == [8, 16, 32, 64]
        assert sess.engine.compiled_count() == 4
        rng = np.random.RandomState(42)
        inputs = [rng.uniform(-1.0, 1.0, size=((i % 8) + 1, 8)) for i in range(64)]
        outs, errs = [None] * 64, []

        def client(i):
            try:
                outs[i] = sess.infer("k", inputs[i], timeout_s=30.0)
            except Exception as exc:  # collected, asserted empty below
                errs.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and not any(t.is_alive() for t in threads)
        for x, out in zip(inputs, outs):
            if mode == "parity":
                assert np.array_equal(out, _per_row(k, "ann", x))
            else:
                assert np.max(np.abs(out - _per_row(k, "ann", x))) <= TOL
        assert sess.engine.compiled_count() == 4
    finally:
        sess.close()
        obs.flush()
    compiles = [r for r in _read(sink) if r["ev"] == "serve.compile"]
    assert len(compiles) == 4 and {r["bucket"] for r in compiles} == {8, 16, 32, 64}
    hits, misses = compile_cache.counters()
    assert misses == 4 and hits > 0


def test_hot_reload_serves_the_new_version(tmp_path):
    k_old = km.Kernel(_weights((8, (6,), 2), 1))
    k_new = km.Kernel(_weights((8, (6,), 2), 2))
    path = tmp_path / "kernel.opt"
    with open(path, "w") as fp:
        km.dump("R", k_old, fp)
    sess = serve.Session(max_batch=8, n_buckets=2, device="cpu")
    try:
        sess.load_kernel("R", str(path))
        x = np.linspace(-1, 1, 8)
        before = sess.infer("R", x)
        assert np.array_equal(before, _per_row(sess.registry.get("R").kernel, "ann", [x])[0])
        with open(path, "w") as fp:
            km.dump("R", k_new, fp)
        entry = sess.reload("R")
        assert entry.version == 1
        after = sess.infer("R", x)
        assert np.array_equal(after, _per_row(entry.kernel, "ann", [x])[0])
        assert not np.array_equal(before, after)
        # the old version's forwards were evicted, the new one's kept
        assert sess.engine.compiled_count() == 2
        assert {key[1] for key in sess.engine._compiled} == {1}
    finally:
        sess.close()


def test_evict_keeps_the_requested_version():
    reg = Registry()
    reg.register("k", km.Kernel(_weights((8, (5,), 2), 1)))
    eng = engine.Engine(reg, max_batch=8, n_buckets=2, mode="compiled", device="cpu")
    eng.warmup()
    reg.register("k", km.Kernel(_weights((8, (5,), 2), 2)))   # version 1
    eng.warmup()
    assert eng.compiled_count() == 4
    eng.evict("k", keep_version=1)
    assert eng.compiled_count() == 2
    assert sorted(eng._weights_cache) == [("k", 1, None)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_batcher_coalesces_deadlines_backpressure_and_close():
    clock = FakeClock()
    seen = []

    def dispatch(payloads):
        seen.append(list(payloads))
        return [p * 2 for p in payloads]

    b = batcher_mod.Batcher(dispatch, max_batch=4, max_depth=5, clock=clock,
                            start=False)
    # coalescing within max_batch rows, in arrival order
    reqs = [b.submit(i, rows=2) for i in range(3)]
    assert b.drain_once() == 2 and seen[-1] == [0, 1]
    assert b.drain_once() == 1 and seen[-1] == [2]
    assert [b.result(r, timeout_s=1) for r in reqs] == [0, 2, 4]
    # a request past its deadline is dropped before dispatch
    late = b.submit(7, timeout_s=1.0)
    clock.t += 2.0
    assert b.drain_once() == 0
    with pytest.raises(batcher_mod.DeadlineExceeded):
        b.result(late, timeout_s=1)
    assert b.expired_total() == 1
    # backpressure: the queue holds max_depth requests
    parked = [b.submit(i) for i in range(5)]
    with pytest.raises(batcher_mod.QueueFull):
        b.submit(99)
    assert b.shed_counts()["queue_full"] == 1
    # close fails what is still parked, and refuses new work
    b.close()
    assert b.depth() == 0
    for r in parked:
        with pytest.raises(RuntimeError, match="closed"):
            b.result(r, timeout_s=1)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)


def test_chaos_fault_at_dispatch_fails_exactly_one_batch(monkeypatch):
    monkeypatch.setenv("HPNN_CHAOS", "raise@serve.dispatch:times=1")
    chaos._reset_for_tests()
    k = km.Kernel(_weights((8, (5,), 2), 3))
    sess = serve.Session(max_batch=8, n_buckets=2, device="cpu", start=False)
    try:
        sess.register_kernel("k", k)
        b = sess.batcher_for("k")
        X = np.random.RandomState(0).uniform(-1, 1, (6, 8))
        first = [b.submit(X[i:i + 1]) for i in range(3)]
        assert b.drain_once() == 3
        for r in first:
            with pytest.raises(chaos.ChaosFault):
                b.result(r, timeout_s=1)
        second = [b.submit(X[i:i + 1]) for i in range(3, 6)]
        assert b.drain_once() == 3
        for i, r in zip(range(3, 6), second):
            assert np.array_equal(b.result(r, timeout_s=1),
                                  _per_row(k, "ann", X[i:i + 1]))
        assert chaos.plan_doc()[0]["fired"] == 1
    finally:
        sess.close()


def test_router_placement_and_promotion_fence():
    """Two CPU replicas: least-outstanding placement routes around a
    loaded replica, and a promotion fanned out mid-traffic leaves every
    answer bitwise old-version or new-version."""
    k_old = km.Kernel(_weights((8, (5,), 2), 7))
    k_new = km.Kernel(_weights((8, (5,), 2), 8))
    router = serve.Router(2, max_batch=16, max_wait_ms=0.5, device="cpu")
    try:
        router.register_kernel("k", k_old)
        assert [rep.engine.device.type for rep in router.replicas] == ["cpu", "cpu"]
        x = np.linspace(-1, 1, 8)
        # placement: replica 0 carries 5 outstanding rows, so rank 1 answers
        router.replicas[0].begin_request(5)
        assert [rep.rank for rep in router._candidates()] == [1, 0]
        assert np.array_equal(router.infer("k", x), _per_row(k_old, "ann", [x])[0])
        router.replicas[0].end_request(5)
        assert [rep.outstanding() for rep in router.replicas] == [0, 0]

        X = np.linspace(-1.0, 1.0, 24).reshape(3, 8)
        out_old, out_new = _per_row(k_old, "ann", X), _per_row(k_new, "ann", X)
        stop, torn, seen = threading.Event(), [], set()

        def loop():
            while not stop.is_set():
                out = router.infer("k", X)
                if np.array_equal(out, out_old):
                    seen.add("old")
                elif np.array_equal(out, out_new):
                    seen.add("new")
                else:
                    torn.append(out)
                    return

        threads = [threading.Thread(target=loop) for _ in range(4)]
        for t in threads:
            t.start()
        entry = router.install_kernel("k", k_new)
        for _ in range(400):   # the new version answers within 20 s
            if "new" in seen:
                break
            threading.Event().wait(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not torn and not any(t.is_alive() for t in threads)
        assert entry.version == 1 and "new" in seen
        assert {rep.registry.get("k").version for rep in router.replicas} == {1}
        doc = router.health()
        assert doc["router"]["spill"] is False and doc["alerts"]["armed"] is False
    finally:
        router.close()


# ------------------------------------------------------------- serve_nn
@pytest.fixture
def workdir_conf(tmp_path, monkeypatch):
    p = tmp_path / "nn.conf"
    p.write_text("[name] E2E\n[type] ANN\n[init] generate\n[seed] 1234\n"
                 "[input] 8\n[hidden] 6\n[output] 2\n[train] BP\n"
                 "[sample_dir] ./samples\n[test_dir] ./samples\n")
    monkeypatch.chdir(tmp_path)
    return str(p)


def _http(host, port, method, path, body=None):
    cn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        cn.request(method, path, body=body)
        resp = cn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        cn.close()


def test_serve_nn_http_round_trip_and_healthz_keys(workdir_conf, capsys):
    """serve_nn on port 0: /healthz keys equal hpnn_tpu's, /v1/infer is
    bitwise the per-row run, the unported routes answer as on a plain
    JAX serving process, stdout stays empty."""
    from hpnn_tpu import config as jconfig
    from hpnn_tpu.cli import serve_nn as jserve_nn
    from hpnn_tpu_torch import config

    conf = config.load_conf(workdir_conf)
    session, server = serve_nn.build_from_conf(conf, max_batch=8, n_buckets=2,
                                               port=0, device="cpu")
    jsession, jserver = jserve_nn.build_from_conf(jconfig.load_conf(workdir_conf),
                                                  max_batch=8, n_buckets=2, port=0)
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (server, jserver)]
    for t in threads:
        t.start()
    try:
        host, port = server.server_address[:2]
        jhost, jport = jserver.server_address[:2]
        code, health = _http(host, port, "GET", "/healthz")
        jcode, jhealth = _http(jhost, jport, "GET", "/healthz")
        assert code == jcode == 200
        assert sorted(health) == sorted(jhealth)
        assert health["kernels"] == ["E2E"] and health["buckets"] == [4, 8]
        for plane in ("sampler", "capsules", "drift", "blame", "tune"):
            assert health[plane] == jhealth[plane] == {"armed": False}
        assert health["alerts"] == jhealth["alerts"]

        x = np.linspace(-1, 1, 8)
        code, reply = _http(host, port, "POST", "/v1/infer",
                            json.dumps({"kernel": "E2E", "inputs": x.tolist()}))
        assert code == 200
        assert np.array_equal(np.asarray(reply["outputs"]),
                              _per_row(conf.kernel, "ann", [x])[0])
        jcode, jreply = _http(jhost, jport, "POST", "/v1/infer",
                              json.dumps({"kernel": "E2E", "inputs": x.tolist()}))
        assert np.max(np.abs(np.asarray(reply["outputs"])
                             - np.asarray(jreply["outputs"]))) <= TOL
        for method, path, body in (("GET", "/tunez", None), ("GET", "/meterz", None),
                                   ("GET", "/tenantz", None),
                                   ("POST", "/ingest", b"{}"),
                                   ("POST", "/v1/capture", b"{}")):
            assert _http(host, port, method, path, body)[0] == 404, path
            assert _http(jhost, jport, method, path, body)[0] == 404, path
        assert _http(host, port, "POST", "/v1/infer",
                     json.dumps({"kernel": "nope", "inputs": [0.0]}))[0] == 404
        assert _http(host, port, "POST", "/v1/infer", b"not json")[0] == 400
        assert _http(host, port, "POST", "/v1/reload",
                     json.dumps({"kernel": "E2E"}))[0] == 400
    finally:
        for s in (server, jserver):
            s.shutdown()
            s.server_close()
        session.close()
        jsession.close()
    assert capsys.readouterr().out == ""


def test_bench_serve_smoke_reports_latency_and_census():
    out = bench_serve.run_serve_bench(
        n_in=8, hiddens=[5], n_out=2, n_clients=4, n_requests=3,
        max_batch=8, n_buckets=2, max_wait_ms=1.0, device="cpu")
    assert "errors" not in out, out
    assert out["requests_served"] == 12 and out["device"] == "cpu"
    assert out["latency_ms"]["p99"] >= out["latency_ms"]["p50"] > 0
    assert out["compiled_after_load"] == out["compiled_after_warmup"] == 2
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "loadgen", os.path.join(os.path.dirname(__file__), "..", "tools", "loadgen.py"))
    loadgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loadgen)
    lat = list(np.random.RandomState(3).exponential(0.01, 57))
    assert bench_serve.latency_summary(lat) == loadgen.latency_summary(lat)
    assert bench_serve.latency_summary([]) == loadgen.latency_summary([])


def test_bench_serve_window_series_interleaves_setups():
    """``--seconds``/``--runs``/``--replicas``: every setup runs for the
    window on a fresh session, in the order A B B A, and the line holds
    each setup's spread."""
    out = bench_serve.run_series(
        [0, 2], 2, n_in=8, hiddens=[5], n_out=2, n_clients=3, max_batch=8,
        n_buckets=2, max_wait_ms=1.0, device="cpu", duration_s=0.2)
    assert "errors" not in out, out
    assert out["order"] == [0, 2, 2, 0]
    for res in out["runs"]:
        assert res["window_s"] == 0.2 and res["requests_per_client"] is None
        assert res["requests_served"] > 3 and res["wall_s"] >= 0.2
        assert res["compiled_after_load"] == res["compiled_after_warmup"] \
            == 2 * max(1, res["replicas"])
    for r in ("0", "2"):
        sp = out["spread"][r]
        assert sp["p99_ms"]["min"] <= sp["p99_ms"]["median"] <= sp["p99_ms"]["max"]
        assert sp["requests_served"] == sum(
            res["requests_served"] for res in out["runs"] if str(res["replicas"]) == r)


# ------------------------------------------------------------- refusals
def test_spill_and_compile_cache_knobs_are_refused(monkeypatch):
    """The spill is ported: ``spill=True`` and ``HPNN_SERVE_SPILL=1``
    arm it (only "1" does); XLA's executable cache stays refused."""
    r = serve.Router(2, spill=True, device="cpu")
    assert r.spill and r.health()["router"]["spill"]
    r.close()
    monkeypatch.setenv("HPNN_SERVE_SPILL", "1")
    r = serve.Router(2, device="cpu")
    assert r.spill
    r.close()
    monkeypatch.setenv("HPNN_SERVE_SPILL", "0")
    r = serve.Router(1, device="cpu")
    assert not r.spill
    r.close()
    monkeypatch.setenv("HPNN_COMPILE_CACHE_DIR", "/tmp/x")
    with pytest.raises(NotImplementedError, match="HPNN_COMPILE_CACHE_DIR"):
        serve.Session(device="cpu")


@pytest.mark.parametrize("argv,msg", [
    # --sample/--capsule-dir are taken (tests/test_torch_planes.py); a
    # bad value beside them is still refused before anything is armed
    (["--sample", "0.5", "--port", "70000"], "bad --port"),
    (["--capsule-dir", "caps", "--max-wait-ms", "soon"], "bad --max-wait-ms"),
    (["--port", "70000"], "bad --port"),
    (["--max-batch", "0"], "bad --max-batch"),
    (["--max-wait-ms", "soon"], "bad --max-wait-ms"),
])
def test_serve_nn_refuses(workdir_conf, capsys, argv, msg):
    assert serve_nn.main(["--device", "cpu", *argv, workdir_conf]) != 0
    err = capsys.readouterr()
    assert msg in err.err and err.out == ""


def test_serve_nn_refuses_cuda_when_absent(workdir_conf, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_nn.main([workdir_conf]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(runtime.DeviceUnavailable):
        serve.Session()


# ------------------------------------------------------------- obs, modes, drain
def _lint(name, path):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "check_obs_catalog",
        os.path.join(os.path.dirname(__file__), "..", "tools", "check_obs_catalog.py"))
    cat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cat)
    return getattr(cat, name)(str(path))


def test_cost_records_and_quant_pass_the_jax_lints(tmp_path, monkeypatch):
    """HPNN_COST: each bucket dispatch catalogs its forward once
    (flops 2·bucket·Σ in·out, the weights' and the block's bytes) and
    emits the perf gauges; a bf16 warmup emits serve.precision and
    numerics.quant_err; tools/check_obs_catalog.py --perf and --quant
    accept the sink."""
    sink = tmp_path / "m.jsonl"
    monkeypatch.setenv("HPNN_METRICS", str(sink))
    monkeypatch.setenv("HPNN_COST", "1")
    obs.reset()
    k = km.Kernel(_weights((8, (6,), 2), 4))
    sess = serve.Session(max_batch=8, n_buckets=2, mode="compiled", device="cpu")
    try:
        sess.register_kernel("k", k)
        sess.registry.register("q", k, precision="bf16")
        sess.engine.warmup(["q"])
        sess.infer("k", np.zeros((3, 8)))
        sess.infer("k", np.zeros((7, 8)))
    finally:
        sess.close()
        obs.flush()
    recs = _read(sink)
    cost = {r["exe"]: r for r in recs if r["ev"] == "compile.cost"}
    assert cost["serve.k.v0.b4"]["flops"] == 2 * 4 * (6 * 8 + 2 * 6)
    assert cost["serve.k.v0.b8"]["bytes_accessed"] == (6 * 8 + 2 * 6) * 8 + 8 * (8 + 2) * 8
    assert {r["exe"] for r in recs if r["ev"] == "perf.mfu"} == set(cost)
    assert _lint("lint_perf", sink) == []
    assert _lint("lint_quant", sink) == []


def test_mode_follows_the_device_and_the_knob(monkeypatch):
    reg = Registry()
    assert engine.Engine(reg, device="cpu").mode == "parity"
    monkeypatch.setenv("HPNN_SERVE_MODE", "compiled")
    assert engine.Engine(reg, device="cpu").mode == "compiled"
    assert engine.Engine(reg, device="cpu", mode="parity").mode == "parity"
    monkeypatch.setenv("HPNN_SERVE_MODE", "jit")
    with pytest.raises(ValueError, match="serve mode"):
        engine.Engine(reg, device="cpu")
    monkeypatch.delenv("HPNN_SERVE_MODE")
    monkeypatch.setenv("HPNN_SERVE_DTYPE", "fp8")
    with pytest.raises(ValueError, match="HPNN_SERVE_DTYPE"):
        engine.Engine(reg, device="cpu")


def test_evict_drops_the_fleet_forwards_holding_the_kernel():
    reg = Registry()
    for i in range(3):
        reg.register(f"k{i}", km.Kernel(_weights((8, (5,), 2), 40 + i)))
    eng = engine.Engine(reg, max_batch=8, n_buckets=2, mode="compiled", device="cpu")
    eng.dispatch_fleet([(f"k{i}", np.zeros((2, 8))) for i in range(3)])
    fleet = [k for k in eng._compiled if k[0][0] == "fleet"]
    assert len(fleet) == 1
    reg.register("k1", km.Kernel(_weights((8, (5,), 2), 50)))   # version 1
    eng.evict("k1", keep_version=1)
    assert not [k for k in eng._compiled if k[0][0] == "fleet"]
    assert ("k0", 0, None) in eng._weights_cache


def test_readiness_drain_and_slo(workdir_conf, monkeypatch):
    """/readyz and the POST routes answer 503 while unready; the drain
    handler flips readiness, closes the session and stops the server;
    HPNN_SLO_MS tracks the served requests in /healthz."""
    from hpnn_tpu_torch import config

    monkeypatch.setenv("HPNN_SLO_MS", "1000")
    obs.reset()
    conf = config.load_conf(workdir_conf)
    session, server = serve_nn.build_from_conf(conf, max_batch=8, n_buckets=2,
                                               port=0, device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    body = json.dumps({"kernel": "E2E", "inputs": [0.0] * 8})
    try:
        assert _http(host, port, "POST", "/v1/infer", body)[0] == 200
        assert _http(host, port, "GET", "/healthz")[1]["slo"]["requests"] == 1
        session.mark_unready("warming")
        assert _http(host, port, "GET", "/readyz")[0] == 503
        assert _http(host, port, "POST", "/v1/infer", body)[0] == 503
        session.mark_ready()
        assert _http(host, port, "GET", "/readyz")[0] == 200
        # the handler, installed from a helper thread (no signal hook)
        got = []
        helper = threading.Thread(target=lambda: got.append(
            serve.install_drain(server, session)))
        helper.start()
        helper.join(timeout=10)
        got[0]()
        t.join(timeout=10)
        assert not t.is_alive() and not session.is_ready()
        with pytest.raises(RuntimeError, match="closed"):
            session.infer("E2E", np.zeros(8))
    finally:
        server.shutdown()
        server.server_close()
        session.close()


def test_router_sink_passes_the_serve_replicas_lint(tmp_path, monkeypatch):
    sink = tmp_path / "r.jsonl"
    monkeypatch.setenv("HPNN_METRICS", str(sink))
    obs.reset()
    router = serve.Router(2, max_batch=8, max_wait_ms=0.5, device="cpu")
    try:
        router.register_kernel("k", km.Kernel(_weights((8, (5,), 2), 6)))
        for i in range(6):
            router.infer("k", np.full((1 + i % 3, 8), 0.1 * i))
        router.install_kernel("k", km.Kernel(_weights((8, (5,), 2), 7)))
        router.kill_replica(1)
        router.infer("k", np.zeros(8))
        assert router.spawn_replica().registry.get("k").version == 1
    finally:
        router.close()
        obs.flush()
    assert _lint("lint_serve_replicas", sink) == []
    evs = {r["ev"] for r in _read(sink)}
    assert {"router.route", "router.fence", "router.replica_down",
            "router.replica_up", "replica.outstanding"} <= evs
