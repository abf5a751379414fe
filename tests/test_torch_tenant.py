"""The port's multi-tenant host (``hpnn_tpu_torch/tenant``) on the CPU,
held against the JAX package's.

* ``shard_of``, ``_weights_digest`` and the quota token bucket under an
  injected clock match ``hpnn_tpu``'s exactly;
* a paged-out-then-paged-in kernel answers bitwise as one never evicted
  (and within 1e-12 of ``hpnn_tpu``'s), a promotion landing on a paged
  kernel pages it in first, an infer racing a page-out never gets a
  404, pinned kernels are never evicted, and ``preload_index`` boots a
  fresh host warm;
* a capture that fails on page-in raises to the request and leaves the
  kernel paged; ``TenantSession`` runs on ``cuda`` unless asked for the
  CPU;
* ``X-Tenant`` routing, the quota 429 and ``/tenantz`` carry the JAX
  documents' keys; the tenant sink passes ``check_obs_catalog.py
  --tenant``;
* the tenant bench twin reports ``tools/loadgen.py``'s keys.

No test spawns a process.
"""

import http.client
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from hpnn_tpu import obs as jobs
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.tenant import TenantSession as JTenantSession
from hpnn_tpu.tenant import pager as jpager
from hpnn_tpu.tenant import quota as jquota
from hpnn_tpu.tenant import shards as jshards
from hpnn_tpu_torch import obs, runtime, serve
from hpnn_tpu_torch.models import ann
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.tenant import (QuotaEnforcer, QuotaExceeded, TenantSession,
                                   TenantSpec, scoped)
from hpnn_tpu_torch.tenant import pager as pager_mod
from hpnn_tpu_torch.tenant import shards
from hpnn_tpu_torch.tools import bench_serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TENANT_KNOBS = ("HPNN_TENANTS", "HPNN_TENANT_SHARDS", "HPNN_TENANT_RESIDENT",
                "HPNN_TENANT_PAGE_DIR", "HPNN_SERVE_MODE", "HPNN_SERVE_FLEET",
                "HPNN_DTYPE")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, *TENANT_KNOBS):
        monkeypatch.delenv(knob, raising=False)
    obs._reset_for_tests()
    jobs._reset_for_tests()
    yield
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    obs._reset_for_tests()
    jobs._reset_for_tests()


def _kernel(seed=7, n_in=8, hid=5, n_out=2):
    return km.generate(seed, n_in, [hid], n_out)[0]


def _direct(kernel, rows):
    w, _ = km.to_torch(kernel.weights, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        return np.stack([ann.run(w, torch.tensor(x)).numpy()
                         for x in np.atleast_2d(rows)])


def _session(*, resident_max=0, page_dir=None, tenants=None, fleet=False, **kw):
    return TenantSession(device="cpu", max_batch=8, n_buckets=2, max_wait_ms=0.5,
                         fleet=fleet, shards=4, resident_max=resident_max,
                         page_dir=page_dir, tenants=tenants,
                         page_warmup=kw.pop("page_warmup", False), **kw)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _read(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp if ln.strip()]


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("n_shards", [1, 4, 16, 7])
def test_shard_of_matches_the_jax_package(n_shards):
    names = [f"t{i % 9}:k{i}" for i in range(300)] + ["", "ü:ß", "a:b:c"]
    assert ([shards.shard_of(n, n_shards) for n in names]
            == [jshards.shard_of(n, n_shards) for n in names])


@pytest.mark.parametrize("shapes", [((5, 8), (2, 5)), ((300, 784), (10, 300)),
                                    ((3, 3),)])
def test_weights_digest_matches_the_jax_package(shapes):
    rng = np.random.RandomState(len(shapes))
    weights = [rng.standard_normal(s) for s in shapes]
    assert pager_mod._weights_digest(weights) == jpager._weights_digest(weights)
    assert pager_mod._index_key("t:k") == jpager._index_key("t:k")
    # the same bytes in other shapes are another object
    flat = [w.reshape(-1, 1) for w in weights]
    assert pager_mod._weights_digest(flat) != pager_mod._weights_digest(weights)


QUOTA_SPECS = "metered=silver:rate=2:burst=0.5,narrow=gold:inflight=1,hog=bronze:rate=5"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quota_token_bucket_matches_under_an_injected_clock(seed):
    """The same seeded admit/release/advance script through both
    packages' enforcers on their own fake clocks: every admission
    verdict, its retry-after, and the health documents are equal."""
    from hpnn_tpu_torch.tenant.quota import parse_tenants

    assert parse_tenants(QUOTA_SPECS) == {
        k: TenantSpec(*v) for k, v in jquota.parse_tenants(QUOTA_SPECS).items()}
    clocks = (FakeClock(), FakeClock())
    mine = QuotaEnforcer(parse_tenants(QUOTA_SPECS), clock=clocks[0])
    theirs = jquota.QuotaEnforcer(jquota.parse_tenants(QUOTA_SPECS), clock=clocks[1])
    rng = np.random.RandomState(seed)
    held = []
    for step in range(200):
        op = rng.randint(4)
        tenant = ("metered", "narrow", "hog", "anon")[rng.randint(4)]
        if op == 3:
            dt = float(rng.uniform(0, 0.4))
            for c in clocks:
                c.advance(dt)
            continue
        if op == 2 and held:
            t = held.pop(0)
            mine.release(t)
            theirs.release(t)
            mine.record(t, 0.001 * step)
            theirs.record(t, 0.001 * step)
            continue
        outcome = []
        for q, exc in ((mine, QuotaExceeded), (theirs, jquota.QuotaExceeded)):
            try:
                q.admit(tenant)
                outcome.append(("ok",))
            except exc as e:
                outcome.append(("shed", str(e), e.retry_after_s, e.tenant))
        assert outcome[0] == outcome[1], step
        if outcome[0][0] == "ok":
            held.append(tenant)
    assert mine.health_doc() == theirs.health_doc()
    assert any(d["shed_rate"] > 0 for d in mine.health_doc().values())


# ------------------------------------------------------------ paging
def test_page_round_trip_is_bitwise_and_version_pinned(tmp_path):
    store = str(tmp_path / "store")
    sess = _session(resident_max=1, page_dir=store)
    try:
        ka, kb = _kernel(seed=21), _kernel(seed=22)
        x = np.linspace(-1.0, 1.0, 8)
        sess.register_for("t", "a", ka, warmup=False)
        before = np.asarray(sess.infer_for("t", "a", x))
        assert np.array_equal(before, _direct(ka, x)[0])
        v_before = sess.registry.get(scoped("t", "a")).version
        sess.register_for("t", "b", kb, warmup=False)   # evicts a
        assert sess.pager.is_paged(scoped("t", "a"))
        assert not any(k[0] == scoped("t", "a") for k in sess.engine._compiled)
        assert not any(k[0] == scoped("t", "a") for k in sess.engine._weights_cache)
        after = np.asarray(sess.infer_for("t", "a", x))  # pages in
        assert np.array_equal(after, before)
        assert sess.registry.get(scoped("t", "a")).version == v_before
        doc = sess.pager.health_doc()
        assert doc["page_ins"] == 1 and doc["page_outs"] >= 1
    finally:
        sess.close()
    js = JTenantSession(max_batch=8, n_buckets=2, max_wait_ms=0.5, shards=4,
                        page_warmup=False)
    try:
        js.register_for("t", "a", jkm.Kernel(tuple(ka.weights)), warmup=False)
        err = float(np.max(np.abs(np.asarray(js.infer_for("t", "a", x)) - after)))
    finally:
        js.close()
    assert err <= 1e-12


def test_page_in_with_warmup_splits_the_cold_hit(tmp_path):
    """``page_warmup`` captures the whole menu on page-in: the cold-hit
    split counts one build a bucket and times read, copy and builds."""
    sess = _session(resident_max=1, page_dir=str(tmp_path / "s"), page_warmup=True,
                    mode="compiled")
    try:
        sess.register_for("t", "a", _kernel(seed=1))
        sess.register_for("t", "b", _kernel(seed=2))   # a paged out
        x = np.linspace(-1.0, 1.0, 8)
        sess.infer_for("t", "a", x)
        split = sess.pager.cold_split()
        assert len(split) == 1 and split[0]["captures"] == len(sess.engine.buckets)
        assert all(split[0][k] >= 0.0 for k in ("read_ms", "h2d_ms", "capture_ms"))
        assert sum(split[0][k] for k in ("read_ms", "h2d_ms", "capture_ms")) \
            <= sess.pager.cold_hit_ms()[0]
    finally:
        sess.close()


def test_a_failed_capture_on_page_in_raises_and_stays_paged(tmp_path, monkeypatch):
    sess = _session(resident_max=1, page_dir=str(tmp_path / "s"), page_warmup=True)
    try:
        ka = _kernel(seed=3)
        sess.register_for("t", "a", ka)
        sess.register_for("t", "b", _kernel(seed=4))
        name = scoped("t", "a")

        def broken(names=None, *, dtype=None):
            raise RuntimeError("capture failed")

        monkeypatch.setattr(sess.engine, "warmup", broken)
        x = np.linspace(-1.0, 1.0, 8)
        with pytest.raises(RuntimeError, match="capture failed"):
            sess.infer_for("t", "a", x)
        assert sess.pager.is_paged(name) and not sess.pager.is_resident(name)
        with pytest.raises(KeyError):
            sess.registry.get(name)
        monkeypatch.undo()
        assert np.array_equal(np.asarray(sess.infer_for("t", "a", x)), _direct(ka, x)[0])
    finally:
        sess.close()


def test_a_page_in_does_not_hold_back_resident_kernels(tmp_path, monkeypatch):
    """A page-in runs outside the pager lock: while one request waits
    for a slow page-in, requests for a resident kernel are answered,
    and a second request for the loading kernel waits for that page-in
    instead of paging it in twice."""
    import time

    sess = _session(resident_max=2, page_dir=str(tmp_path / "s"), page_warmup=True)
    try:
        ka, kb, kc = _kernel(seed=5), _kernel(seed=6), _kernel(seed=7)
        sess.register_for("t", "a", ka)
        sess.register_for("t", "b", kb)
        sess.register_for("t", "c", kc)           # a paged out
        assert sess.pager.is_paged(scoped("t", "a"))
        gate, warm = threading.Event(), sess.engine.warmup

        def slow(names=None, **kw):
            gate.wait(30)
            return warm(names, **kw)

        monkeypatch.setattr(sess.engine, "warmup", slow)
        x = np.linspace(-1.0, 1.0, 8)
        outs = {}
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, np.asarray(sess.infer_for("t", "a", x)))) for i in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        assert np.array_equal(np.asarray(sess.infer_for("t", "b", x)), _direct(kb, x)[0])
        assert np.array_equal(np.asarray(sess.infer_for("t", "c", x)), _direct(kc, x)[0])
        gate.set()
        for t in threads:
            t.join(30)
        assert all(np.array_equal(outs[i], _direct(ka, x)[0]) for i in range(2))
        assert sess.pager.health_doc()["page_ins"] == 1
    finally:
        sess.close()


def test_a_registration_over_an_in_flight_page_in_wins(tmp_path, monkeypatch):
    """A page-in runs outside the pager lock; a registration of the same
    name meanwhile waits for it, then lands: no thread hangs, the
    request that paged the kernel in gets the old or the new weights'
    answer, and the new weights answer after."""
    import time

    sess = _session(resident_max=1, page_dir=str(tmp_path / "s"))
    try:
        old, new = _kernel(seed=8), _kernel(seed=9)
        name = scoped("t", "a")
        sess.register_for("t", "a", old, warmup=False)
        sess.register_for("t", "b", _kernel(seed=10), warmup=False)   # a out
        assert sess.pager.is_paged(name)
        gate, entered, load = threading.Event(), threading.Event(), sess.pager._load

        def slow(*a, **kw):
            entered.set()
            gate.wait(30)
            return load(*a, **kw)

        monkeypatch.setattr(sess.pager, "_load", slow)
        x = np.linspace(-1.0, 1.0, 8)
        outs, errs = {}, []

        def run(key, fn):
            try:
                outs[key] = fn()
            except Exception as exc:  # collected, asserted empty below
                errs.append(repr(exc))

        infer = threading.Thread(target=run, args=(
            "infer", lambda: np.asarray(sess.infer_for("t", "a", x))))
        infer.start()
        assert entered.wait(30)
        register = threading.Thread(target=run, args=(
            "register", lambda: sess.register_for("t", "a", new, warmup=False)))
        register.start()
        time.sleep(0.2)
        assert register.is_alive()          # waits for the page-in
        gate.set()
        infer.join(30)
        register.join(30)
        assert not infer.is_alive() and not register.is_alive()
        assert not errs, errs
        # the registration lands once the page-in ends, so the request
        # that paged the kernel in observes the old or the new version
        assert any(np.array_equal(outs["infer"], _direct(k, x)[0]) for k in (old, new))
        assert sess.pager.is_resident(name) and not sess.pager.is_paged(name)
        assert not os.path.exists(sess.pager._index_path(name))
        assert np.array_equal(np.asarray(sess.infer_for("t", "a", x)), _direct(new, x)[0])
        assert sess.pager.health_doc()["page_ins"] == 1
    finally:
        sess.close()


def test_lazy_page_ins_are_refused_on_cuda(tmp_path):
    """Without ``warmup`` a paged-in kernel would capture on its batcher
    thread, each such thread keeping a cuBLAS workspace: ``cuda``
    refuses it; the CPU (no captures) keeps it."""
    import types

    reg = shards.ShardedRegistry(2)
    for dev, ok in (("cuda", False), ("cpu", True)):
        eng = types.SimpleNamespace(device=torch.device(dev))
        if ok:
            pager_mod.Pager(reg, eng, resident_max=1, page_dir=str(tmp_path), warmup=False)
        else:
            with pytest.raises(pager_mod.PagingError, match="warmup"):
                pager_mod.Pager(reg, eng, resident_max=1, page_dir=str(tmp_path),
                                warmup=False)
        pager_mod.Pager(reg, eng, resident_max=1, page_dir=str(tmp_path), warmup=True)


def test_promotion_on_paged_out_kernel_pages_in_first(tmp_path):
    sess = _session(resident_max=1, page_dir=str(tmp_path / "store"))
    try:
        name = scoped("t", "a")
        ka2 = _kernel(seed=32)
        sess.register_for("t", "a", _kernel(seed=31), warmup=False)
        sess.register_for("t", "b", _kernel(seed=33), warmup=False)
        assert sess.pager.is_paged(name)
        entry = sess.install_kernel(name, ka2, warmup=False)
        assert entry.version == 1
        assert sess.pager.is_resident(name) and not sess.pager.is_paged(name)
        x = np.linspace(-1.0, 1.0, 8)
        assert np.array_equal(np.asarray(sess.infer_for("t", "a", x)), _direct(ka2, x)[0])
    finally:
        sess.close()


def test_concurrent_infer_racing_page_out_never_404(tmp_path):
    sess = _session(resident_max=1, page_dir=str(tmp_path / "store"))
    try:
        kernels = {"a": _kernel(seed=41), "b": _kernel(seed=42)}
        x = np.linspace(-1.0, 1.0, 8)
        want = {n: _direct(k, x)[0] for n, k in kernels.items()}
        for n, k in kernels.items():
            sess.register_for("t", n, k, warmup=False)
        errs = []

        def client(i):
            try:
                for j in range(12):
                    n = "a" if (i + j) % 2 == 0 else "b"
                    out = np.asarray(sess.infer_for("t", n, x, timeout_s=30.0))
                    if not np.array_equal(out, want[n]):
                        errs.append((n, "mismatch"))
            except Exception as exc:  # collected, asserted empty below
                errs.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        doc = sess.pager.health_doc()
        assert doc["page_ins"] >= 2 and doc["resident"] <= 1 + doc["pinned"]
    finally:
        sess.close()


def test_pinned_kernels_are_never_evicted(tmp_path):
    sess = _session(resident_max=1, page_dir=str(tmp_path / "store"))
    try:
        sess.register_for("t", "a", _kernel(seed=51), warmup=False)
        sess.register_for("t", "b", _kernel(seed=52), warmup=False)
        with sess.pager.pin(scoped("t", "b")):
            with sess.pager.pin(scoped("t", "a")):
                assert sess.pager.is_resident(scoped("t", "a"))
                assert sess.pager.is_resident(scoped("t", "b"))
                sess.register_for("t", "c", _kernel(seed=53), warmup=False)
                assert sess.pager.is_resident(scoped("t", "a"))
                assert sess.pager.is_resident(scoped("t", "b"))
                assert sess.pager.health_doc()["pinned"] == 2
            assert sess.pager.is_resident(scoped("t", "b"))
        assert sess.pager.health_doc()["resident"] == 1
    finally:
        sess.close()


def test_preload_index_boots_warm(tmp_path):
    store = str(tmp_path / "store")
    ka = _kernel(seed=61)
    x = np.linspace(-1.0, 1.0, 8)
    s1 = _session(resident_max=1, page_dir=store)
    try:
        s1.register_for("t", "a", ka, warmup=False)
        s1.register_for("t", "b", _kernel(seed=62), warmup=False)
    finally:
        s1.close()
    s2 = _session(resident_max=1, page_dir=store)
    try:
        assert s2.pager.is_paged(scoped("t", "a"))
        want = np.asarray(s2.infer_for("t", "a", x))
        assert np.array_equal(want, _direct(ka, x)[0])
        s2.register_for("t", "c", _kernel(seed=63), warmup=False)  # a out
        assert s2.pager.is_paged(scoped("t", "a"))
    finally:
        s2.close()
    # the JAX host boots warm off the port's store too (same layout)
    js = JTenantSession(max_batch=8, n_buckets=2, max_wait_ms=0.5, shards=4,
                        resident_max=1, page_dir=store, page_warmup=False)
    try:
        assert js.pager.is_paged(scoped("t", "a"))
        theirs = np.asarray(js.infer_for("t", "a", x))
    finally:
        js.close()
    assert float(np.max(np.abs(theirs - want))) <= 1e-12


def test_tenant_session_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.DeviceUnavailable):
        TenantSession()
    with pytest.raises(runtime.DeviceUnavailable):
        serve.Session()


# ------------------------------------------------------------ HTTP edge
def test_http_x_tenant_routing_quota_429_and_tenantz(tmp_path):
    k = _kernel(seed=81)
    tenants = {"acme": ("acme", "gold"), "hog": ("hog", "bronze", 0.5, 0, 0.1)}
    docs = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            sess = _session(fleet=True, resident_max=1, page_dir=str(tmp_path / "p"),
                            tenants={t: TenantSpec(*v) for t, v in tenants.items()})
            server = serve.make_server(sess)
            kern = k
        else:
            from hpnn_tpu import serve as jserve

            sess = JTenantSession(max_batch=8, n_buckets=2, max_wait_ms=0.5,
                                  fleet=True, shards=4, resident_max=1,
                                  page_dir=str(tmp_path / "j"), page_warmup=False,
                                  tenants={t: jquota.TenantSpec(*v)
                                           for t, v in tenants.items()})
            server = jserve.make_server(sess)
            kern = jkm.Kernel(tuple(k.weights))
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            sess.register_for("acme", "k", kern, warmup=False)
            sess.register_for("hog", "k", kern, warmup=False)
            cn = http.client.HTTPConnection(host, port, timeout=30)
            x = np.linspace(-1.0, 1.0, 8)
            body = json.dumps({"kernel": "k", "inputs": x.tolist()})
            got = []
            for tenant in ("acme", None, "hog", "hog"):
                hdrs = {"Content-Type": "application/json"}
                if tenant:
                    hdrs["X-Tenant"] = tenant
                cn.request("POST", "/v1/infer", body=body, headers=hdrs)
                resp = cn.getresponse()
                got.append((resp.status, json.loads(resp.read())))
            cn.request("GET", "/tenantz")
            resp = cn.getresponse()
            got.append((resp.status, json.loads(resp.read())))
            cn.close()
        finally:
            server.shutdown()
            server.server_close()
            sess.close()
        docs.append(got)
    mine, theirs = docs
    assert [c for c, _ in mine] == [c for c, _ in theirs] == [200, 404, 200, 429, 200]
    assert np.array_equal(np.asarray(mine[0][1]["outputs"]), _direct(k, x)[0])
    assert mine[3][1]["reason"] == "quota" and mine[3][1]["tenant"] == "hog"
    assert sorted(mine[3][1]) == sorted(theirs[3][1])
    tz, jtz = mine[4][1], theirs[4][1]
    assert sorted(tz) == sorted(jtz) == ["pager", "registry", "tenants"]
    for key in tz:
        assert sorted(tz[key]) == sorted(jtz[key]), key
    for t in tz["tenants"]:
        assert sorted(tz["tenants"][t]) == sorted(jtz["tenants"][t])


# ------------------------------------------------------------ sink lint
def test_live_tenant_sink_lints_clean(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "check_obs_catalog", os.path.join(ROOT, "tools", "check_obs_catalog.py"))
    cat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cat)
    sink = tmp_path / "obs.jsonl"
    monkeypatch.setenv("HPNN_METER", "1")
    obs.configure(str(sink))
    try:
        sess = _session(resident_max=1, page_dir=str(tmp_path / "store"),
                        tenants={"t": TenantSpec("t", "gold"),
                                 "hog": TenantSpec("hog", "bronze", rate_rps=0.5,
                                                   burst_s=0.1)})
        try:
            sess.register_for("t", "a", _kernel(seed=91), warmup=False)
            sess.register_for("t", "b", _kernel(seed=92), warmup=False)
            sess.register_for("hog", "h", _kernel(seed=93), warmup=False)
            x = np.linspace(-1.0, 1.0, 8)
            for i in range(10):
                sess.infer_for("t", "a" if i % 2 else "b", x)
            sess.infer_for("hog", "h", x)
            with pytest.raises(QuotaExceeded):
                sess.infer_for("hog", "h", x)
        finally:
            sess.close()
    finally:
        obs.configure(None)
    names = {r["ev"] for r in _read(sink)}
    for want in ("tenant.page_out", "tenant.page_in", "tenant.page_in_ms",
                 "tenant.resident", "tenant.p99_ms", "tenant.shed_rate",
                 "tenant.shed", "tenant.inflight", "tenant.close"):
        assert want in names, want
    assert cat.lint_tenant(str(sink)) == []
    assert cat.main(["--tenant", str(sink)]) == 0


# ------------------------------------------------------------ the bench
def test_tenant_bench_twin_reports_the_loadgen_keys(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "loadgen", os.path.join(ROOT, "tools", "loadgen.py"))
    loadgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loadgen)
    kw = dict(n_kernels=24, resident=4, n_tenants=3, traffic_s=0.3, n_threads=2,
              hot_rate_rps=20.0)
    theirs = loadgen.run_bench_tenant(**kw)
    mine = bench_serve.run_bench_tenant(**kw, device="cpu", n_in=8, hiddens=[5],
                                        n_out=2, rows=(1, 2))
    assert set(theirs) <= set(mine)
    assert mine["errors"] == 0 and mine["ok"] > 0
    assert mine["resident_cap_ok"] and mine["page_ins"] > 0
    assert mine["device"] == "cpu" and mine["memory"] is None
