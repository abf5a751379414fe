"""The port's online learning (``hpnn_tpu_torch/online``,
``cli/online_nn``) on the CPU, held against the JAX package's
(``hpnn_tpu/online``) on the same seeded inputs, in float64, at small
widths.

* the sample buffer: byte-equal snapshots, reservoir replays and
  holdout sets (the RNG draws match draw for draw);
* the trainer: one round of a singleton (kernel #4's plain version) and
  of a 2-member group (#6's) gives candidate weights and final losses
  within 1e-12 of the JAX trainer's; ``scan_k`` = 2 equals two plain
  rounds;
* the gate: the same verdicts (promote, margin, NaN, no holdout), its
  eval losses within 1e-12;
* rollback answers bitwise as before the promotion, a promotion race
  never answers a torn mix, and the WAL's checkpoints restore bitwise
  across the two packages;
* ``POST /ingest``, the streams, ``online_nn.build_from_conf``;
* the card's rules as the CPU can hold them: a round never synchronizes
  the device, and once the trainer thread runs every capture (a forward
  built) happens on it.

Card-only cases live in test_torch_cuda.py.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from hpnn_tpu import obs as jobs
from hpnn_tpu import online as jonline
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.online import streams as jstreams
from hpnn_tpu.online import wal as jwal
from hpnn_tpu_torch import chaos, obs, online, runtime, serve
from hpnn_tpu_torch.cli import online_nn
from hpnn_tpu_torch.config import NNConf, NNTrain, NNType
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.online import promote, streams
from hpnn_tpu_torch.online import wal as wal_mod
from hpnn_tpu_torch.online.ingest import SampleBuffer
from hpnn_tpu_torch.serve import compile_cache, conn

TOL = 1e-12
ONLINE_KNOBS = ("HPNN_ONLINE_BUFFER", "HPNN_ONLINE_RESERVOIR",
                "HPNN_ONLINE_HOLDOUT", "HPNN_ONLINE_ROWS",
                "HPNN_ONLINE_BATCH", "HPNN_ONLINE_EPOCHS",
                "HPNN_ONLINE_INTERVAL_S", "HPNN_ONLINE_SCAN_K",
                "HPNN_ONLINE_MARGIN", "HPNN_ONLINE_WATCH_S", "HPNN_WAL_DIR",
                "HPNN_CHAOS", "HPNN_CHAOS_SEED", "HPNN_SERVE_MODE",
                "HPNN_SERVE_DTYPE", "HPNN_SERVE_FLEET", "HPNN_DTYPE")


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    """Clear every knob of both packages and forget their memos around
    each test."""
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, *ONLINE_KNOBS):
        monkeypatch.delenv(knob, raising=False)
    _reset_all()
    yield
    _reset_all()


def _reset_all():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    chaos._reset_for_tests()
    obs.slo._reset_for_tests()
    conn._reset_for_tests()
    compile_cache._reset_for_tests()
    wal_mod._reset_for_tests()
    jwal._reset_for_tests()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _kernels(seed, n_in=16, hidden=(8,), n_out=4):
    """The same generated kernel as each package's ``Kernel``."""
    return (jkm.generate(seed, n_in, list(hidden), n_out)[0],
            km.generate(seed, n_in, list(hidden), n_out)[0])


def _stream_block(n, seed=3, n_in=16, n_out=4):
    """A learnable block: targets a smooth function of the inputs."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.0, 1.0, size=(n, n_in))
    return X, np.tanh(X[:, :n_out])


def _sessions(**kw):
    """(JAX OnlineSession, port OnlineSession) with the same settings."""
    defaults = dict(rows=16, batch=8, epochs=4, interval_s=60.0, holdout=4,
                    seed=5)
    defaults.update(kw)
    serve_kw = dict(max_batch=8, n_buckets=2, max_wait_ms=1.0)
    margin = defaults.pop("margin", 0.0)
    jo = jonline.OnlineSession(
        serve_kwargs=serve_kw,
        gate=jonline.Gate(margin=margin, watch_s=30.0), **defaults)
    po = online.OnlineSession(
        serve_kwargs=dict(serve_kw, device="cpu"),
        gate=online.Gate(margin=margin, watch_s=30.0), **defaults)
    return jo, po


def _port_session(**kw):
    return _sessions(**kw)[1]


def _weights_of(osess, name):
    return tuple(np.asarray(w)
                 for w in osess.serve.registry.get(name).kernel.weights)


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(a, b))


def _tick_until_promoted(osess, max_ticks=6):
    for _ in range(max_ticks):
        summary = osess.tick()
        if summary["promoted"]:
            return summary
    raise AssertionError(f"no promotion within {max_ticks} rounds")


# ========================================================== the buffer
@pytest.mark.parametrize("reservoir,holdout", [(0, 8), (6, 4), (16, 0)])
def test_buffer_snapshots_match_jax_byte_for_byte(reservoir, holdout):
    """The same feeds (single rows and row blocks, past the ring's
    capacity) give byte-equal snapshots, reservoir replays, holdout sets
    and census: the ring, the reservoir's draws and the snapshot's
    replay picks follow the JAX buffer's RNG draw for draw."""
    clocks = (FakeClock(), FakeClock())
    bufs = [cls(capacity=24, reservoir=reservoir, holdout=holdout,
                holdout_cap=5, clock=c, seed=17)
            for cls, c in zip((jonline.SampleBuffer, SampleBuffer), clocks)]
    rng = np.random.RandomState(4)
    feeds = [rng.uniform(-1, 1, (n, 6)) for n in (1, 7, 13, 1, 30, 9)]
    for i, X in enumerate(feeds):
        T = np.tanh(X[:, :3])
        for b, c in zip(bufs, clocks):
            c.advance(0.25)
            assert b.feed(X[0] if len(X) == 1 else X,
                          T[0] if len(T) == 1 else T) == len(X)
        if bufs[0].depth() >= 12:
            snaps = [b.snapshot(12, replay_frac=0.5) for b in bufs]
            (jX, jT, jm), (pX, pT, pm) = snaps
            assert jX.tobytes() == pX.tobytes()
            assert jT.tobytes() == pT.tobytes()
            assert jm == pm
    j, p = bufs
    assert (j.depth(), j.holdout_depth(), j.total_fed(), j.dropped_total(),
            j.widths(), j.staleness_s()) == \
        (p.depth(), p.holdout_depth(), p.total_fed(), p.dropped_total(),
         p.widths(), p.staleness_s())
    je, pe = j.eval_snapshot(), p.eval_snapshot()
    if holdout:
        assert je[0].tobytes() == pe[0].tobytes()
        assert je[1].tobytes() == pe[1].tobytes()
    else:
        assert je is None and pe is None
    with pytest.raises(ValueError):
        p.feed(np.zeros(5), np.zeros(3))      # widths pinned at (6, 3)


# ========================================================= the trainer
def _group(model, members, hidden=(8,)):
    """Kernels named k0.. of one topology, as each package's Kernel."""
    return [(f"k{i}", *_kernels(9 + 2 * i, hidden=hidden))
            for i in range(members)]


def _add(jo, po, kernels, model):
    for name, jk, pk in kernels:
        jo.add_kernel(name, jk, model=model)
        po.add_kernel(name, pk, model=model)


@pytest.mark.parametrize("model", ["ann", "snn"])
@pytest.mark.parametrize("members", [1, 2])
def test_trainer_round_matches_jax(model, members):
    """One group's training on one window: the port's singleton path
    (#4's plain version) and 2-member path (#6's) give every candidate
    weight and the final loss within 1e-12 of the JAX trainer's (the
    same plan from the seed formula seed + 7919*round + i)."""
    jo, po = _sessions()
    _add(jo, po, _group(model, members), model)
    X, T = _stream_block(16, seed=3)
    names = [f"k{i}" for i in range(members)]
    jo.trainer._round = po.trainer._round = 3
    jres = jo.trainer._train_group(
        [jo.serve.registry.get(n) for n in names], X, T)
    pres = po.trainer._train_group(
        [po.serve.registry.get(n) for n in names], *po.trainer._window(X, T))
    assert set(jres) == set(pres) == set(names)
    for n in names:
        (jw, jl), (pw, pl) = jres[n], pres[n]
        assert all(np.asarray(w).dtype == np.float64 for w in pw)
        assert _max_diff(jw, pw) <= TOL
        assert abs(jl - pl) <= TOL
        # the candidate moved off the resident
        assert _max_diff(pw, _weights_of(po, n)) > 1e-6
    jo.close()
    po.close()


def test_round_once_matches_jax_with_mixed_topologies():
    """A whole round (snapshot, a 2-member group beside a singleton of
    another topology, the gate): the same outcomes, versions and
    resident weights within 1e-12 of the JAX session's."""
    jo, po = _sessions(eval_set=_stream_block(8, seed=8))
    _add(jo, po, _group("ann", 2), "ann")
    for jk, pk in [_kernels(13, hidden=(6,))]:
        jo.add_kernel("solo", jk)
        po.add_kernel("solo", pk)
    for o in (jo, po):
        o.feed(*_stream_block(40, seed=3))
    for _ in range(2):
        js, ps = jo.tick(), po.tick()
        assert js["outcomes"] == ps["outcomes"]
        assert {k: v for k, v in js.items() if k != "outcomes"} == \
            {k: v for k, v in ps.items() if k != "outcomes"}
    for n in ("k0", "k1", "solo"):
        assert jo.serve.registry.get(n).version == \
            po.serve.registry.get(n).version
        assert _max_diff(_weights_of(jo, n), _weights_of(po, n)) <= TOL
        jl, pl = jo.promoter.last_losses[n], po.promoter.last_losses[n]
        assert max(abs(a - b) for a, b in zip(jl, pl)) <= TOL
    jo.close()
    po.close()


@pytest.mark.parametrize("members", [1, 2])
def test_scan_k_two_equals_two_plain_rounds(members, monkeypatch):
    """``HPNN_ONLINE_SCAN_K=2`` trains two rounds in one call on one
    window: equal to two chained plain rounds (bitwise, the same plain
    epochs in the same order) and within 1e-12 of the JAX trainer's
    scan."""
    kernels = _group("ann", members)
    names = [n for n, _, _ in kernels]
    X, T = _stream_block(16, seed=3)
    monkeypatch.setenv("HPNN_ONLINE_SCAN_K", "2")
    jo, po = _sessions()
    monkeypatch.delenv("HPNN_ONLINE_SCAN_K")
    assert jo.trainer.scan_k == po.trainer.scan_k == 2
    _add(jo, po, kernels, "ann")
    scanned = po.trainer._train_group(
        [po.serve.registry.get(n) for n in names], *po.trainer._window(X, T))
    jscan = jo.trainer._train_group(
        [jo.serve.registry.get(n) for n in names], X, T)
    plain = _port_session()
    for name, _jk, pk in kernels:
        plain.add_kernel(name, pk)
    entries = [plain.serve.registry.get(n) for n in names]
    for r in range(2):
        plain.trainer._round = r
        res = plain.trainer._train_group(entries, *plain.trainer._window(X, T))
        entries = [e._replace(kernel=km.Kernel(weights=res[e.name][0]))
                   for e in entries]
    for n in names:
        assert all(np.array_equal(a, b)
                   for a, b in zip(scanned[n][0], res[n][0]))
        assert scanned[n][1] == res[n][1]
        assert _max_diff(scanned[n][0], jscan[n][0]) <= TOL
        assert abs(scanned[n][1] - jscan[n][1]) <= TOL
    # a scanned round advances the round counter by K
    po.feed(*_stream_block(40, seed=4))
    po.tick()
    assert po.trainer._round == 2
    for o in (jo, po, plain):
        o.close()


def test_trainer_validates_batch_and_scan_k():
    with pytest.raises(ValueError):
        _port_session(rows=16, batch=5)
    with pytest.raises(ValueError):
        online.OnlineTrainer(SampleBuffer(), _port_session().serve,
                             _port_session().promoter, scan_k=0)


# ============================================================ the gate
def _poison(name, w):
    bad = [np.asarray(x).copy() for x in w]
    bad[0][0, 0] = np.nan
    return tuple(bad)


@pytest.mark.parametrize("case", ["promote", "margin", "nan", "no_holdout"])
def test_gate_verdicts_match_jax(case):
    """The same candidate meets the same verdict in both gates, and the
    eval losses it was judged by agree within 1e-12."""
    kw = {"holdout": 0} if case == "no_holdout" else {}
    jo, po = _sessions(**kw)
    _add(jo, po, _group("ann", 1), "ann")
    for o in (jo, po):
        o.feed(*_stream_block(48, seed=3))
        if case == "margin":
            o.trainer.candidate_hook = \
                lambda name, w, _o=o: _weights_of(_o, name)
        elif case == "nan":
            o.trainer.candidate_hook = _poison
    js, ps = jo.tick(), po.tick()
    want = {"promote": "promoted", "margin": "margin", "nan": "sentinel",
            "no_holdout": "eval"}[case]
    assert js["outcomes"]["k0"] == ps["outcomes"]["k0"] == want
    assert jo.promoter.stats == po.promoter.stats
    assert jo.serve.registry.get("k0").version == \
        po.serve.registry.get("k0").version
    if case in ("promote", "margin"):
        jl, pl = jo.promoter.last_losses["k0"], po.promoter.last_losses["k0"]
        assert max(abs(a - b) for a, b in zip(jl, pl)) <= TOL
    jo.close()
    po.close()


@pytest.mark.parametrize("model", ["ann", "snn"])
def test_eval_loss_matches_jax(model):
    """The gate's score, one batched forward plus the model's per-row
    error, within 1e-12 of the JAX jit; one function per (model,
    topology, rows)."""
    jk, pk = _kernels(21)
    X, T = _stream_block(12, seed=6)
    if model == "snn":
        T = np.eye(4)[np.arange(12) % 4]
    ref = jonline.eval_loss(jk.weights, X, T, model=model)
    got = promote.eval_loss(pk.weights, X, T, model=model, device="cpu")
    assert abs(ref - got) <= TOL
    n = len(promote._EVAL_FNS)
    promote.eval_loss(pk.weights, X + 1.0, T, model=model, device="cpu")
    assert len(promote._EVAL_FNS) == n



def test_eval_loss_runs_on_the_card_unless_asked_for_the_cpu():
    """Without ``device`` the gate's eval resolves to the card and raises
    where there is none, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pk = _kernels(21)
    X, T = _stream_block(4, seed=6)
    with pytest.raises(runtime.DeviceUnavailable):
        promote.eval_loss(pk.weights, X, T)

# ================================================ rollback and install
def test_rollback_restores_bitwise_identical_answers():
    po = _port_session()
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(48, seed=3))
    X = np.linspace(-1.0, 1.0, 16)
    y_before = po.infer("k", X)
    _tick_until_promoted(po)
    assert not np.array_equal(y_before, po.infer("k", X))
    entry = po.rollback("k")
    assert entry is not None and entry.version == 2   # never rewinds
    assert np.array_equal(po.infer("k", X), y_before)   # bitwise
    assert po.rollback("k") is None
    po.close()


def test_promotion_race_answers_never_torn():
    """Clients racing promotions and rollbacks see the old answer or the
    new answer, bitwise — never a mix of versions."""
    po = _port_session(eval_set=_stream_block(16, seed=8))
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(48, seed=3))
    x = np.linspace(-1.0, 1.0, 16)
    y_old = po.infer("k", x)
    _tick_until_promoted(po)
    w_good = _weights_of(po, "k")
    y_new = po.infer("k", x)
    assert not np.array_equal(y_old, y_new)
    po.trainer.candidate_hook = lambda name, w: w_good
    stop = threading.Event()
    errors = []

    def churn():
        try:
            while not stop.is_set():
                po.rollback("k")
                po.tick()
        except Exception as exc:   # pragma: no cover
            errors.append(exc)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        for _ in range(120):
            y = po.infer("k", x)
            assert np.array_equal(y, y_old) or np.array_equal(y, y_new)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors
    assert po.promoter.stats["promoted"] >= 2
    po.close()


def test_watch_rolls_back_on_serve_numerics_regression(monkeypatch):
    monkeypatch.setenv("HPNN_PROBES", "1")
    obs._reset_for_tests()
    po = _port_session()
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(48, seed=3))
    _tick_until_promoted(po)
    assert po.promoter.watching("k")
    obs.probes.note_serve("k", rows=4, nan=2)
    assert po.promoter.check_watch() == ["k"]
    assert po.promoter.stats["rollbacks"] == 1
    assert not po.promoter.watching("k")
    po.close()


# ====================================================== the card's rules
def test_round_never_synchronizes_the_device(monkeypatch):
    """The trainer waits on its own stream only: a round (training, the
    gate, a promotion's install), the warm round and a queued rollback
    run with ``torch.cuda.synchronize`` made to raise."""
    def _raise(*a, **k):
        raise AssertionError("torch.cuda.synchronize on the trainer path")

    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    po = _port_session(interval_s=0.01)
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(64, seed=3))
    po.start()
    deadline = time.monotonic() + 20.0
    while (po.promoter.stats["promoted"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert po.promoter.stats["promoted"] >= 1
    assert po.rollback("k") is not None
    po.close()
    assert po.trainer.stats["failed"] == 0
    assert po.trainer.stats["rounds"] >= 1


def test_every_install_captures_on_the_trainer_thread():
    """Once the trainer thread runs it is the engine's only capturing
    thread: promotions, a rollback and a registration asked for from
    another thread all build their forwards on it; a capture asked for
    elsewhere raises; closing lifts the pin."""
    po = _port_session(interval_s=0.01)
    _, k = _kernels(9)
    po.add_kernel("k", k)
    capturers = []
    eng = po.serve.engine
    orig = eng._build_forward

    def build(*a, **kw):
        capturers.append(threading.current_thread())
        return orig(*a, **kw)

    eng._build_forward = build
    po.feed(*_stream_block(64, seed=3))
    po.start()
    deadline = time.monotonic() + 20.0
    while (po.promoter.stats["promoted"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert po.promoter.stats["promoted"] >= 1
    assert po.rollback("k") is not None            # asked from this thread
    _, k2 = _kernels(31)
    po.add_kernel("late", k2)                      # asked from this thread
    with pytest.raises(RuntimeError, match="captures on"):
        po.serve.install_kernel("k", km.Kernel(weights=_weights_of(po, "k")))
    trainer = po.trainer._thread
    po.close()
    assert capturers and all(t is trainer for t in capturers)
    assert eng._capture_thread is None
    assert "late" in po.kernels()


def test_rounds_failed_are_counted(monkeypatch):
    """A round that raises is counted and the loop goes on."""
    po = _port_session(interval_s=0.01)
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(64, seed=3))

    def boom(name, w):
        raise RuntimeError("injected")

    po.trainer.candidate_hook = boom
    po.start()
    deadline = time.monotonic() + 20.0
    while po.trainer.stats["failed"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    po.close()
    assert po.trainer.stats["failed"] >= 2


# ============================================================= the WAL
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_checkpoint_restores_bitwise_across_packages(tmp_path, writer):
    """A promotion committed by either package's WAL restores bitwise
    in the other's (the same checkpoint bytes and WAL records)."""
    _, k = _kernels(9)
    mixed = (k.weights[0], k.weights[1].astype(np.float32))
    W, R = ((jwal.PromotionWAL, wal_mod.PromotionWAL) if writer == "jax"
            else (wal_mod.PromotionWAL, jwal.PromotionWAL))
    w = W(str(tmp_path))
    w.commit("k", k.weights, version=1, model="ann", reason="promote",
             step=3)
    w.commit("k", mixed, version=2, model="snn", reason="promote", step=4)
    got, rec = R(str(tmp_path)).restore("k")
    assert rec["version"] == 2 and rec["model"] == "snn"
    assert [a.dtype for a in got] == [a.dtype for a in mixed]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, mixed))
    assert R(str(tmp_path)).records() == W(str(tmp_path)).records()


def test_online_session_replays_wal_bitwise(tmp_path):
    """A fresh session on the same WAL directory serves the promoted
    weights, bitwise, under a new version line."""
    wal = wal_mod.PromotionWAL(str(tmp_path))
    po = _port_session(wal=wal)
    _, k = _kernels(9)
    po.add_kernel("k", k)
    po.feed(*_stream_block(48, seed=3))
    _tick_until_promoted(po)
    promoted = _weights_of(po, "k")
    x = np.linspace(-1.0, 1.0, 16)
    y = po.infer("k", x)
    po.close()
    fresh = _port_session(wal=wal_mod.PromotionWAL(str(tmp_path)))
    fresh.add_kernel("k", k)
    assert fresh.restored == {"k": 1}
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(_weights_of(fresh, "k"), promoted))
    assert np.array_equal(fresh.infer("k", x), y)
    assert fresh.health_doc()["wal"]["restored"] == {"k": 1}
    fresh.close()


def test_wal_knob_arms_the_session(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_WAL_DIR", str(tmp_path))
    po = _port_session()
    assert po.wal is not None and po.wal.dir == str(tmp_path)
    po.close()


# ============================================================ HTTP edge
def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request("POST", path, body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = (r.status, json.loads(r.read() or b"{}"))
    c.close()
    return out


def _serving(session):
    server = serve.make_server(session, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def test_http_ingest_404_without_an_online_session():
    sess = serve.Session(max_batch=8, n_buckets=2, device="cpu")
    server, port = _serving(sess)
    try:
        status, _ = _post(port, "/ingest", {"inputs": [[0.0] * 16],
                                            "targets": [[0.0] * 4]})
        assert status == 404
    finally:
        server.shutdown()
        server.server_close()
        sess.close()


@pytest.mark.parametrize("path", ["/ingest", "/v1/ingest"])
def test_http_ingest_feeds_the_buffer(path):
    po = _port_session()
    _, k = _kernels(9)
    po.add_kernel("k", k)
    server, port = _serving(po.serve)
    try:
        X, T = _stream_block(16, seed=3)
        status, doc = _post(port, path, {"kernel": "k",
                                         "inputs": X.tolist(),
                                         "targets": T.tolist()})
        assert status == 200
        assert doc["accepted"] == 16 and doc["depth"] == 12   # 1 in 4 held out
        assert po.buffer.total_fed() == 16
        status, _ = _post(port, path, {"kernel": "nope",
                                       "inputs": X.tolist(),
                                       "targets": T.tolist()})
        assert status == 404
        status, _ = _post(port, path, {"inputs": X[:, :5].tolist(),
                                       "targets": T.tolist()})
        assert status == 400
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/healthz")
        health = json.loads(c.getresponse().read())
        c.close()
        assert health["online"]["buffer"]["fed"] == 16
        assert health["online"]["kernels"]["k"]["version"] == 0
    finally:
        server.shutdown()
        server.server_close()
        po.close()


# ====================================================== streams and CLI
@pytest.mark.parametrize("name", ["mnist", "xrd", "label_shift", "rotate_mnist",
                                  "rotate_xrd"])
def test_streams_match_jax_byte_for_byte(name):
    def make(mod):
        if name == "mnist":
            return mod.mnist_stream(4)
        if name == "xrd":
            return mod.xrd_stream(4, n_in=64, classes=5)
        if name == "label_shift":
            return mod.label_shift(mod.mnist_stream(2), 3, {1: 7, 7: 1})
        if name == "rotate_mnist":
            return mod.rotate(mod.mnist_stream(2), 2, 30.0)
        return mod.rotate(mod.xrd_stream(2, n_in=64, classes=5), 2, 45.0)

    jX, jT = jstreams.take(make(jstreams), 6)
    pX, pT = streams.take(make(streams), 6)
    assert jX.tobytes() == pX.tobytes() and jT.tobytes() == pT.tobytes()


def test_online_nn_build_from_conf_mnist_promotes():
    """``build_from_conf`` with ``--stream mnist`` pre-feeds the buffer
    and its session promotes within a few rounds; a width mismatch and
    an unknown stream are startup errors."""
    conf = NNConf(name="demo", type=NNType.SNN, seed=1,
                  kernel=km.generate(2, 784, [8], 10)[0],
                  train=NNTrain.BP, samples=None, tests=None)
    osess, server = online_nn.build_from_conf(
        conf, port=0, stream="mnist", stream_n=96, rows=32, batch=8,
        epochs=4, margin=0.0, device="cpu")
    try:
        assert osess.kernels() == ["demo"]
        assert osess.buffer.total_fed() == 96
        _tick_until_promoted(osess, max_ticks=4)
        assert osess.serve.registry.get("demo").version >= 1
    finally:
        server.server_close()
        osess.close()
    bad = NNConf(name="bad", type=NNType.ANN, seed=1,
                 kernel=km.generate(2, 16, [8], 4)[0], train=NNTrain.BP,
                 samples=None, tests=None)
    with pytest.raises(ValueError):
        online_nn.build_from_conf(bad, port=0, stream="mnist", stream_n=4,
                                  device="cpu")
    with pytest.raises(ValueError):
        online_nn.build_from_conf(bad, port=0, stream="nope", device="cpu")


def _readyz(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request("GET", "/readyz")
    status = c.getresponse().status
    c.close()
    return status


def test_online_nn_readyz_503_until_the_trainer_has_warmed(monkeypatch):
    """With ``defer_warmup`` the bound socket answers 503 on ``/readyz``
    through registration, the pre-feed and the trainer's warm round in
    ``start()``; ``warm()`` marks ready only once the trainer runs."""
    conf = NNConf(name="demo", type=NNType.ANN, seed=1,
                  kernel=km.generate(2, 784, [8], 10)[0],
                  train=NNTrain.BP, samples=None, tests=None)
    osess, server, warm = online_nn.build_from_conf(
        conf, port=0, stream="mnist", stream_n=32, rows=16, batch=8,
        epochs=1, interval_s=3600.0, defer_warmup=True, device="cpu")
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    seen = []
    trainer_warm = osess.trainer.warm

    def probed_warm():
        seen.append(("before", _readyz(port), osess.trainer.running()))
        trainer_warm()
        seen.append(("after", _readyz(port), osess.trainer.running()))

    monkeypatch.setattr(osess.trainer, "warm", probed_warm)
    try:
        assert _readyz(port) == 503
        warm()
        assert seen == [("before", 503, False), ("after", 503, False)]
        assert osess.trainer.running()
        assert _readyz(port) == 200
    finally:
        server.shutdown()
        server.server_close()
        osess.close()


def test_online_nn_cli_refuses_cuda_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    conf = tmp_path / "nn.conf"
    conf.write_text("[name] V\n[type] ANN\n[init] generate\n[seed] 1\n"
                    "[input] 8\n[hidden] 6\n[output] 2\n[train] BP\n")
    assert online_nn.main([str(conf)]) == -1
    assert "CUDA is not available" in capsys.readouterr().err
    assert online_nn.main(["--rows", "x", str(conf)]) == -1
