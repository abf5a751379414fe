"""``POST /v1/reload`` on the port's serving and online paths.

A reload re-reads a kernel's backing file as a new version.  It must
capture that version's bucket menu BEFORE the registry publishes it (as
``Session.install_kernel`` does), so no batcher meets a version without
its forwards and builds one on its own thread; and on a started online
session it runs on the trainer thread, the engine's only capturing
thread (``Engine.pin_captures``).  A fleet's install fans exactly this
request out to every worker (``hpnn_tpu_torch/fleet/router.py``).
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from hpnn_tpu_torch import chaos, obs, online, runtime, serve
from hpnn_tpu_torch.fileio import checkpoint
from hpnn_tpu_torch.models import ann
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.online import wal as wal_mod
from hpnn_tpu_torch.serve import compile_cache, conn


@pytest.fixture(autouse=True)
def _no_obs_knobs(monkeypatch):
    for knob in (*runtime.DEFERRED_ENV, *obs.ENV_KNOBS, "HPNN_WAL_DIR",
                 "HPNN_CHAOS", "HPNN_SERVE_MODE", "HPNN_SERVE_DTYPE",
                 "HPNN_SERVE_FLEET", "HPNN_DTYPE"):
        monkeypatch.delenv(knob, raising=False)
    _reset()
    yield
    _reset()


def _reset():
    obs._reset_for_tests()
    chaos._reset_for_tests()
    obs.slo._reset_for_tests()
    conn._reset_for_tests()
    compile_cache._reset_for_tests()
    wal_mod._reset_for_tests()


def _kernel(seed):
    return km.generate(seed, 8, [5], 2)[0]


def _ref(k, X):
    """The per-row forward the CPU's parity mode answers with."""
    ws = [torch.from_numpy(np.asarray(w)) for w in k.weights]
    return np.stack([ann.run(ws, torch.from_numpy(x)).numpy()
                     for x in np.atleast_2d(X)])


def _write(path, k, version):
    checkpoint.dump_checkpoint(path, "k", k.weights, version=version)
    # a new staleness signature even within one clock tick
    os.utime(path, ns=(version * 10**9, version * 10**9))


def _capturers(engine):
    """Record the thread of every forward the engine builds."""
    seen = []
    orig = engine._build_forward

    def build(*a, **kw):
        seen.append(threading.current_thread())
        return orig(*a, **kw)

    engine._build_forward = build
    return seen


def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", path, body=json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = (r.status, json.loads(r.read() or b"{}"))
    c.close()
    return out


def _serving(session):
    server = serve.make_server(session, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


@pytest.mark.parametrize("how", ["reload", "maybe_reload"])
def test_a_reload_captures_before_it_publishes(tmp_path, how):
    """The instant a reload's version is published, an infer on a
    batcher thread finds its forwards: every forward of the new version
    was built on the reloading thread."""
    path = str(tmp_path / "k.ckpt")
    _write(path, _kernel(3), 1)
    sess = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=0.5,
                         device="cpu")
    try:
        sess.load_kernel("k", path)
        seen = _capturers(sess.engine)
        x = np.linspace(-1.0, 1.0, 8)
        answers = []
        register = sess.registry.register

        def register_then_infer(*a, **kw):
            entry = register(*a, **kw)
            # a request between the publish and whatever follows it
            answers.append(sess.infer("k", x, timeout_s=10.0))
            return entry

        sess.registry.register = register_then_infer
        k_new = _kernel(5)
        _write(path, k_new, 2)
        if how == "reload":
            assert sess.reload("k").version == 1
        else:
            assert sess.maybe_reload("k") is True
        assert seen and all(t is threading.main_thread() for t in seen)
        assert np.array_equal(answers[-1], _ref(k_new, x)[0])
    finally:
        sess.close()


def test_reloads_under_concurrent_infers_answer_one_version(tmp_path):
    """Four threads infer while the file flips between versions and
    reloads publish them: no batcher thread builds a forward (captures
    are pinned to the reloading thread, and the warmup after each
    publish is slowed), and every answer is bitwise one version's."""
    path = str(tmp_path / "k.ckpt")
    ks = [_kernel(s) for s in (3, 5, 7, 11)]
    X = np.linspace(-1.0, 1.0, 24).reshape(3, 8)
    allowed = [_ref(k, X) for k in ks]
    _write(path, ks[0], 1)
    sess = serve.Session(max_batch=8, n_buckets=2, max_wait_ms=0.5,
                         device="cpu")
    sess.load_kernel("k", path)
    warmup = sess.engine.warmup

    def slow_warmup(*a, **kw):
        # a wide window after the publish: the infers run into it
        time.sleep(0.05)
        return warmup(*a, **kw)

    sess.engine.warmup = slow_warmup
    sess.engine.pin_captures(threading.current_thread())
    stop = threading.Event()
    bad, errors, served = [], [], [0]

    def infer_loop():
        while not stop.is_set():
            try:
                out = sess.infer("k", X, timeout_s=10.0)
            except Exception as exc:     # a capture off the pin raises
                errors.append(exc)
                return
            if not any(np.array_equal(out, a) for a in allowed):
                bad.append(out)
                return
            served[0] += 1

    threads = [threading.Thread(target=infer_loop) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i, k in enumerate(ks[1:] * 2, start=2):
            time.sleep(0.02)
            _write(path, k, i)
            sess.reload("k")
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sess.engine.pin_captures(None)
        sess.close()
    assert not errors, errors[0]
    assert not bad, "an answer matched no version"
    assert served[0] > 0


def test_a_started_online_session_reloads_over_http_on_its_trainer(tmp_path):
    """An online worker restored from its WAL answers ``POST /v1/reload``
    with 200 and the next version once its trainer thread runs; the
    reload's captures run on that thread and the answers are the file's
    new weights."""
    wal_dir = str(tmp_path / "wal")
    rec = wal_mod.PromotionWAL(wal_dir).commit(
        "k", _kernel(3).weights, version=1, reason="seed")
    po = online.OnlineSession(
        serve_kwargs=dict(max_batch=8, n_buckets=2, max_wait_ms=0.5,
                          device="cpu"),
        wal=wal_mod.PromotionWAL(wal_dir), rows=16, batch=8, epochs=2,
        interval_s=600.0)
    server = None
    try:
        entry = po.add_kernel("k", _kernel(99))
        assert po.restored == {"k": 1}
        seen = _capturers(po.serve.engine)
        po.start()
        k_new = _kernel(5)
        _write(os.path.join(wal_dir, rec["ckpt"]), k_new, 2)
        server, port = _serving(po.serve)
        status, body = _post(port, "/v1/reload", {"kernel": "k"})
        assert (status, body.get("version")) == (200, entry.version + 1), body
        assert seen and all(t is po.trainer._thread for t in seen)
        x = np.linspace(-1.0, 1.0, 8)
        assert np.array_equal(po.infer("k", x, timeout_s=10.0),
                              _ref(k_new, x)[0])
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        po.close()


def test_a_replicated_router_reloads_through_each_replica(tmp_path):
    """The router's registry facade reloads through every replica's
    ``Session.reload``: each replica publishes the next version with its
    forwards built on the reloading thread, and answers its weights."""
    path = str(tmp_path / "k.ckpt")
    _write(path, _kernel(3), 1)
    router = serve.Router(2, max_batch=8, n_buckets=2, max_wait_ms=0.5,
                          device="cpu")
    try:
        router.load_kernel("k", path)
        seen = [t for rep in router.replicas for t in [_capturers(rep.engine)]]
        k_new = _kernel(5)
        _write(path, k_new, 2)
        router.registry.reload("k")
        x = np.linspace(-1.0, 1.0, 8)
        for rep, built in zip(router.replicas, seen):
            assert rep.registry.get("k").version == 1
            assert built and all(t is threading.main_thread() for t in built)
            assert np.array_equal(rep.infer("k", x, timeout_s=10.0),
                                  _ref(k_new, x)[0])
    finally:
        router.close()
