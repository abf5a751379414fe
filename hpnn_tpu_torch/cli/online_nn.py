"""``online_nn`` — train-while-serve a conf's kernel in one resident
process (the port of ``hpnn_tpu/cli/online_nn.py``).

The fourth CLI: where ``serve_nn`` keeps a frozen kernel resident,
``online_nn`` keeps it *learning* — the HTTP front end gains
``POST /ingest``, a background trainer snapshots the stream buffer
every ``--interval-s``, and sentinel-clean candidates that beat the
resident on the held-out eval are promoted atomically
(docs/online.md).  ``--stream mnist|xrd`` pre-feeds N synthetic
samples so the demo loop promotes without an external feeder.

    python -m hpnn_tpu_torch.cli.online_nn [-v] [--device cpu|cuda]
        [--port N] [--host H] [--metrics PATH] [--interval-s F]
        [--rows N] [--batch N] [--epochs N] [--margin F]
        [--stream mnist|xrd] [--stream-n N] nn.conf

The work runs on ``cuda`` unless ``--device cpu`` is given.  The
``HPNN_ONLINE_*`` knobs and ``HPNN_WAL_DIR`` are honoured as in the JAX
package (a flag wins over its knob).

The HTTP socket is bound first and answers 503 while the process
warms; the warmup (kernel registration, promotion-WAL replay, the
bucket menu's captures, the stream pre-feed, then the trainer's warm
round) runs on the main thread, and the server on a thread of its own.
Once ready, the trainer thread is the only thread that captures
(``serve/engine.py``).

stdout stays silent (token protocol); diagnostics go to stderr.
"""

from __future__ import annotations

import sys
import threading

from hpnn_tpu_torch import config, runtime
from hpnn_tpu_torch.cli import common

PROG = "online_nn"
_MODEL_OF = {"ANN": "ann", "SNN": "snn"}


def build_from_conf(conf, *, host: str = "127.0.0.1", port: int = 0,
                    interval_s: float | None = None,
                    rows: int | None = None, batch: int | None = None,
                    epochs: int | None = None,
                    margin: float | None = None,
                    stream: str | None = None, stream_n: int = 256,
                    seed: int = 0, defer_warmup: bool = False,
                    device=None):
    """(online_session, server) for ``conf``'s kernel — the testable
    core of ``main``.  ``stream`` pre-feeds the buffer from a demo
    stream generator (the kernel widths must match the stream's).

    ``defer_warmup=True`` returns ``(osess, server, warm)`` instead:
    the HTTP socket is bound *first* with the session marked unready
    (``/readyz`` and the POST routes answer 503 + Retry-After), and
    the caller runs ``warm()`` on the thread that is to capture:
    kernel registration, promotion-WAL replay, bucket warmup, stream
    pre-feed, ``osess.start()`` (the trainer's warm round on the calling
    thread, then the trainer thread), and only then ``mark_ready``.
    Without ``defer_warmup`` the kernel is registered and the stream
    fed, and the caller starts the trainer."""
    from hpnn_tpu_torch import online, serve
    from hpnn_tpu_torch.online import streams

    if conf.kernel is None:
        raise ValueError("conf has no kernel (missing [init] line?)")
    model = _MODEL_OF.get(conf.type.name)
    if model is None:
        raise ValueError(f"cannot serve kernel type {conf.type.name}")
    makers = {"mnist": streams.mnist_stream, "xrd": streams.xrd_stream}
    if stream and stream not in makers:
        raise ValueError(f"unknown stream {stream!r} (want mnist|xrd)")
    gate = online.Gate(margin=margin) if margin is not None else None
    osess = online.OnlineSession(
        serve_kwargs={"device": device}, interval_s=interval_s, rows=rows,
        batch=batch, epochs=epochs, gate=gate, seed=seed)
    name = conf.name or "default"

    def load():
        osess.add_kernel(name, conf.kernel, model=model)
        if stream:
            X, T = streams.take(makers[stream](seed), stream_n)
            if X.shape[1] != conf.kernel.n_inputs:
                raise ValueError(
                    f"stream {stream!r} feeds {X.shape[1]} inputs but "
                    f"the kernel takes {conf.kernel.n_inputs}")
            osess.feed(X, T)

    def warm():
        load()
        osess.start()
        osess.serve.mark_ready()

    if defer_warmup:
        osess.serve.mark_unready("warming")
        server = serve.make_server(osess.serve, host=host, port=port)
        return osess, server, warm
    load()
    server = serve.make_server(osess.serve, host=host, port=port)
    return osess, server


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv,
        valued=("port", "host", "metrics", "interval-s", "rows",
                "batch", "epochs", "margin", "stream", "stream-n",
                "device"),
    )
    if argv is None or not common.check_supported(opts, PROG):
        runtime.deinit_all()
        return -1
    if "metrics" in opts:
        from hpnn_tpu_torch import obs

        obs.configure(opts["metrics"])
    filename = common.parse_args(argv, PROG)
    if filename is None:
        runtime.deinit_all()
        return 0
    device = common.resolve_device(opts, PROG)
    if device is None:
        runtime.deinit_all()
        return -1
    conf = config.load_conf(filename)
    if conf is None:
        sys.stderr.write("FAILED to read NN configuration file! (ABORTING)\n")
        runtime.deinit_all()
        return -1
    from hpnn_tpu_torch import serve

    try:
        osess, server, warm = build_from_conf(
            conf,
            host=opts.get("host", "127.0.0.1"),
            port=int(opts.get("port", 8700)),
            interval_s=(float(opts["interval-s"])
                        if "interval-s" in opts else None),
            rows=int(opts["rows"]) if "rows" in opts else None,
            batch=int(opts["batch"]) if "batch" in opts else None,
            epochs=int(opts["epochs"]) if "epochs" in opts else None,
            margin=(float(opts["margin"]) if "margin" in opts
                    else None),
            stream=opts.get("stream"),
            stream_n=int(opts.get("stream-n", 256)),
            defer_warmup=True,
            device=device,
        )
    except (ValueError, OSError) as exc:
        sys.stderr.write(f"{PROG}: cannot start: {exc}\n")
        runtime.deinit_all()
        return -1
    host, port = server.server_address[:2]
    sys.stderr.write(
        f"{PROG}: listening on {host}:{port} (warming — /readyz "
        "answers 503 until the bucket menu is captured, any "
        "promotion WAL is replayed and the trainer has warmed)\n")
    # SIGTERM → graceful drain (503 for new arrivals, in-flight
    # flushed, obs/flight postmortem exactly once, exit 0)
    serve.install_drain(server, osess.serve)
    common.shield_sigpipe_for_server()
    # the socket answers (503) from its own thread while this thread
    # warms: the captures of boot run here, the later ones on the
    # trainer thread
    http = threading.Thread(target=server.serve_forever, daemon=True,
                            name="hpnn-online-http")
    http.start()
    rc = 0
    try:
        try:
            warm()
        except Exception as exc:
            sys.stderr.write(f"{PROG}: cannot start: {exc}\n")
            rc = -1
            server.shutdown()
        else:
            sys.stderr.write(
                f"{PROG}: kernel {osess.kernels()[0]!r} resident on "
                f"{osess.serve.engine.device} and learning (window "
                f"{osess.trainer.rows}, every {osess.trainer.interval_s}s), "
                f"ready on {host}:{port}\n")
        while http.is_alive():
            http.join(0.5)
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        osess.close()
        runtime.deinit_all()
    return rc


if __name__ == "__main__":
    sys.exit(main())
