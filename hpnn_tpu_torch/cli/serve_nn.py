"""``serve_nn`` — keep a conf's kernel resident behind the HTTP front end
(the port of ``hpnn_tpu/cli/serve_nn.py``).

The third driver next to ``train_nn``/``run_nn``: where ``run_nn``
pays process start + kernel load per invocation, ``serve_nn`` loads the
conf's kernel once, captures the bucket menu (one CUDA graph a bucket
on the card) and answers ``POST /v1/infer`` until stopped.  The
single-dash flag grammar stays the reference's; serving knobs are long
options:

    python -m hpnn_tpu_torch.cli.serve_nn [-v] [--device cpu|cuda]
        [--port N] [--host H] [--max-batch N] [--max-wait-ms F]
        [--metrics PATH] [--sample P] [--capsule-dir DIR] nn.conf

The work runs on ``cuda`` unless ``--device cpu`` is given.
``--sample``/``--capsule-dir`` are the CLI twins of
``HPNN_SAMPLE``/``HPNN_CAPSULE_DIR`` (tail-latency forensics,
docs/observability.md): arm request sampling and alert/manual capture
capsules without touching the environment.

stdout stays silent (the token protocol belongs to train/run rounds);
all serving diagnostics go to stderr.
"""

from __future__ import annotations

import os
import sys

from hpnn_tpu_torch import config, obs, runtime
from hpnn_tpu_torch.cli import common

PROG = "serve_nn"
_MODEL_OF = {"ANN": "ann", "SNN": "snn"}


def build_from_conf(conf, *, max_batch: int = 64, n_buckets: int = 4,
                    max_wait_ms: float = 2.0, host: str = "127.0.0.1",
                    port: int = 0, device=None):
    """(session, server) for ``conf``'s kernel — the testable core of
    ``main``.  The kernel registers under ``conf.name``; port 0 binds
    an ephemeral port (read ``server.server_address``)."""
    from hpnn_tpu_torch import serve

    if conf.kernel is None:
        raise ValueError("conf has no kernel (missing [init] line?)")
    model = _MODEL_OF.get(conf.type.name)
    if model is None:
        raise ValueError(f"cannot serve kernel type {conf.type.name}")
    session = serve.Session(max_batch=max_batch, n_buckets=n_buckets,
                            max_wait_ms=max_wait_ms, device=device)
    name = conf.name or "default"
    session.register_kernel(name, conf.kernel, model=model)
    server = serve.make_server(session, host=host, port=port)
    return session, server


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv,
        valued=("port", "host", "max-batch", "max-wait-ms", "metrics",
                "device", "sample", "capsule-dir"),
    )
    if argv is None or not common.check_supported(opts, PROG):
        runtime.deinit_all()
        return -1
    if "sample" in opts or "capsule-dir" in opts:
        # twins must land BEFORE obs.configure so the registry's
        # file-less activation + hook arming see them
        if "sample" in opts:
            obs.forensics.configure(opts["sample"])
        if "capsule-dir" in opts:
            obs.triggers.configure(opts["capsule-dir"])
        if "metrics" not in opts:
            obs.configure(os.environ.get(obs.ENV_KNOB))
    if "metrics" in opts:
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
    try:
        session, server = build_from_conf(
            conf,
            max_batch=int(opts.get("max-batch", 64)),
            max_wait_ms=float(opts.get("max-wait-ms", 2.0)),
            host=opts.get("host", "127.0.0.1"),
            port=int(opts.get("port", 8700)),
            device=device,
        )
    except (ValueError, OSError) as exc:
        sys.stderr.write(f"{PROG}: cannot start: {exc}\n")
        runtime.deinit_all()
        return -1
    host, port = server.server_address[:2]
    sys.stderr.write(
        f"{PROG}: kernel {session.kernels()[0]!r} resident on "
        f"{session.engine.device}, buckets {list(session.engine.buckets)}, "
        f"listening on {host}:{port}\n")
    common.shield_sigpipe_for_server()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        session.close()
        runtime.deinit_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
