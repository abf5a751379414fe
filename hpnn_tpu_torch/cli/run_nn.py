"""``run_nn`` — load conf, evaluate the tests directory.

Mirrors the reference driver (ref: libhpnn tests/run_nn.c).
Run as ``python -m hpnn_tpu_torch.cli.run_nn [--device cpu|cuda] [--batch]
[--metrics PATH] [--ledger PATH] [--numerics warn|abort] [--export-port N]
[--profile DIR] [-v..] file.conf``; the work runs on ``cuda`` unless
``--device cpu`` is given.  ``--batch`` evaluates with one batched forward over the files
that share the first readable file's dims (``train/batch.py``).
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch import config, obs, runtime
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.train import batch, driver

PROG = "run_nn"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv, flags=("batch",),
        valued=("device", *common.OBS_OPTS, *common.DEFERRED_OPTS))
    if argv is None or not common.check_supported(opts, PROG):
        runtime.deinit_all()
        return -1
    ok, server = common.configure_obs(opts, PROG)
    if not ok:
        runtime.deinit_all()
        return -1
    try:
        return _run(argv, opts)
    finally:
        if server is not None:
            obs.export.stop_export_server(server)


def _run(argv: list[str], opts: dict) -> int:
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
    if opts.get("batch"):
        rc = common.run_workload(opts, lambda: batch.run_kernel_batched(conf, device=device))
    else:
        rc = common.run_workload(opts, lambda: driver.run_kernel(conf, device=device))
    runtime.deinit_all()
    return -1 if rc == -1 else 0


if __name__ == "__main__":
    sys.exit(main())
