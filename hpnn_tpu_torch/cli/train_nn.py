"""``train_nn`` — load conf, dump kernel.tmp, train, dump kernel.opt.

Command-line and control flow mirror the reference driver
(ref: libhpnn tests/train_nn.c:59-255).  Run as
``python -m hpnn_tpu_torch.cli.train_nn [--device cpu|cuda]
[--batch B [--epochs E] [--lr X]] [--metrics PATH] [--ledger PATH]
[--numerics warn|abort] [--export-port N] [--profile DIR] [-v..]
file.conf``; the work runs on ``cuda`` unless ``--device cpu`` is
given.  Without ``--batch`` it is the faithful per-sample round
(``train/driver.py``); with it, minibatch training (``train/batch.py``).
The observability options (``cli/common.py``) never touch stdout.
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch import config, obs, runtime
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.train import batch, driver

PROG = "train_nn"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv, valued=("device", "batch", "epochs", "lr", *common.OBS_OPTS,
                      *common.DEFERRED_OPTS))
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
    for needs_batch in ("epochs", "lr"):
        if "batch" not in opts and needs_batch in opts:
            # per-sample mode keeps the reference's fixed learning rates
            # and epoch notion; these knobs exist for minibatch SGD only
            sys.stderr.write(f"syntax error: --{needs_batch} requires --batch!\n")
            runtime.deinit_all()
            return -1
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
    if not _dump_kernel_file(conf, "kernel.tmp"):
        sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
        runtime.deinit_all()
        return -1
    if "batch" in opts:
        ok = common.run_workload(opts, lambda: batch.train_kernel_batched(
            conf, batch_size=int(opts["batch"]),
            epochs=int(opts.get("epochs", "1")),
            lr=float(opts["lr"]) if "lr" in opts else None, device=device))
    else:
        ok = common.run_workload(opts, lambda: driver.train_kernel(conf, device=device))
    if ok == -1:  # the numerics sentinel aborted (message printed)
        runtime.deinit_all()
        return -1
    if not ok:
        sys.stderr.write("FAILED to train kernel!\n")
        runtime.deinit_all()
        return -1
    if not _dump_kernel_file(conf, "kernel.opt"):
        sys.stderr.write("FAILED to open kernel.opt for WRITE!\n")
        runtime.deinit_all()
        return -1
    runtime.deinit_all()
    return 0


def _dump_kernel_file(conf, path: str) -> bool:
    try:
        with open(path, "w") as fp:
            config.dump_kernel(conf, fp)
        return True
    except OSError:
        return False


if __name__ == "__main__":
    sys.exit(main())
