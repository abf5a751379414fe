"""``train_nn`` — load conf, dump kernel.tmp, train, dump kernel.opt.

Command-line and control flow mirror the reference driver
(ref: libhpnn tests/train_nn.c:59-255).  Run as
``python -m hpnn_tpu_torch.cli.train_nn [--device cpu|cuda] [-v..] file.conf``;
the work runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch import config, runtime
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.train import driver

PROG = "train_nn"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv, valued=("device", *common.DEFERRED_OPTS))
    if argv is None or not common.check_supported(opts, PROG):
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
    if not driver.train_kernel(conf, device=device):
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
