"""``run_nn`` — load conf, evaluate the tests directory.

Mirrors the reference driver (ref: libhpnn tests/run_nn.c).
Run as ``python -m hpnn_tpu_torch.cli.run_nn [--device cpu|cuda] [--batch]
[-v..] file.conf``; the work runs on ``cuda`` unless ``--device cpu`` is
given.  ``--batch`` evaluates with one batched forward over the files
that share the first readable file's dims (``train/batch.py``).
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch import config, runtime
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.train import batch, driver

PROG = "run_nn"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    argv, opts = common.extract_long_opts(
        argv, flags=("batch",), valued=("device", *common.DEFERRED_OPTS))
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
    if opts.get("batch"):
        batch.run_kernel_batched(conf, device=device)
    else:
        driver.run_kernel(conf, device=device)
    runtime.deinit_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
