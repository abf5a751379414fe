"""``train_nn`` — load conf, dump kernel.tmp, train, dump kernel.opt.

Command-line and control flow mirror the reference driver
(ref: libhpnn tests/train_nn.c:59-255).  Run as
``python -m hpnn_tpu_torch.cli.train_nn [--device cpu|cuda]
[--batch B [--epochs E] [--lr X]] [--mesh DxM] [--metrics PATH]
[--ledger PATH] [--numerics warn|abort] [--export-port N]
[--profile DIR] [-v..] file.conf``; the work runs on ``cuda`` unless
``--device cpu`` is given.  Without ``--batch`` it is the faithful
per-sample round (``train/driver.py``), tensor-parallel over M ranks
with ``--mesh 1xM``; with it, minibatch training (``train/batch.py``),
over D data shards of M row blocks with ``--mesh DxM``
(``cli/common.py`` says how the ranks start).
The observability options (``cli/common.py``) never touch stdout.
"""

from __future__ import annotations

import os
import sys

from hpnn_tpu_torch import config, obs, runtime
from hpnn_tpu_torch.cli import common
from hpnn_tpu_torch.parallel import dist
from hpnn_tpu_torch.parallel import mesh as mesh_mod
from hpnn_tpu_torch.train import batch, driver

PROG = "train_nn"


def main(argv: list[str] | None = None) -> int:
    with obs.spans.span("train_nn.round"):
        return _main(argv)


def _main(argv: list[str] | None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    runtime.init_all(1)
    full = list(argv)
    argv, opts = common.extract_long_opts(
        argv, valued=("device", "batch", "epochs", "lr", "mesh", *common.OBS_OPTS))
    if argv is None or not common.check_supported(opts, PROG):
        runtime.deinit_all()
        return -1
    for needs_batch in ("epochs", "lr"):
        if "batch" not in opts and needs_batch in opts:
            # per-sample mode keeps the reference's fixed learning rates
            # and epoch notion; these knobs exist for minibatch SGD only
            sys.stderr.write(f"syntax error: --{needs_batch} requires --batch!\n")
            runtime.deinit_all()
            return -1
    shape = None
    if "mesh" in opts:
        try:
            # per-sample TP: the reference's `mpirun -np X train_nn` mode
            shape = (mesh_mod.parse_spec(opts["mesh"]) if "batch" in opts
                     else common.tp_mesh(opts["mesh"]))
        except ValueError as exc:
            sys.stderr.write(f"syntax error: bad --mesh: {exc}\n")
            runtime.deinit_all()
            return -1
    # the ranks parse the flags themselves: the launching process only
    # starts them (rank 0 prints the help or a flag's error)
    filename = None if common.spawns(shape) else common.parse_args(argv, PROG)
    if filename is None and not common.spawns(shape):
        runtime.deinit_all()
        return 0
    kind, got = common.start_world(full, opts, PROG, shape)
    if kind != "mesh":  # the ranks ran (their exit code) or an error was said
        runtime.deinit_all()
        return got
    try:
        ok, server = common.configure_obs(opts, PROG)
        if not ok:
            runtime.deinit_all()
            return -1
        try:
            return _run(filename, opts, got)
        finally:
            if server is not None:
                obs.export.stop_export_server(server)
    finally:
        dist.shutdown()


def _run(filename: str, opts: dict, mesh) -> int:
    device = mesh.device if mesh is not None else common.resolve_device(opts, PROG)
    if device is None:
        runtime.deinit_all()
        return -1
    with obs.spans.span("io.conf_load") as sp:
        conf = config.load_conf(filename)
        if sp.id is not None:
            obs.spans.finish(sp, bytes=_conf_bytes(filename, conf))
    if conf is None:
        sys.stderr.write("FAILED to read NN configuration file! (ABORTING)\n")
        runtime.deinit_all()
        return -1
    # in a world rank 0 alone writes the kernel files (the reference's
    # rank-0 ann_dump + barrier, ref: src/ann.c:787-856) and its outcome
    # is given to every rank, so no rank goes on into collective
    # training while rank 0 aborts
    rank0 = runtime.process_index() == 0
    if not dist.sync_rank0_ok(_dump_kernel_file(conf, "kernel.tmp") if rank0 else True):
        if rank0:
            sys.stderr.write("FAILED to open kernel.tmp for WRITE!\n")
        runtime.deinit_all()
        return -1
    if "batch" in opts:
        ok = common.run_workload(opts, lambda: batch.train_kernel_batched(
            conf, batch_size=int(opts["batch"]),
            epochs=int(opts.get("epochs", "1")),
            lr=float(opts["lr"]) if "lr" in opts else None, device=device,
            mesh=mesh))
    else:
        ok = common.run_workload(
            opts, lambda: driver.train_kernel(conf, mesh=mesh, device=device))
    if ok == -1:  # the numerics sentinel aborted (message printed)
        runtime.deinit_all()
        return -1
    if not ok:
        sys.stderr.write("FAILED to train kernel!\n")
        runtime.deinit_all()
        return -1
    if not dist.sync_rank0_ok(_dump_kernel_file(conf, "kernel.opt") if rank0 else True):
        if rank0:
            sys.stderr.write("FAILED to open kernel.opt for WRITE!\n")
        runtime.deinit_all()
        return -1
    runtime.deinit_all()
    return 0


def _conf_bytes(filename: str, conf) -> int:
    """The bytes the conf load read: the conf and its ``[init]`` kernel
    file."""
    paths = [filename] + ([conf.f_kernel] if conf is not None and conf.f_kernel else [])
    try:
        return sum(os.path.getsize(p) for p in paths)
    except OSError:
        return 0


def _dump_kernel_file(conf, path: str) -> bool:
    with obs.spans.span("io.kernel_dump", path=path) as sp:
        try:
            with open(path, "w") as fp:
                config.dump_kernel(conf, fp)
                n = fp.tell()
        except OSError:
            return False
        obs.spans.finish(sp, bytes=n)
        return True


if __name__ == "__main__":
    sys.exit(main())
