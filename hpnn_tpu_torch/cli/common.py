"""Shared CLI argument handling for train_nn / run_nn / serve_nn.

Reproduces the reference CLIs' flag grammar
(ref: libhpnn tests/train_nn.c:59-255, tests/run_nn.c):
``-h`` help, ``-v`` (repeatable/combinable) verbosity, ``-x`` dry
toggle, ``-O n``/``-On`` OMP threads, ``-B n``/``-Bn`` BLAS threads,
``-S n``/``-Sn`` CUDA-stream count (advisory), plus one positional
``.conf`` file (default ``./nn.conf``).

Long options are pulled out first.  ``--device cpu|cuda`` (default
``cuda``) picks where the work runs; ``--batch N``, ``--epochs E`` and
``--lr X`` select minibatch training (``train_nn``) and ``--batch`` the
batched eval (``run_nn``).  The observability options are the JAX
package's: ``--metrics PATH`` (``HPNN_METRICS``), ``--ledger PATH``
(``HPNN_LEDGER``), ``--numerics warn|abort`` (``HPNN_NUMERICS``),
``--export-port N`` (a live ``/metrics`` endpoint) and ``--profile DIR``
(a ``torch.profiler`` trace of the workload).  The environment knob of
``runtime.DEFERRED_ENV`` (XLA's executable cache) is refused with a
message.

``--mesh DxM`` runs the work on D×M ranks (``parallel/dist.py``): D
data shards (``--batch`` only) of M row blocks.  Under a launcher that
sets the torchrun environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) each process joins
that world; without it the CLI starts its D×M local ranks itself and
exits with their exit code.  Rank 0 alone prints, writes the kernel
files and serves ``--export-port``.
"""

from __future__ import annotations

import signal
import sys

import torch

from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.parallel import mesh as mesh_mod

DEVICES = ("cpu", "cuda")

# long option -> the path of the JAX package it belongs to (none left)
DEFERRED_OPTS: dict = {}
# the observability options both CLIs take (valued)
OBS_OPTS = ("metrics", "ledger", "numerics", "export-port", "profile")


def install_sigpipe_handler() -> None:
    """Die quietly when stdout is a closed pipe (e.g. ``train_nn -h | head``)."""
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (ValueError, AttributeError):
        pass


def shield_sigpipe_for_server() -> None:
    """Put SIGPIPE back to ignored before entering a serve loop: with
    the token CLIs' SIG_DFL armed, a write to a peer-reset socket would
    kill the server instead of raising the BrokenPipeError its handlers
    turn into a counted close.  Call after argument/help handling,
    before ``serve_forever``."""
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    except (ValueError, AttributeError):
        pass


def dump_help(prog: str) -> None:
    w = sys.stdout.write
    w("***********************************\n")
    w(f"usage:  {prog} [-options] [input]\n")
    w("***********************************\n")
    w("options:\n")
    w("-h \tdisplay this help;\n")
    w("-v \tincrease verbosity;\n")
    w("-x \tdiscard results.\n")
    w("-O \tnumber of openMP threads.\n")
    w("-B \tnumber of BLAS threads (MKL).\n")
    w("-S \tnumber of CUDA streams.\n")
    w("***********************************\n")
    w("input:     neural network .def file\n")
    w("contains the network definition and\n")
    w("topology. May contain weight values\n")
    w("or context for a random generation.\n")
    w("***********************************\n")


def extract_long_opts(argv: list[str], *, flags=(), valued=()):
    """Pull ``--name [value]`` options out of argv before the
    reference flag grammar runs (the single-dash grammar stays
    byte-compatible with the C CLIs).

    Returns (remaining_argv, opts dict) or (None, None) on error.
    """
    out = {}
    rest = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            name = arg[2:]
            val = None
            if "=" in name:
                name, val = name.split("=", 1)
            if name in flags and val is None:
                out[name] = True
            elif name in valued:
                if val is None:
                    i += 1
                    if i >= len(argv):
                        sys.stderr.write(f"syntax error: --{name} needs a value\n")
                        return None, None
                    val = argv[i]
                out[name] = val
            else:
                sys.stderr.write(f"syntax error: unrecognized option --{name}\n")
                return None, None
        else:
            rest.append(arg)
        i += 1
    return rest, out


def check_supported(opts: dict, prog: str) -> bool:
    """Refuse (with a message) the options (:data:`DEFERRED_OPTS`) and
    knobs of paths this package does not have, and a bad ``--device``,
    ``--batch``, ``--epochs``, ``--lr``, ``--mesh``, ``--max-batch``,
    ``--max-wait-ms`` or port value; never ignore them."""
    for name in opts:
        if name in DEFERRED_OPTS:
            sys.stderr.write(
                f"{prog}: --{name} is not supported by hpnn_tpu_torch: "
                f"{DEFERRED_OPTS[name]} is not ported yet (hpnn_tpu's "
                f"{prog} has it)\n")
            return False
    msg = runtime.deferred_env_message(prog)
    if msg:
        sys.stderr.write(msg + "\n")
        return False
    for name in ("batch", "epochs", "max-batch"):
        v = opts.get(name)
        if v is not None and v is not True and (not str(v).isdigit() or int(v) < 1):
            sys.stderr.write(f"syntax error: bad --{name} parameter!\n")
            return False
    lr = opts.get("lr")
    if lr is not None:
        try:
            ok = float(lr) > 0.0
        except ValueError:
            ok = False
        if not ok:
            sys.stderr.write("syntax error: bad --lr parameter!\n")
            return False
    dev = opts.get("device")
    if dev is not None and dev not in DEVICES:
        sys.stderr.write(f"syntax error: bad --device parameter (want cpu|cuda)!\n")
        return False
    if opts.get("mesh") is not None:
        try:
            mesh_mod.parse_spec(opts["mesh"])
        except ValueError:
            sys.stderr.write("syntax error: bad --mesh parameter (want DxM)!\n")
            return False
    for name in ("export-port", "port"):
        port = opts.get(name)
        if port is not None and (not str(port).isdigit() or int(port) > 65535):
            sys.stderr.write(f"syntax error: bad --{name} parameter!\n")
            return False
    wait = opts.get("max-wait-ms")
    if wait is not None:
        try:
            ok = float(wait) >= 0.0
        except ValueError:
            ok = False
        if not ok:
            sys.stderr.write("syntax error: bad --max-wait-ms parameter!\n")
            return False
    if opts.get("numerics") not in (None, "warn", "abort"):
        sys.stderr.write(
            "syntax error: bad --numerics parameter (want warn|abort)!\n")
        return False
    return True


def configure_obs(opts: dict, prog: str):
    """Apply the observability options (each flag wins over its env
    knob) and start the ``--export-port`` server.  Returns ``(ok,
    server)``: ``ok`` False (message printed) when the port cannot be
    bound; ``server`` the running server or None."""
    from hpnn_tpu_torch import obs

    if "metrics" in opts:
        obs.configure(opts["metrics"])
    if "ledger" in opts:
        obs.ledger.configure(opts["ledger"])
    if "numerics" in opts:
        obs.probes.configure_mode(opts["numerics"])
    if "export-port" not in opts or runtime.process_index() != 0:
        return True, None
    try:
        server = obs.export.start_export_server(port=int(opts["export-port"]))
    except OSError as exc:
        sys.stderr.write(f"{prog}: cannot bind --export-port: {exc}\n")
        return False, None
    host, port = server.server_address[:2]
    sys.stderr.write(f"{prog}: metrics export on http://{host}:{port}/metrics\n")
    return True, server


def run_workload(opts: dict, work):
    """``work()`` inside the ``--profile`` trace.  A numerics-sentinel
    abort prints its message and returns -1 (the events, the sink flush
    and the flight dump already happened); otherwise returns
    ``work()``'s value."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.obs import profiler

    try:
        with profiler.trace(opts.get("profile")):
            return work()
    except obs.probes.NumericsError as exc:
        sys.stderr.write(f"FAILED: numerics sentinel abort: {exc}\n")
        return -1


def resolve_device(opts: dict, prog: str):
    """The run's torch device, or None (message printed) when CUDA was
    asked for, explicitly or by default, and is absent."""
    try:
        return runtime.resolve_device(opts.get("device", "cuda"))
    except runtime.DeviceUnavailable as exc:
        sys.stderr.write(f"{prog}: {exc}\n")
        return None


def tp_mesh(spec: str) -> tuple[int, int]:
    """``(1, M)`` from a per-sample ``--mesh 1xM``.

    The reference's distributed mode is ``mpirun -np X`` with every
    layer row-split across all X ranks (ref: src/ann.c:912-936) — no
    data axis.  A data axis > 1 only makes sense with ``--batch``."""
    d, m = mesh_mod.parse_spec(spec)
    if d != 1:
        raise ValueError(
            f"per-sample training shards the model axis only (want 1xM, "
            f"got {spec}); use --batch for data parallelism")
    return d, m


def spawns(shape) -> bool:
    """True when ``--mesh`` of ``shape`` makes this process start its
    ranks (D×M > 1 and no torchrun environment)."""
    from hpnn_tpu_torch.parallel import dist

    return bool(shape) and shape[0] * shape[1] > 1 and not dist.in_launched_world()


def start_world(argv: list[str], opts: dict, prog: str, shape):
    """Run the ``--mesh`` world of ``shape`` ``(D, M)`` (None: no
    ``--mesh``).  Returns ``("ranks", rc)`` after starting the D×M local
    ranks of ``python -m hpnn_tpu_torch.cli.<prog> argv`` (no torchrun
    environment, D×M > 1), ``("mesh", mesh)`` inside a world (joined
    here: this process is one of its ranks), ``("mesh", None)`` for a
    run of one process, or ``("error", -1)`` with the message printed
    (no card for ``cuda``; more ranks than cards; a world whose size is
    not D×M)."""
    from hpnn_tpu_torch.parallel import dist

    try:
        device = runtime.resolve_device(opts.get("device", "cuda"))
    except runtime.DeviceUnavailable as exc:
        sys.stderr.write(f"{prog}: {exc}\n")
        return "error", -1
    need = shape[0] * shape[1] if shape else 1
    if not dist.in_launched_world():
        if need == 1:
            return "mesh", None
        have = torch.cuda.device_count() if device.type == "cuda" else need
        if need > have:
            sys.stderr.write(f"{prog}: mesh {shape[0]}x{shape[1]} needs {need} "
                             f"devices, have {have}\n")
            return "error", -1
        return "ranks", dist.launch(["-m", f"hpnn_tpu_torch.cli.{prog}", *argv], need)
    rank_device = dist.init_world(device=device)
    world = runtime.process_count()
    if shape and need != world:
        sys.stderr.write(f"{prog}: mesh {shape[0]}x{shape[1]} needs {need} ranks, "
                         f"the world has {world}\n")
        return "error", -1
    return "mesh", dist.hybrid_mesh(shape[1] if shape else 1, device=rank_device)


def parse_args(argv: list[str], prog: str) -> str | None:
    """Apply flags to the runtime; return the conf filename or None.

    Returns None when the process should exit (help shown or error).
    """
    filename = None
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-") and len(arg) > 1:
            j = 1
            while j < len(arg):
                c = arg[j]
                if c == "h":
                    dump_help(prog)
                    return None
                if c == "v":
                    runtime.inc_verbose()
                    j += 1
                    continue
                if c == "x":
                    runtime.toggle_dry()
                    j += 1
                    continue
                if c in "OBS":
                    if j + 1 < len(arg):
                        num = arg[j + 1 :]
                    else:
                        i += 1
                        if i >= len(argv):
                            sys.stderr.write(
                                f"syntax error: bad -{c} parameter!\n"
                            )
                            dump_help(prog)
                            return None
                        num = argv[i]
                    if not num.strip() or not num.strip()[0].isdigit():
                        sys.stderr.write(f"syntax error: bad -{c} parameter!\n")
                        dump_help(prog)
                        return None
                    n = int("".join(ch for ch in num.strip() if ch.isdigit()) or 0)
                    if n == 0 and c != "S":
                        sys.stderr.write(f"syntax error: bad -{c} parameter!\n")
                        dump_help(prog)
                        return None
                    if c == "O":
                        runtime.set_omp_threads(n)
                    elif c == "B":
                        runtime.set_omp_blas(n)
                    else:
                        runtime.set_cuda_streams(max(1, n))
                    break  # no combination after -O/-B/-S
                sys.stderr.write("syntax error: unrecognized option!\n")
                dump_help(prog)
                return None
        else:
            if filename is not None:
                sys.stderr.write("syntax error: unrecognized option!\n")
                dump_help(prog)
                return None
            filename = arg
        i += 1
    return filename or "./nn.conf"
