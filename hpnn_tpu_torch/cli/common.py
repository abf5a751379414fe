"""Shared CLI argument handling for train_nn / run_nn.

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
(a ``torch.profiler`` trace of the workload).  ``--mesh`` belongs to a
path this package does not have yet and is refused with a message, as
are the environment knobs of the JAX package's unported planes
(``runtime.DEFERRED_ENV``).
"""

from __future__ import annotations

import signal
import sys

from hpnn_tpu_torch import runtime

DEVICES = ("cpu", "cuda")

# long option -> the path of the JAX package it belongs to
DEFERRED_OPTS = {
    "mesh": "tensor parallelism (--mesh)",
}
# the observability options both CLIs take (valued)
OBS_OPTS = ("metrics", "ledger", "numerics", "export-port", "profile")


def install_sigpipe_handler() -> None:
    """Die quietly when stdout is a closed pipe (e.g. ``train_nn -h | head``)."""
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
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
    """Refuse (with a message) the options and knobs of paths this
    package does not have, and a bad ``--device``, ``--batch``,
    ``--epochs`` or ``--lr`` value; never ignore them."""
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
    for name in ("batch", "epochs"):
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
    port = opts.get("export-port")
    if port is not None and (not str(port).isdigit() or int(port) > 65535):
        sys.stderr.write("syntax error: bad --export-port parameter!\n")
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
    if "export-port" not in opts:
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
