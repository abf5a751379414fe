"""NN definition handle + ``.conf`` parser/dumper + type dispatch.

Reimplements the reference's L3 configuration layer: the ``nn_def``
struct (ref: libhpnn include/libhpnn.h:78-89), the keyword
``.conf`` parser ``_NN(load,conf)`` (ref: src/libhpnn.c:658-884), its
inverse ``_NN(dump,conf)`` (src/libhpnn.c:885-937), and the
ANN/LNN/SNN type dispatch (src/libhpnn.c:941-1066).

Grammar quirks preserved (SURVEY.md §5):

* tags are found by substring search anywhere in a line; the value
  starts a fixed offset after the opening tag (``[name`` + 6, etc.);
* ``[type]``/``[train]`` match on the first letter(s) only ('A'/'L'/'S',
  'B'±'M'/'C'/'S'), unknown types default to ANN;
* values end at the first blank/tab/'#' (STR_CLEAN semantics);
* CG and SPLX training modes parse but are unimplemented (the train
  driver returns success without training, ref: src/libhpnn.c:1253-1257);
  LNN is declared but routed to the SNN path by the train/run drivers
  (ref: src/libhpnn.c:1249,1458);
* ``dump_conf`` writes plural ``[inputs]``/``[hiddens]``/``[outputs]``
  tags that the parser itself would reject — reproduced byte-for-byte.
"""

from __future__ import annotations

import dataclasses
import enum
import sys

import numpy as np

from hpnn_tpu_torch.fileio import checkpoint
from hpnn_tpu_torch.models import kernel as kernel_mod
from hpnn_tpu_torch.utils import logging as log


class NNType(enum.IntEnum):
    ANN = 0
    LNN = 1
    SNN = 2
    UKN = -1


class NNTrain(enum.IntEnum):
    BP = 0
    BPM = 1
    CG = 2
    SPLX = 3
    UKN = -1


@dataclasses.dataclass
class NNConf:
    """One network instance (= the reference's ``nn_def``)."""

    name: str | None = None
    type: NNType = NNType.UKN
    need_init: bool = False
    seed: int = 0
    kernel: kernel_mod.Kernel | None = None
    f_kernel: str | None = None
    train: NNTrain = NNTrain.UKN
    samples: str | None = None
    tests: str | None = None
    # the KERNEL's own name: None for generated kernels (the reference
    # never names them, so ann_dump prints glibc's "(null)"), the
    # file's [name] token after a load
    kernel_name: str | None = None


def resolve_time_seed(seed: int) -> int:
    """``[seed] 0`` means the clock (the reference's ``srandom(time(NULL))``),
    rank 0's in a multi-process world (``parallel/dist.py``), so every
    rank generates the same kernel."""
    from hpnn_tpu_torch.parallel import dist

    return dist.resolve_time_seed(seed)


def _value_after(line: str, tag: str, skip: int) -> str:
    """Text after ``tag`` + fixed offset, leading blanks skipped."""
    pos = line.find(tag)
    return line[pos + skip :].lstrip(" \t")


def _clean(s: str) -> str:
    """STR_CLEAN: cut at first blank/tab/newline/'#' (common.h:254-262)."""
    for i, ch in enumerate(s):
        if ch in " \t\n#":
            return s[:i]
    return s


def _get_uint(s: str) -> int | None:
    if not s or not s[0].isdigit():
        return None
    digits = ""
    for ch in s:
        if ch.isdigit():
            digits += ch
        else:
            break
    return int(digits)


def load_conf(filename: str) -> NNConf | None:
    """Parse a ``.conf`` file and generate/load its kernel."""
    conf = NNConf()
    n_in = 0
    n_out = 0
    hiddens: list[int] = []
    try:
        with open(filename, "r") as fp:
            lines = fp.readlines()
    except OSError:
        log.nn_error(sys.stderr, "Error opening configuration file: %s\n", filename)
        return None
    for line in lines:
        if "[name" in line:
            conf.name = _clean(_value_after(line, "[name", 6))
        if "[type" in line:
            c = _value_after(line, "[type", 6)[:1]
            if c == "L":
                conf.type = NNType.LNN
            elif c == "S":
                conf.type = NNType.SNN
            else:
                conf.type = NNType.ANN
        if "[init" in line:
            v = _value_after(line, "[init", 6)
            if "generate" in line or "GENERATE" in line:
                log.nn_out(sys.stdout, "generating kernel!\n")
                conf.need_init = True
            else:
                log.nn_out(sys.stdout, "loading kernel!\n")
                conf.need_init = False
                conf.f_kernel = _clean(v)
                if not conf.f_kernel:
                    log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
                    log.nn_error(sys.stderr, "[init] can't read filename: %s\n", v)
                    return None
        if "[seed" in line:
            v = _get_uint(_value_after(line, "[seed", 6))
            if v is None:
                log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
                return None
            conf.seed = v
        if "[input" in line:
            v = _get_uint(_value_after(line, "[input", 7))
            if v is None:
                log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
                log.nn_error(sys.stderr, "[input] value: %s\n", line)
                return None
            n_in = v
        if "[hidden" in line:
            rest = _value_after(line, "[hidden", 8)
            if not rest or not rest[0].isdigit():
                log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
                log.nn_error(sys.stderr, "[hidden] value: %s\n", line)
                return None
            hiddens = []
            for tok in rest.split():
                if not tok[0].isdigit():
                    break
                hiddens.append(int(float(tok)))
        if "[output" in line:
            v = _get_uint(_value_after(line, "[output", 8))
            if v is None:
                log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
                log.nn_error(sys.stderr, "[output] value: %s\n", line)
                return None
            n_out = v
        if "[train" in line:
            v = _value_after(line, "[train", 7)
            if v[:1] == "B":
                conf.train = NNTrain.BPM if v[2:3] == "M" else NNTrain.BP
            elif v[:1] == "C":
                conf.train = NNTrain.CG
            elif v[:1] == "S":
                conf.train = NNTrain.SPLX
            else:
                conf.train = NNTrain.UKN
        if "[sample_dir" in line:
            conf.samples = _clean(_value_after(line, "[sample_dir", 12))
        if "[test_dir" in line:
            conf.tests = _clean(_value_after(line, "[test_dir", 10))
    # checks (ref: src/libhpnn.c:836-877)
    if conf.type == NNType.UKN:
        log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
        log.nn_error(sys.stderr, "[type] unknown or missing...\n")
        return None
    if conf.need_init:
        if n_in == 0 or not hiddens or n_out == 0 or any(h == 0 for h in hiddens):
            log.nn_error(sys.stderr, "Malformed NN configuration file!\n")
            return None
        if not generate_kernel(conf, n_in, hiddens, n_out):
            log.nn_error(sys.stderr, "FAILED to generate NN kernel!\n")
            return None
    else:
        if not load_kernel(conf):
            log.nn_error(sys.stderr, "FAILED to load the NN kernel!\n")
            return None
    if conf.kernel is None:
        log.nn_error(sys.stderr, "Initialization or load of NN kernel FAILED!\n")
        return None
    return conf


def dump_conf(conf: NNConf, fp) -> None:
    """Byte-compatible with ``_NN(dump,conf)`` (src/libhpnn.c:885-937)."""
    log.nn_write(fp, "# NN configuration\n")
    log.nn_write(fp, "[name] %s\n", conf.name)
    log.nn_write(
        fp, "[type] %s\n", {NNType.LNN: "LNN", NNType.SNN: "SNN"}.get(conf.type, "ANN")
    )
    if conf.need_init:
        log.nn_write(fp, "[init] generate\n")
    elif conf.f_kernel is not None:
        log.nn_write(fp, "[init] %s\n", conf.f_kernel)
    else:
        log.nn_write(fp, "[init] INVALID <- this should trigger an error\n")
    log.nn_write(fp, "[seed] %i\n", conf.seed)
    k = conf.kernel
    log.nn_write(fp, "[inputs] %i\n", k.n_inputs if k else 0)
    log.nn_write(fp, "[hiddens] ")
    if k:
        for h in k.hidden_sizes:
            log.nn_write(fp, "%i ", h)
    log.nn_write(fp, "\n")
    log.nn_write(fp, "[outputs] %i\n", k.n_outputs if k else 0)
    trains = {
        NNTrain.BP: "BP",
        NNTrain.BPM: "BPM",
        NNTrain.CG: "CG",
        NNTrain.SPLX: "SPLX",
    }
    log.nn_write(fp, "[train] %s\n", trains.get(conf.train, "none"))
    if conf.samples is not None:
        log.nn_write(fp, "[sample_dir] %s\n", conf.samples)
    else:
        log.nn_write(fp, "[sample_dir] INVALID <- this should trigger an error\n")
    if conf.tests is not None:
        log.nn_write(fp, "[test_dir] %s\n", conf.tests)
    else:
        log.nn_write(fp, "[test_dir] INVALID <- this should trigger an error\n")


# ------------------------------------------------------------ type dispatch
def _report_kernel_alloc(weights) -> None:
    """ALLOC_REPORT at the reference's site: ``ann_kernel_allocate``
    prints '[CPU] ANN total allocation' at -vv during kernel
    generate/load (ref: src/ann.c:190-200; macro common.h:245-248)."""
    total = 0
    for i, w in enumerate(weights):
        n = np.asarray(w).nbytes
        total += n
        log.nn_dbg(sys.stdout, "[CPU] layer %i allocation: %i (bytes)\n", i + 1, n)
    log.nn_out(sys.stdout, "[CPU] ANN total allocation: %i (bytes)\n", total)


def generate_kernel(conf: NNConf, n_in: int, hiddens: list[int], n_out: int) -> bool:
    """``_NN(generate,kernel)`` — ANN/SNN share the same generator; LNN
    is declared but refused (ref: src/libhpnn.c:975-980)."""
    if conf.type not in (NNType.ANN, NNType.SNN):
        return False
    k, seed = kernel_mod.generate(resolve_time_seed(conf.seed), n_in, hiddens, n_out)
    conf.seed = seed
    conf.kernel = k
    conf.kernel_name = None  # generated kernels are unnamed (ref parity)
    _report_kernel_alloc(k.weights)
    return True


def load_kernel(conf: NNConf) -> bool:
    if conf.f_kernel is None:
        return False
    if conf.type not in (NNType.ANN, NNType.SNN):
        # LNN/UKN arms return FALSE (ref: src/libhpnn.c:992-995)
        return False
    try:
        name, k = kernel_mod.load(conf.f_kernel)
    except (OSError, ValueError, checkpoint.CheckpointError) as exc:
        log.nn_error(sys.stderr, "kernel load failed: %s\n", exc)
        return False
    if name and not conf.name:
        conf.name = name
    conf.kernel = k
    # keep the file's name verbatim, even when blank (ref: src/ann.c:268-269)
    conf.kernel_name = name
    _report_kernel_alloc(k.weights)
    return True


def dump_kernel(conf: NNConf, fp) -> None:
    if conf.kernel is None:
        log.nn_error(sys.stderr, "CAN'T SAVE KERNEL! kernel=NULL\n")
        return
    # generated kernels have no name; the reference's printf renders the
    # NULL as "(null)" and that literal round-trips through later loads
    kernel_mod.dump(
        conf.kernel_name if conf.kernel_name is not None else "(null)",
        conf.kernel,
        fp,
    )
