"""Text kernel format: load / dump.

The reference persists a trained network as a text file
(writer: libhpnn src/ann.c:770-857, parser: src/ann.c:206-631):

    [name] NAME
    [param] n_in h1 .. hN n_out
    [input] n_in
    [hidden 1] N1
    [neuron 1] M
    w_11 w_12 ... w_1M          <- one %17.15f row per neuron
    ...
    [output] n_out
    [neuron 1] M
    ...

``train_nn`` dumps ``kernel.tmp`` before and ``kernel.opt`` after
training, and a later round resumes by pointing ``[init]`` at
``kernel.opt``.  Weights are row-major, one row per neuron: shape
(N, M) where N is the layer's neuron count and M its input width.
"""

from __future__ import annotations

import numpy as np

from hpnn_tpu_torch import native
from hpnn_tpu_torch.fileio import samples


class KernelFormatError(ValueError):
    pass


def _ints_after(line: str, tag: str) -> list[int]:
    """Integer tokens following ``tag`` on ``line`` (stop at non-digit)."""
    pos = line.find(tag)
    rest = line[pos + len(tag) + 1 :].lstrip(" \t")
    out: list[int] = []
    for tok in rest.split():
        if not tok[0].isdigit():
            break
        out.append(int(tok))
    return out


def load_kernel(path: str) -> tuple[str, list[np.ndarray]]:
    """Parse a kernel text file into (name, [W_1..W_n, W_out]).

    Mirrors ``ann_load``'s line-scanning grammar: tags are located by
    substring search, so surrounding text/comments are tolerated.
    """
    name = ""
    n_inputs = 0
    hiddens: list[int] = []
    n_outputs = 0
    weights: list[np.ndarray] = []

    with open(path, "r") as fp:
        lines = fp.readlines()

    # pass 1: dims from [param]
    for line in lines:
        if "[name" in line:
            # the kernel parser keeps the WHOLE rest of the line (spaces
            # included, newlines stripped) — unlike the .conf parser's
            # first-token rule (ref: src/ann.c:266-277)
            rest = line[line.find("[name") + 6 :].lstrip(" \t")
            name = rest.replace("\n", "") if rest else "noname"
        if "[param" in line:
            dims = _ints_after(line, "[param")
            if len(dims) < 3:
                raise KernelFormatError(f"[param] needs >=3 dims, got {dims}")
            n_inputs, *hiddens, n_outputs = dims
    if n_inputs == 0 or n_outputs == 0 or not hiddens:
        raise KernelFormatError("missing or malformed [param] line")

    # pass 2: weight rows.  Layer order in the file is [hidden 1..N]
    # then [output]; each neuron row follows its [neuron j] M line.
    layer_sizes = hiddens + [n_outputs]
    layer_inputs = [n_inputs] + hiddens
    i = 0
    layer_idx = -1
    rows: list[np.ndarray] = []
    cur_n = cur_m = 0

    def _flush():
        nonlocal rows
        if layer_idx >= 0:
            if len(rows) != cur_n:
                raise KernelFormatError(
                    f"layer {layer_idx}: expected {cur_n} neurons, got {len(rows)}"
                )
            weights.append(np.stack(rows).astype(np.float64))
        rows = []

    while i < len(lines):
        line = lines[i]
        is_hidden = "[hidden" in line and "]" in line
        is_output = "[output" in line
        if is_hidden or is_output:
            _flush()
            layer_idx += 1
            if layer_idx >= len(layer_sizes):
                raise KernelFormatError("more layers than [param] declares")
            toks = _ints_after(line, "]" if is_hidden else "[output")
            cur_n = toks[0] if toks else layer_sizes[layer_idx]
            if cur_n != layer_sizes[layer_idx]:
                raise KernelFormatError(
                    f"layer {layer_idx}: [param] says {layer_sizes[layer_idx]} "
                    f"neurons but header says {cur_n}"
                )
            cur_m = layer_inputs[layer_idx]
        elif "[neuron" in line:
            toks = _ints_after(line, "]")
            m = toks[0] if toks else cur_m
            if m != cur_m:
                raise KernelFormatError(
                    f"layer {layer_idx}: neuron width {m} != expected {cur_m}"
                )
            i += 1
            if i >= len(lines):
                raise KernelFormatError("EOF while reading neuron weights")
            # first cur_m values via the shared GET_DOUBLE walk (junk
            # tokens read as 0.0, extra tokens past the M-th ignored)
            row = samples.parse_row(lines[i], cur_m)
            if row is None:  # absurd declared width only
                raise KernelFormatError(
                    f"layer {layer_idx}: implausible neuron width {cur_m}"
                )
            rows.append(row)
        i += 1
    _flush()
    if len(weights) != len(layer_sizes):
        raise KernelFormatError(
            f"expected {len(layer_sizes)} weight layers, found {len(weights)}"
        )
    return name, weights


def dump_kernel(name: str, weights: list[np.ndarray], fp) -> None:
    """Write the text kernel format byte-identically to ``ann_dump``."""
    n_inputs = weights[0].shape[1]
    fp.write(f"[name] {name}\n")
    fp.write(f"[param] {n_inputs}")
    for w in weights[:-1]:
        fp.write(f" {w.shape[0]}")
    fp.write(f" {weights[-1].shape[0]}\n")
    fp.write(f"[input] {n_inputs}\n")
    for idx, w in enumerate(weights):
        w = np.asarray(w, dtype=np.float64)
        n, m = w.shape
        if idx < len(weights) - 1:
            fp.write(f"[hidden {idx + 1}] {n}\n")
        else:
            fp.write(f"[output] {n}\n")
        for j in range(n):
            fp.write(f"[neuron {j + 1}] {m}\n")
            # %17.15f per weight, space separated (ref: src/ann.c:820-824)
            text = native.format_row(w[j])
            if text is None:
                text = " ".join("%17.15f" % v for v in w[j]) + "\n"
            fp.write(text)
