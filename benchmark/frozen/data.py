"""The benchmark's inputs, made from the seed: starting weights, and
the text files a round reads (the data sets are ``benchmark/datasets``).

* :func:`write_samples`, :func:`write_conf`: ``chip_smoke.py``
  ``write_samples`` (:461) and ``write_conf`` (:469), the sample
  container ``[input] n`` / values / ``[output] n`` / targets and a
  ``train_nn`` conf; :func:`write_kernel`: the kernel text format
  (``hpnn_tpu_torch/fileio/kernel_format.py`` ``dump_kernel``, :141).
* :func:`weights`: libhpnn's ``generate`` distribution, U(-1, 1)/√in
  (``hpnn_tpu_torch/utils/glibc_random.py`` :6-7), drawn from the
  benchmark's generator.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch


def sizes(cfg):
    """A configuration's layer widths: (in, hidden.., out)."""
    return [cfg["input"], *cfg["hidden"], cfg["output"]]


def dataset(cfg):
    """The module ``benchmark/datasets/<data>.py`` that makes
    ``cfg``'s samples."""
    return importlib.import_module(f"benchmark.datasets.{cfg['data']}")


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def uniform(gen, shape, lo, hi, device, dtype=torch.float64):
    return torch.rand(shape, generator=gen, device=device, dtype=dtype) * (hi - lo) + lo


def weights(gen, sizes, device, dtype=torch.float32):
    """One kernel's layers ``(out, in)`` for ``sizes`` = (in, h.., out),
    U(-1, 1)/√in each, in ``dtype`` on ``device``."""
    return [(uniform(gen, (o, i), -1.0, 1.0, device, dtype) / float(np.sqrt(i))).contiguous()
            for i, o in zip(sizes[:-1], sizes[1:])]


# ------------------------------------------------------------- text files
def text_rows(values, fmt):
    """(lines, parsed): each row of ``values`` printed with ``fmt``
    joined by spaces, and the float64 values a reader parses back."""
    cells = np.char.mod(fmt, np.asarray(values, dtype=np.float64))
    return [" ".join(r) for r in cells], cells.astype(np.float64)


def write_samples(directory, x_lines, t_lines, n_in, n_out):
    """One sample file a row, ``s00000.txt`` on."""
    os.makedirs(directory)
    for i, (x, t) in enumerate(zip(x_lines, t_lines)):
        with open(os.path.join(directory, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {n_in}\n{x}\n[output] {n_out}\n{t}\n")


def write_kernel(path, name, layers):
    """The kernel text file of float64 ``layers``; returns the values a
    reader parses back from it."""
    n_in = layers[0].shape[1]
    parsed = []
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[param] {n_in}")
        for w in layers:
            fp.write(f" {w.shape[0]}")
        fp.write(f"\n[input] {n_in}\n")
        for idx, w in enumerate(layers):
            lines, vals = text_rows(w, "%17.15f")
            parsed.append(vals)
            fp.write(f"[hidden {idx + 1}] {w.shape[0]}\n" if idx < len(layers) - 1
                     else f"[output] {w.shape[0]}\n")
            for j, line in enumerate(lines):
                fp.write(f"[neuron {j + 1}] {w.shape[1]}\n{line}\n")
    return parsed


def write_conf(path, *, name, sizes, train, seed, init, sample_dir):
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[type] ANN\n[init] {init}\n[seed] {seed}\n"
                 f"[input] {sizes[0]}\n[hidden] {' '.join(str(h) for h in sizes[1:-1])}\n"
                 f"[output] {sizes[-1]}\n[train] {train}\n"
                 f"[sample_dir] {sample_dir}\n[test_dir] {sample_dir}\n")
