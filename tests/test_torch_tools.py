"""The port's data tools (``hpnn_tpu_torch/tools``: ``sgdata``,
``synth_mnist``, ``synth_rruff``, ``pmnist``, ``pdif``, ``gen_ann``)
against the JAX package's copies: the same arguments on the same
generated input give the same output bytes, file for file.

Tolerance: none, every comparison is byte for byte.
"""

import os

import pytest

from hpnn_tpu.tools import gen_ann as jgen_ann
from hpnn_tpu.tools import pdif as jpdif
from hpnn_tpu.tools import pmnist as jpmnist
from hpnn_tpu.tools import sgdata as jsgdata
from hpnn_tpu.tools import synth_mnist as jsynth_mnist
from hpnn_tpu.tools import synth_rruff as jsynth_rruff
from hpnn_tpu_torch.tools import (gen_ann, pdif, pmnist, sgdata, synth_mnist,
                                  synth_rruff)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = fp.read()
    return out


def test_sgdata_table_is_the_jax_table():
    assert sgdata.SG_NUMBER == jsgdata.SG_NUMBER
    assert list(sgdata.SG_NUMBER) == list(jsgdata.SG_NUMBER)


def test_synth_mnist_then_pmnist_bytes_equal(tmp_path, monkeypatch, capsys):
    """Each package generates the idx files from one seed and converts
    them with its own pmnist: the idx files and every sample file agree
    byte for byte."""
    trees = []
    for tag, synth, conv in (("jax", jsynth_mnist, jpmnist),
                             ("port", synth_mnist, pmnist)):
        d = tmp_path / tag
        assert synth.main([str(d), "--train", "24", "--test", "8",
                           "--seed", "5"]) == 0
        (d / "samples").mkdir()
        (d / "tests").mkdir()
        monkeypatch.chdir(d)
        assert conv.main(["samples", "tests"]) == 0
        trees.append(_tree(d))
    capsys.readouterr()
    assert len(trees[0]) == 4 + 24 + 8
    assert trees[0] == trees[1]


@pytest.mark.parametrize("quirks", [False, True])
def test_synth_rruff_then_pdif_bytes_equal(tmp_path, capsys, quirks):
    """synth_rruff's dif/raw pairs, and pdif's samples of them, agree
    byte for byte (with and without the quirk files pdif skips)."""
    trees, errs = [], []
    for tag, synth, conv in (("jax", jsynth_rruff, jpdif),
                             ("port", synth_rruff, pdif)):
        d = tmp_path / tag
        args = [str(d / "rruff"), "--per-class", "2", "--classes", "4",
                "--seed", "11"] + (["--quirks"] if quirks else [])
        assert synth.main(args) == 0
        (d / "samples").mkdir()
        assert conv.main([str(d / "rruff"), "-i", "850", "-o", "230",
                          "-s", str(d / "samples")]) == 0
        trees.append(_tree(d))
        errs.append(capsys.readouterr().err.replace(str(d), "<d>"))
    assert len(trees[0]) >= 3 * 8
    assert trees[0] == trees[1]
    assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [["--seed", "42", "8", "6", "4"],
                                  ["--seed", "7", "784", "300", "10"],
                                  ["--seed", "3", "16", "8", "8", "4"]])
def test_gen_ann_seeded_output_equal(capsys, argv):
    assert jgen_ann.main(list(argv)) == 0
    ref = capsys.readouterr()
    assert gen_ann.main(list(argv)) == 0
    got = capsys.readouterr()
    assert ref.out and got.out == ref.out
    assert got.err == ref.err
