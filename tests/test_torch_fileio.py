"""The port's own copies of the host modules against the JAX
package's: the glibc stream, the kernel text format, the sample and
.conf parsers, and promotion checkpoints.  All exact."""

import io
import os

import numpy as np
import pytest

from hpnn_tpu import config as jconfig
from hpnn_tpu.fileio import checkpoint as jckpt
from hpnn_tpu.fileio import kernel_format as jkf
from hpnn_tpu.fileio import samples as jsamples
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.utils import glibc_random as jglibc
from hpnn_tpu_torch import config
from hpnn_tpu_torch.fileio import kernel_format, samples
from hpnn_tpu_torch.models import kernel as km
from hpnn_tpu_torch.utils import glibc_random


@pytest.fixture(autouse=True)
def _reset_port_verbosity():
    """The port keeps its own module-global verbosity (the CLIs raise
    it with -v); it must not leak into other tests of this worker."""
    from hpnn_tpu_torch.utils import logging as port_log

    port_log.set_verbose(0)
    yield
    port_log.set_verbose(0)


@pytest.mark.parametrize("seed,shape", [(10958, (12, [16, 8], 8)), (1, (8, [6], 2))])
def test_generate_bit_identical(seed, shape):
    n_in, hiddens, n_out = shape
    k, s = km.generate(seed, n_in, hiddens, n_out)
    jk, js = jkm.generate(seed, n_in, hiddens, n_out)
    assert s == js == seed
    for a, b in zip(k.weights, jk.weights):
        assert a.dtype == np.float64
        assert a.tobytes() == np.asarray(b, dtype=np.float64).tobytes()


def test_glibc_stream_and_shuffle():
    r, jr = glibc_random.GlibcRandom(2**32 - 5), jglibc.GlibcRandom(2**32 - 5)
    assert [r.random() for _ in range(500)] == [jr.random() for _ in range(500)]
    for seed, n in ((0, 1), (1234, 16), (10958, 333), (7, 1000)):
        assert glibc_random.shuffled_order(seed, n) == jglibc.shuffled_order(seed, n)


def test_dump_kernel_byte_identical():
    k, _ = km.generate(77, 9, [5, 4], 3)
    weights = [w * s for w, s in zip(k.weights, (1.0, -3.7, 1e-9))]
    buf, jbuf = io.StringIO(), io.StringIO()
    kernel_format.dump_kernel("(null)", weights, buf)
    jkf.dump_kernel("(null)", weights, jbuf)
    assert buf.getvalue() == jbuf.getvalue()


def test_kernel_and_checkpoint_load(tmp_path):
    k, _ = jkm.generate(5, 6, [4], 3)
    path = str(tmp_path / "k.opt")
    with open(path, "w") as fp:
        jkf.dump_kernel("my kernel", list(k.weights), fp)
    name, got = km.load(path)
    jname, ref = jkm.load(path)
    assert name == jname == "my kernel"
    for a, b in zip(got.weights, ref.weights):
        assert np.array_equal(a, b)
    ck = str(tmp_path / "k.ckpt")
    jckpt.dump_checkpoint(ck, "ck", [w.astype(np.float32) for w in k.weights])
    name, got = km.load(ck)
    assert name == "ck"
    for a, b in zip(got.weights, k.weights):
        assert a.dtype == np.float32 and np.array_equal(a, b.astype(np.float32))
    with open(ck, "r+b") as fp:  # torn payload
        fp.seek(-3, os.SEEK_END)
        fp.truncate()
    with pytest.raises(km.checkpoint.CheckpointError):
        km.load(ck)


@pytest.mark.parametrize("line,n", [
    ("0.5 -1.25 3e-2 7\n", 4),
    ("  \x01 0.25x 0.5 junk 1.5\n", 4),
    ("1 2\n", 5),
    ("+.5 -.5e1 1.e2 \t 4\n", 4),
])
def test_parse_row_agrees(line, n):
    np.testing.assert_array_equal(samples.parse_row(line, n), jsamples.parse_row(line, n))


def test_read_sample_and_listing(tmp_path):
    good = tmp_path / "a.txt"
    good.write_text("[input] 3  # comment\n0.1 0.2 0.3\n[output] 2\n1.0 -1.0\n")
    bad = tmp_path / "b.txt"
    bad.write_text("[input] 3\n0.1 0.2 0.3\n")
    (tmp_path / ".hidden").write_text("x")
    for p in (good, bad):
        got, ref = samples.read_sample(str(p)), jsamples.read_sample(str(p))
        if ref is None:
            assert got is None
        else:
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
    assert samples.read_sample(str(tmp_path / "missing")) is None
    assert samples.list_sample_files(str(tmp_path)) == jsamples.list_sample_files(str(tmp_path))


CONFS = {
    "ann": "[name] V\n[type] ANN\n[init] generate\n[seed] 1234\n[input] 8\n"
           "[hidden] 6 4\n[output] 2\n[train] BP\n[sample_dir] ./s # c\n[test_dir] ./t\n",
    "snn_bpm": "[name] W x\n[type] SNN\n[init] generate\n[seed] 9\n[input] 5\n"
               "[hidden] 3\n[output] 4\n[train] BPM\n[sample_dir] s\n",
    "cg": "[type] ANN\n[init] generate\n[seed] 2\n[input] 4\n[hidden] 3\n"
          "[output] 2\n[train] CG\n",
    "lnn": "[type] LNN\n[init] generate\n[seed] 2\n[input] 4\n[hidden] 3\n"
           "[output] 2\n[train] BP\n",
    "bad_hidden": "[type] ANN\n[init] generate\n[input] 4\n[hidden] x\n[output] 2\n",
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_load_conf_agrees(tmp_path, capsys, name):
    from hpnn_tpu.utils import logging as jlog
    from hpnn_tpu_torch.utils import logging as port_log

    path = tmp_path / "nn.conf"
    path.write_text(CONFS[name])
    jlog.set_verbose(3)  # the -vvv lines (allocation report) must agree too
    port_log.set_verbose(3)
    conf = config.load_conf(str(path))
    out = capsys.readouterr()
    jconf = jconfig.load_conf(str(path))
    jout = capsys.readouterr()
    assert (out.out, out.err) == (jout.out, jout.err)
    if jconf is None:
        assert conf is None
        return
    for f in ("name", "need_init", "seed", "f_kernel", "samples", "tests", "kernel_name"):
        assert getattr(conf, f) == getattr(jconf, f), f
    assert int(conf.type) == int(jconf.type)
    assert int(conf.train) == int(jconf.train)
    for a, b in zip(conf.kernel.weights, jconf.kernel.weights):
        assert np.array_equal(a, b)
    buf, jbuf = io.StringIO(), io.StringIO()
    config.dump_conf(conf, buf)
    jconfig.dump_conf(jconf, jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf, jbuf = io.StringIO(), io.StringIO()
    config.dump_kernel(conf, buf)
    jconfig.dump_kernel(jconf, jbuf)
    assert buf.getvalue() == jbuf.getvalue()
