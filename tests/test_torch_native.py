"""The port's native host library (``hpnn_tpu_torch/native``) against its
Python walks and against the JAX package: the GET_DOUBLE row parse, the
``%17.15f`` kernel-row formatting and the glibc file-visit shuffle, over
the fileio corpus including junk rows.  All exact.

``HPNN_NO_NATIVE=1`` forces the Python walks; a failed build falls back
to them with a message on stderr.
"""

import os

import numpy as np
import pytest

from hpnn_tpu.fileio import kernel_format as jkf
from hpnn_tpu.fileio import samples as jsamples
from hpnn_tpu.models import kernel as jkm
from hpnn_tpu.utils import glibc_random as jglibc
from hpnn_tpu_torch import native
from hpnn_tpu_torch.fileio import kernel_format, samples
from hpnn_tpu_torch.ops import _build
from hpnn_tpu_torch.utils import glibc_random

# rows a converter writes, and the junk the GET_DOUBLE walk salvages:
# junk tokens read as 0.0 one byte a slot, junk-suffixed tokens keep
# their prefix, short rows leave zeros, non-graph bytes are blanks
LINES = [
    "0.5 -1.25 3e-2 7\n",
    "  1.5 -2.25e1 0.125 junk 7",
    "0.25x 0.5",
    "x 0.5",
    "1.0junk2.0 3",
    "",
    "only 2 number-ish 4x",
    "xxxxx 1.0",
    "!!!!!!!!!! 9",
    "1.0 é 2.0",
    "\x01 1.5 2.5",
    "\x7f\x01-3.5 4",
    "  \x01 0.25x 0.5 junk 1.5\n",
    "1 2\n",
    "+.5 -.5e1 1.e2 \t 4\n",
    " ".join("%.5f" % v for v in np.random.default_rng(3).uniform(0, 255, 784)) + "\n",
]


@pytest.fixture(autouse=True)
def _native_state(monkeypatch):
    monkeypatch.delenv("HPNN_NO_NATIVE", raising=False)
    native._reset_for_tests()
    yield
    native._reset_for_tests()


@pytest.fixture
def lib():
    L = native.lib()
    if L is None:
        pytest.skip("g++ could not build the native library here")
    return L


def _python_walk(monkeypatch, fn):
    monkeypatch.setenv("HPNN_NO_NATIVE", "1")
    try:
        return fn()
    finally:
        monkeypatch.delenv("HPNN_NO_NATIVE")


@pytest.mark.parametrize("line", LINES)
@pytest.mark.parametrize("n", [1, 4, 8, 784])
def test_parse_row_native_matches_python_walk_and_jax(lib, monkeypatch, line, n):
    got = samples.parse_row(line, n)
    assert native.parse_doubles(line, n) is not None  # the native walk ran
    want = _python_walk(monkeypatch, lambda: samples.parse_row(line, n))
    ref = jsamples.parse_row(line, n)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes() == np.asarray(ref).tobytes()


def test_parse_doubles_bounded_by_text(lib):
    """A huge untrusted count must not drive a huge allocation."""
    np.testing.assert_array_equal(native.parse_doubles("1.0 2.0", 10**15), [1.0, 2.0])


def test_read_dir_native_matches_python_walk_and_jax(lib, monkeypatch, tmp_path):
    """A directory of samples with junk rows, a short row, an unreadable
    file and a dims mismatch: the same (names, X, T) from both walks
    and from the JAX package."""
    d = tmp_path / "s"
    d.mkdir()
    rng = np.random.default_rng(7)
    for i in range(12):
        x = " ".join("%.5f" % v for v in rng.uniform(-1, 1, 6))
        if i % 4 == 1:
            x = x.replace(" ", " junk ", 1)
        if i % 4 == 2:
            x = "\x01" + x[: len(x) // 2]
        (d / f"s{i:03d}.txt").write_text(f"[input] 6\n{x}\n[output] 2\n1.0 -1.0\n")
    (d / "zz_bad.txt").write_text("[input] 6\n")
    (d / "zz_dims.txt").write_text("[input] 3\n1 2 3\n[output] 2\n1.0 -1.0\n")
    got = samples.read_dir(str(d))
    want = _python_walk(monkeypatch, lambda: samples.read_dir(str(d)))
    ref = jsamples.read_dir(str(d))
    assert got[0] == want[0] == list(ref[0])
    for a, b, c in zip(got[1:], want[1:], ref[1:]):
        assert a.tobytes() == b.tobytes() == np.asarray(c).tobytes()


def test_format_row_and_dump_match_python_and_jax(lib, monkeypatch):
    rng = np.random.RandomState(0)
    row = rng.uniform(-2, 2, 64)
    assert native.format_row(row) == " ".join("%17.15f" % v for v in row) + "\n"
    k, _ = jkm.generate(7, 6, [5], 3)
    ws = [np.asarray(w) for w in k.weights]
    got, want, ref = io_text(lambda fp: kernel_format.dump_kernel("g", ws, fp)), \
        _python_walk(monkeypatch, lambda: io_text(
            lambda fp: kernel_format.dump_kernel("g", ws, fp))), \
        io_text(lambda fp: jkf.dump_kernel("g", ws, fp))
    assert got == want == ref


def io_text(write):
    import io

    fp = io.StringIO()
    write(fp)
    return fp.getvalue()


@pytest.mark.parametrize("seed,n", [(42, 257), (10958, 4096), (1, 1)])
def test_shuffle_native_matches_python_walk_and_jax(lib, monkeypatch, seed, n):
    got = glibc_random.shuffled_order(seed, n)
    assert native.glibc_shuffle(seed, n) is not None
    want = _python_walk(monkeypatch, lambda: glibc_random.shuffled_order(seed, n))
    assert got == want == list(jglibc.shuffled_order(seed, n))
    assert sorted(got) == list(range(n))


def test_prng_stream_matches_python(lib):
    py = glibc_random.GlibcRandom(10958)
    h = lib.glibc_new(10958)
    try:
        assert [lib.glibc_next(h) for _ in range(1000)] == [py.random() for _ in range(1000)]
    finally:
        lib.glibc_delete(h)


def test_no_native_env_disables(lib, monkeypatch):
    monkeypatch.setenv("HPNN_NO_NATIVE", "1")
    assert native.lib() is None
    assert native.glibc_shuffle(1, 4) is None
    assert native.parse_doubles("1 2", 2) is None
    assert native.format_row(np.ones(2)) is None
    np.testing.assert_array_equal(samples.parse_row("1 2", 2), [1.0, 2.0])


def test_failed_build_says_so_and_the_python_walk_runs(monkeypatch, capsys):
    def broken(name, **kw):
        raise _build.NvccError("g++ failed (1) on hpnn_native.cpp: simulated")

    monkeypatch.setattr(_build, "build_host", broken)
    assert native.lib() is None
    assert "hpnn native library unavailable" in capsys.readouterr().err
    assert native.lib() is None  # the verdict is kept, said once
    assert capsys.readouterr().err == ""
    np.testing.assert_array_equal(samples.parse_row("0.25x 0.5", 3), [0.25, 0.5, 0.0])
    assert glibc_random.shuffled_order(42, 5) == list(jglibc.shuffled_order(42, 5))


def test_build_goes_to_the_build_dir(lib):
    path = os.path.join(_build.BUILD_DIR, "libhpnn_native.so")
    assert os.path.exists(path)
    assert os.path.getmtime(path) >= os.path.getmtime(
        os.path.join(_build.CSRC, "hpnn_native.cpp"))
