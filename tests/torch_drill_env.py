"""What the port's drill and tool tests share: a process state restored
around each test, torch held to one CPU thread, a wall-clock limit, and
a loader for the repo's own tools (``tools/*.py``), which they are held
against.

A drill's trainer runs thousands of tiny float64 steps on the CPU beside
its load generator and server threads.  With torch's default of one
thread a core, each of those steps wakes a pool of threads that every
other busy process competes for: on an 8-core CPU the drift drill, about
10 s alone, took 73-99 s beside six busy processes, and 9-10 s there
with one thread.  ``OMP_NUM_THREADS=1`` carries the same pin into the drills'
child processes, which read it at start-up.
"""

import contextlib
import importlib.util
import os
import signal

import pytest
import torch

DRILL_LIMIT_S = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    """The repo's ``tools/<name>.py``, loaded by path under a name of its
    own."""
    spec = importlib.util.spec_from_file_location(
        f"_repo_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The environment restored whole, the port's obs memos reset and
    torch's CPU threads restored around each test (a drill arms knobs
    and a sink)."""
    from hpnn_tpu_torch import obs

    saved = dict(os.environ)
    threads = torch.get_num_threads()
    for knob in obs.ENV_KNOBS:
        os.environ.pop(knob, None)
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    obs._reset_for_tests()
    yield
    obs.configure(None)
    os.environ.clear()
    os.environ.update(saved)
    torch.set_num_threads(threads)
    obs._reset_for_tests()


@contextlib.contextmanager
def limit(seconds, what):
    def expire(signum, frame):
        raise TimeoutError(f"{what} took more than {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
