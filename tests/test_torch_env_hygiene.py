"""The port's tests leave the process's environment as they found it.

A port ``configure`` (``obs.configure``, ``blame.configure``, ...)
exports its knob into ``os.environ``, as its JAX twin does.  A test
that arms one and whose fixture does not restore the environment
leaves ``HPNN_METRICS`` or ``HPNN_BLAME`` set in its worker process,
and a JAX obs test that lands on the same worker later finds its
registry armed.  This runs two such port tests and then four JAX obs
tests that need a disarmed registry, in that order, in one child
pytest process.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ORDER = (
    # each arms a knob through a port configure
    "tests/test_torch_fleet_cluster.py::test_tuner_scale_up_grows_the_fleet",
    "tests/test_torch_serve.py::test_64_concurrent_requests_one_forward_per_bucket",
    # each needs every obs knob unset
    "tests/test_obs.py::test_disabled_is_noop",
    "tests/test_obs.py::test_timer_disabled_is_shared_noop",
    "tests/test_obs.py::test_configure_points_and_clears",
    "tests/test_obs.py::test_bad_sink_path_disables_not_crashes",
)


def test_port_tests_leave_no_knob_for_the_jax_obs_tests():
    env = {k: v for k, v in os.environ.items() if not k.startswith("HPNN_")}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p", "no:randomly",
         "-p", "no:cacheprovider", *ORDER],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
