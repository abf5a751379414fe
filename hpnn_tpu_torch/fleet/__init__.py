"""The serving fleet over port worker processes (the port of
``hpnn_tpu/fleet/``).

``serve.Router`` scales out *inside one process*: N per-device
``Replica`` Sessions behind one fence.  This package breaks that
boundary the way libhpnn breaks it with MPI (SURVEY.md §0): each worker
is an **unmodified** port ``serve_nn`` / ``online_nn`` process speaking
the serve HTTP wire protocol, and three cooperating parts turn a set of
them into one serving fleet:

* :mod:`hpnn_tpu_torch.fleet.client` — ``WorkerHandle``, an HTTP client
  for one worker (``/v1/infer``, ``/v1/ingest``, ``/v1/reload``,
  ``/readyz``, ``/healthz``, ``/metrics``) that maps wire answers back
  to the serve exception types (429 → ``Shed``, 504 →
  ``DeadlineExceeded``, connection refused → ``WorkerGone``);
* :mod:`hpnn_tpu_torch.fleet.worker` — ``WorkerSupervisor``, which
  forks/execs workers (port allocation, the checkout on their
  ``PYTHONPATH``, readiness-gated admission via ``/readyz``, SIGTERM
  drain on scale-down with SIGKILL escalation) and emits
  ``fleet.worker_up`` / ``fleet.worker_down``; it refuses
  ``HPNN_COMPILE_CACHE_DIR`` (no compile cache: each worker captures at
  boot);
* :mod:`hpnn_tpu_torch.fleet.router` — ``ClusterRouter``, a Session-ish
  front end (``serve.make_server`` binds it as the fleet's edge)
  fanning requests over the workers with least-outstanding placement,
  per-worker cool-off, and fence-serialized reload fan-out so
  concurrent infers answer bitwise old-or-new fleet-wide;
* :mod:`hpnn_tpu_torch.fleet.autoscaler` — a pure decision core
  (:func:`decide`) plus a control loop that reads queue depth, shed
  counts and the SLO burn rate and calls ``supervisor.spawn`` /
  ``drain_and_kill`` under hysteresis, emitting ``fleet.scale_up`` /
  ``fleet.scale_down``; ``tune.for_session(router, autoscaler=...)``
  makes it the tuner's ``scale_up`` actuator.

Drive it end to end: ``python -m hpnn_tpu_torch.tools.bench_autoscale``
(real ``serve_nn`` workers behind a ``ClusterRouter`` edge, an
``Autoscaler`` riding a load ramp).
"""

from hpnn_tpu_torch.fleet.autoscaler import Autoscaler, Policy, decide
from hpnn_tpu_torch.fleet.client import WorkerGone, WorkerHandle
from hpnn_tpu_torch.fleet.router import ClusterRouter
from hpnn_tpu_torch.fleet.worker import WorkerSupervisor

__all__ = [
    "Autoscaler",
    "ClusterRouter",
    "Policy",
    "WorkerGone",
    "WorkerHandle",
    "WorkerSupervisor",
    "decide",
]
