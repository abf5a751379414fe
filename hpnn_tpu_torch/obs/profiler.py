"""``torch.profiler`` annotations for the protocol phases, and the
``--profile DIR`` trace (the port of ``hpnn_tpu/obs/profiler.py`` and of
the JAX CLIs' ``profile_trace``).

:func:`annotate` and :func:`step_annotation` name a phase of the host
timeline (``torch.profiler.record_function``): "fused chunk 3" instead
of a bare kernel launch.  They cost nothing outside a :func:`trace`:
the shared no-op context is returned unless this module's trace is
collecting.  Scope names follow the JAX package's catalog
(docs/observability.md): ``hpnn.fused_chunk`` (step = chunk index),
``hpnn.sample_loop`` (a streaming sample), ``hpnn.batch_block`` (step =
block index), ``hpnn.fleet_epoch``, ``hpnn.eval_forward``.
"""

from __future__ import annotations

import os

from hpnn_tpu_torch.obs.registry import _NULL_CTX

_active = False


def annotate(name: str, **metadata):
    """A ``record_function`` range named ``name`` while a trace is
    collecting, else the shared no-op context."""
    if not _active:
        return _NULL_CTX
    import torch

    return torch.profiler.record_function(name)


def step_annotation(name: str, step: int):
    """Like :func:`annotate`, the range named ``<name>#<step>`` (the
    chunk or block index), the counterpart of JAX's
    ``StepTraceAnnotation``."""
    if not _active:
        return _NULL_CTX
    import torch

    return torch.profiler.record_function(f"{name}#{step}")


class trace:
    """A ``torch.profiler`` trace around a workload (``--profile DIR``):
    host ranges, and the card's kernels when CUDA is in use, written to
    ``DIR/trace.json`` (a Chrome trace, viewable in Perfetto).  A None
    or empty ``trace_dir`` traces nothing."""

    def __init__(self, trace_dir: str | None):
        self.trace_dir = trace_dir
        self._prof = None

    def __enter__(self):
        global _active
        if self.trace_dir:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            _active = True
        return self

    def __exit__(self, *exc):
        global _active
        if self._prof is not None:
            _active = False
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
            self._prof = None
        return False
