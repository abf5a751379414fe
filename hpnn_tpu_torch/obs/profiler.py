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

``torch.profiler`` is one per process: a second profiler started while
one runs does not nest.  So the process has one profiler slot, which
the ``--profile`` :class:`trace` and a capture capsule's bounded
:func:`window` (obs/triggers.py) take in turn; whoever finds it taken
gets :class:`ProfilerBusy` and profiles nothing.
"""

from __future__ import annotations

import os
import threading
import time

from hpnn_tpu_torch.obs.registry import _NULL_CTX

_active = False
# the process's one profiler: held by a trace or a window while it runs
_slot = threading.Lock()


class ProfilerBusy(RuntimeError):
    """The process's profiler is already collecting (a ``--profile``
    trace or another capsule's window)."""


def _take_slot(who: str) -> None:
    if not _slot.acquire(blocking=False):
        raise ProfilerBusy(f"{who}: another torch.profiler trace is running "
                           "in this process")


def _profile(trace_dir: str):
    """A started ``torch.profiler`` over the host and, when there is a
    card, its kernels (the caller holds the slot)."""
    global _active
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active = True
    return prof


def _finish(prof, trace_dir: str, exc=(None, None, None)) -> None:
    global _active
    _active = False
    try:
        prof.__exit__(*exc)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    finally:
        _slot.release()


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
        if self.trace_dir:
            _take_slot("--profile")
            try:
                self._prof = _profile(self.trace_dir)
            except BaseException:
                _slot.release()
                raise
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            _finish(prof, self.trace_dir, exc)
        return False


def window(trace_dir: str, ms: float) -> dict:
    """A bounded trace of the whole process: ``ms`` milliseconds of
    whatever runs meanwhile (other threads' graph replays included),
    written to ``trace_dir/trace.json``.  Returns ``{"dir", "files",
    "window_ms"}``; raises :class:`ProfilerBusy` when the process's
    profiler is taken."""
    _take_slot("capsule profile window")
    try:
        prof = _profile(trace_dir)
    except BaseException:
        _slot.release()
        raise
    try:
        time.sleep(ms / 1e3)
    finally:
        _finish(prof, trace_dir)
    n = sum(len(files) for _, _, files in os.walk(trace_dir))
    return {"dir": trace_dir, "files": n, "window_ms": ms}
