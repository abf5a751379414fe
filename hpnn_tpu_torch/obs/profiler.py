"""The ``--profile DIR`` trace and the process's one profiler slot (the
port of ``hpnn_tpu/obs/profiler.py`` and of the JAX CLIs'
``profile_trace``).

The host timeline's names come from the spans (obs/spans.py): while any
``torch.profiler`` collects in the process (:func:`collecting`: the
``--profile`` trace, a capsule's :func:`window`, or a profiler that
another module started, such as a benchmark's), every context-manager
span also opens a ``record_function`` range of its own name, so
``train.chunk`` or ``fleet.epoch`` lies on the trace's clock beside the
kernels it launched.  Outside a profiler no range is opened.

``torch.profiler`` is one per process: a second profiler started while
one runs does not nest.  So the process has one profiler slot, which
the ``--profile`` :class:`trace` and a capture capsule's bounded
:func:`window` (obs/triggers.py) take in turn; whoever finds it taken
gets :class:`ProfilerBusy` and profiles nothing.
"""

from __future__ import annotations

import os
import sys
import threading
import time

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
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _finish(prof, trace_dir: str, exc=(None, None, None)) -> None:
    try:
        prof.__exit__(*exc)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    finally:
        _slot.release()


_flag_module = None   # torch.autograd.profiler, once torch is imported


def collecting() -> bool:
    """True while any ``torch.profiler`` collects in this process: one
    read of torch's own flag (False before torch is imported, when no
    profiler can run)."""
    global _flag_module
    mod = _flag_module
    if mod is None:
        mod = _flag_module = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
    return mod._is_profiler_enabled


def open_range(name: str):
    """A ``record_function`` range named ``name``, opened on this
    thread; close it with :func:`close_range` on the same thread."""
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    rf.__exit__(None, None, None)


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
