"""The traced run's device timeline, read from ``torch.profiler``.

:class:`Trace` profiles the measured window (CPU and CUDA activity) and
reduces it to plain numbers: the device's busy seconds (the union of
every kernel, copy and set on the card), each call's busy seconds and
kernel seconds by name, and the longest idle gaps with the host work
that was open over each.  The harness marks each timed call with
``record_function(CALL)``; the program's own annotations sit inside.
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType

CALL = "bench.call"


def _interval(e):
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def _annotation(e) -> bool:
    if hasattr(e, "is_user_annotation"):
        try:
            if e.is_user_annotation():
                return True
        except RuntimeError:
            pass
    kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    return "annotation" in kind.lower()


def events(prof):
    """(device, host): lists of (start_ns, end_ns, name) from a finished
    profiler; device events are the kernels, copies and sets on the
    card, host events every CPU op and annotation."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _interval(e)
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, end, e.name()))
    return dev, host


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(dev, host, *, top=10):
    """The window's numbers from :func:`events`' lists.  The window is
    the span of the harness's calls; a device event belongs to the call
    in which it starts."""
    calls = sorted((s, e) for s, e, n in host if n == CALL)
    if not calls:
        return None
    lo, hi = calls[0][0], calls[-1][1]
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi)
    merged = _merged([(s, e) for s, e, _ in dev])
    kernels, per_call, i = {}, [], 0
    for cs, ce in calls:
        ks = {}
        while i < len(dev) and dev[i][0] < ce:
            s, e, n = dev[i]
            ks[n] = ks.get(n, 0) + (e - s)
            kernels[n] = kernels.get(n, 0) + (e - s)
            i += 1
        per_call.append({"wall_s": (ce - cs) * 1e-9,
                         "kernels": {n: v * 1e-9 for n, v in ks.items()}})
    j = 0
    for c, (cs, ce) in zip(per_call, calls):
        busy = 0
        while j < len(merged) and merged[j][1] <= cs:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < ce:
            busy += min(merged[k][1], ce) - max(merged[k][0], cs)
            k += 1
        c["busy_s"] = busy * 1e-9
    # idle gaps, each named by the innermost host event open over its middle
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:top]
    named = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        open_ = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        named.append([min(open_)[1] if open_ else "(none)", length * 1e-9])
    ops = sorted(((n, v * 1e-9) for n, v in kernels.items()), key=lambda x: -x[1])
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": sum(e - s for s, e in merged) * 1e-9,
        "kernels": {n: v * 1e-9 for n, v in kernels.items()},
        "calls": per_call,
        "device_ops": [[n[:160], v] for n, v in ops[:top]],
        "idle_gaps": [[n[:160], v] for n, v in named],
    }


def kernel_seconds(kernels: dict, pattern: str) -> float:
    """Seconds of the kernels whose name holds ``pattern``."""
    return sum(v for n, v in kernels.items() if pattern in n)


class Trace:
    """Profiles a ``with`` block on the card when ``on``; a no-op
    otherwise.  :meth:`warm` starts and drops one session first: the
    first session pays the tracer's start-up."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.summary = None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self):
        if self.on:
            with self._profile():
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def __enter__(self):
        if self.on:
            self.prof = self._profile()
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(*events(self.prof))
            self.prof = None
        return False
