"""The program's own span table (``hpnn_tpu_torch.obs.spans.totals``),
read by the per-layer metrics whose source is ``program_span``.

Under the traced run's profiler every span of the program is real, so
the table holds the window's calls (and, where ``HPNN_SPANS`` is set,
the warm-up's too): a metric divides by the count of the call's root
span, never by the window's calls.  A program without the table (an
older checkout) reads as nothing.
"""


def table(run):
    """``{name: (count, seconds)}``, or None where the run has no trace
    or the program keeps no table."""
    if run["trace"] is None:
        return None
    try:
        from hpnn_tpu_torch.obs import spans
    except ImportError:
        return None
    totals = getattr(spans, "totals", None)
    return totals() if totals is not None else None


def per_root_s(run, root, names):
    """Seconds of the spans ``names`` per ``root`` span, or None where
    the table lacks one of them."""
    got = table(run)
    if got is None or any(n not in got for n in (root, *names)) or not got[root][0]:
        return None
    return sum(got[n][1] for n in names) / got[root][0]


def per_root_ms(run, root, names):
    s = per_root_s(run, root, names)
    return None if s is None else s * 1e3
