"""Samples trained per second: every sample of every round in the
window over the window's whole time (host clock)."""


def read(run):
    return sum(c["units"] for c in run["calls"]) / run["window_s"]
