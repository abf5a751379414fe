"""Rows trained per second by the fleet: members × rows × epochs of
every call in the window over the window's whole time (host clock)."""


def read(run):
    return sum(c["units"] for c in run["calls"]) / run["window_s"]
