"""Host milliseconds of a fleet call: its wall time less the time the
device was busy inside it, averaged over the window's calls (plans,
bank gathers, launches, counts, copies back)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["calls"]:
        return None
    host = [c["wall_s"] - c["busy_s"] for c in tr["calls"]]
    return sum(host) / len(host) * 1e3
