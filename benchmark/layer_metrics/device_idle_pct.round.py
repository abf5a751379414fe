"""The share of the traced window in which no operation ran on the
card, in percent."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return (tr["window_s"] - tr["busy_s"]) / tr["window_s"] * 100.0
