"""The 95th percentile (linear between ranks) of the wall time of every
``train_fleet`` call in the window, in milliseconds (host clock): what a
calculation waiting on the fleet feels."""

import numpy as np


def read(run):
    return float(np.percentile([c["wall_s"] for c in run["calls"]], 95)) * 1e3
