"""The whole step's share of the card's float32 peak (67 TFLOP/s, the
NVIDIA H100 SXM data sheet, outside the tensor cores): every operation
the window's work counts (``benchmark/frozen/work.py``) over the traced
window, in percent."""

from benchmark.frozen.work import PEAK_FLOPS


def read(run):
    tr, w = run["trace"], run["work"]
    if not tr or tr["window_s"] <= 0 or not w.get("flops"):
        return None
    return w["flops"] / (tr["window_s"] * PEAK_FLOPS["float32"]) * 100.0
