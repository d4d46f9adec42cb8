"""frame_ms_p50: the median of the same per-step milliseconds as
frame_ms_p95."""

import numpy as np


def read(run):
    return float(np.median(run.window.step_s)) * 1e3
