"""frame_ms_p95: the 95th percentile, over every step of the window, of a
step's milliseconds from handing `step` its labels to holding the frame
on the host (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.step_s, 95)) * 1e3
