"""mfu.serve: a step's operations, counted from the plain reference
(work.count_step), over the compute dtype's peak, as a share of the
measured window's seconds per step."""

from portbench.work import PEAK_FLOPS


def read(run):
    step_s = run.window.window_s / len(run.window.step_s)
    return 100.0 * run.work["flops"] / PEAK_FLOPS[run.dtype] / step_s
