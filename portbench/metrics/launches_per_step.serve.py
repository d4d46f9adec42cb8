"""launches_per_step.serve: device kernels launched per step in the traced
window (memcpys and memsets not counted); nothing from a trace without
the device."""


def read(run):
    if not run.trace.kernels:  # no device in the trace
        return None
    return run.trace.kernels / run.trace.steps
