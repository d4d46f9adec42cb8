"""idle_share.serve: the share of the traced window in which no kernel,
memcpy or memset ran on the device; nothing from a trace without the
device."""


def read(run):
    if not run.trace.kernels:  # no device in the trace
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
