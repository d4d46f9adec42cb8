"""conv7_roofline: the reflect-padded 7x7 convs' bound (work.conv7_work)
over the device time of the family "conv7 (ours)" in the traced window;
nothing where that family ran no kernel."""


def read(run):
    device_s = run.trace.families.get("conv7 (ours)")
    if not device_s:
        return None
    return 100.0 * run.work["conv7"] * run.trace.steps / device_s
