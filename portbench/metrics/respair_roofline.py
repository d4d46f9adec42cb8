"""respair_roofline: the eval ResnetBlocks' bound (work.respair_work, each
block's larger of operations and bytes) over the device time of the
family "respair (ours)" in the traced window; nothing where that family
ran no kernel."""


def read(run):
    device_s = run.trace.families.get("respair (ours)")
    if not device_s:
        return None
    return 100.0 * run.work["respair"] * run.trace.steps / device_s
