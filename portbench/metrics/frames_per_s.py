"""frames_per_s: every frame delivered to the host in the window (each
batch element's), over the window's seconds."""


def read(run):
    return run.window.frames / run.window.window_s
