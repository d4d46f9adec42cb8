"""setup_s: from the process's start to the first timed step: imports,
the library's load (and, in a checkout's first run, its build), the
weights and inputs made from the seed, the program's build and warm-up."""


def read(run):
    return run.setup_s
