"""setup_s: seconds from the process's start to the window's (imports, the
card's context, tables, warm-up: builds and loads included)."""


def read(run):
    return run.setup_s
