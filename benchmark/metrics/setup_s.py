"""setup_s: seconds from the start of the process to the opening of
the window (imports, kernel builds, weights and inputs on the card, the
program and its tables, the warm-up calls)."""


def read(run):
    return run.setup_s
