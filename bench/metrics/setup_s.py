"""Set-up: from the start of the process to the opening of the window
(imports, weights and state from the seed, kernel builds, warm-up)."""


def read(run):
    return run.setup_s
