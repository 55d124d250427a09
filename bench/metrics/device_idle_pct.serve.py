"""Share of the profiled part of the window in which no operation ran on
the device, in %."""

from bench import readers


def read(run):
    return readers.idle_pct(run) if run.kind == "serve" else None
