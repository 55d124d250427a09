"""Share of the profiled steps' wall time in which no operation ran on
the device, in %."""

from bench import readers


def read(run):
    return readers.idle_pct(run) if run.kind == "train" else None
