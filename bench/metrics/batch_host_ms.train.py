"""Host span around fetching one step's batch and placing it on the
device (``runtime.steps.place_batch``), mean over the window's steps."""

from bench import readers


def read(run):
    return readers.mean_span_ms(run, "batch") if run.kind == "train" else None
