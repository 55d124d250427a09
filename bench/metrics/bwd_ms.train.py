"""Device time of a training step's backward: the CUDA events of the
program's ``train.backward`` spans, summed within each ``train.step``, mean
over the window's steps; None on the CPU."""

from bench import program_spans


def read(run):
    if run.kind != "train":
        return None
    return program_spans.device_ms_a_step(run, "train.backward")
