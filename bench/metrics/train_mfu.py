"""The window's model flops (flops.train_step_flops a step) over the
window, as a share of the chip's peak, in %."""

from bench import readers


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * run.model_flops / run.window_s / readers.peak(run)
