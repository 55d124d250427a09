"""The profiled steps' model flops over the profiled wall time, as a share
of the chip's peak, in %: the whole step's share, which bounds what the
kernels' rooflines can give to train_tokens_per_s."""

from bench import readers


def read(run):
    prof = run.profile
    if run.kind != "train" or prof is None or not run.profiled_steps:
        return None
    return (100.0 * run.profiled_steps * run.step_flops / prof["window_s"]
            / readers.peak(run))
