"""Tokens (frames) of every step run in the window, over the window."""


def read(run):
    return run.tokens / run.window_s if run.kind == "train" else None
