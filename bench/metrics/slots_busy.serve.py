"""Decode rows that emitted a token, mean over the window's decode steps."""

from bench import readers


def read(run):
    if run.kind != "serve":
        return None
    steps = [n for t, _, n in run.decodes if readers.counted(run, t)]
    return sum(steps) / len(steps) if steps else None
