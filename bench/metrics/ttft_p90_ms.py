"""Time to first token of every request sent in the window, p90 by
nearest rank (a request that never got one counts as missing: inf)."""

from bench import readers


def read(run):
    if run.kind != "serve" or not run.ttft_s:
        return None
    return 1e3 * readers.nearest_rank(run.ttft_s, 0.9)
