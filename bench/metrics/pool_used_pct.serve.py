"""Share of the page pool's usable pages that rows hold, mean over the
window's decode steps, in % (the engine's own samples): how much of the
memory the pool reserves the traffic fills."""


def read(run):
    if run.kind != "serve" or not run.pool_fill:
        return None
    return 100.0 * sum(run.pool_fill) / len(run.pool_fill)
