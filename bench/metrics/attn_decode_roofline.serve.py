"""Share of its roofline bound that the paged decode entry reaches on the
profiled decode steps (each distinct K/V row counted once), in %."""

from bench import readers


def read(run):
    return readers.roofline_pct(run, "bench.attn_decode") if run.kind == "serve" else None
