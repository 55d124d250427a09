"""Share of its roofline bound that the forward attention entry reaches
in the profiled steps (forward and remat's recompute), in %."""

from bench import readers


def read(run):
    return readers.roofline_pct(run, "bench.attn_fwd") if run.kind == "train" else None
