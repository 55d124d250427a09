"""Share of its roofline bound that the fused backward attention entry
reaches in the profiled steps, in %."""

from bench import readers


def read(run):
    return readers.roofline_pct(run, "bench.attn_bwd") if run.kind == "train" else None
