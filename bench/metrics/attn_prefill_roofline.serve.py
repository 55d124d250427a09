"""Share of its roofline bound that the forward attention entry reaches
on the profiled packed-prefill calls (segments), in %."""

from bench import readers


def read(run):
    return readers.roofline_pct(run, "bench.attn_fwd") if run.kind == "serve" else None
