"""The engine's decode step, from its call to its logits on the host,
mean over the window."""

from bench import readers


def read(run):
    return readers.mean_span_ms(run, "decode_step") if run.kind == "serve" else None
