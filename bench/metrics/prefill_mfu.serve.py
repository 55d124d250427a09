"""Model flops of the prompts prefilled in the window over the prefill
steps' time (each packed row's step, from its call to its logits on the
host), as a share of the chip's peak, in %."""

from bench import flops, readers


def read(run):
    if run.kind != "serve":
        return None
    rows = [(spans, dt) for t, spans, dt in run.rows if readers.counted(run, t)]
    t = sum(dt for _, dt in rows)
    if not rows or t == 0.0:
        return None
    return (100.0 * sum(flops.prefill_flops(run.config, spans) for spans, _ in rows)
            / t / readers.peak(run))
