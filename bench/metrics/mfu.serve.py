"""Model flops of everything prefilled and decoded in the window, over
the window, as a share of the chip's peak, in %."""

from bench import flops, readers


def read(run):
    if run.kind != "serve":
        return None
    f = sum(flops.prefill_flops(run.config, spans)
            for t, spans, _ in run.rows if readers.counted(run, t))
    f += sum(flops.decode_flops(run.config, kv)
             for t, kv, _ in run.decodes if readers.counted(run, t))
    return 100.0 * f / readers.counted_s(run) / readers.peak(run)
