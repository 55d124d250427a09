"""Host time an engine iteration spends outside its prefill and decode
steps (scheduling, packing, sampling), mean over the window's iterations."""

from bench import readers


def read(run):
    if run.kind != "serve":
        return None
    it = readers.spans(run, "iteration")
    if not it:
        return None
    steps = readers.spans(run, "prefill_step") + readers.spans(run, "decode_step")
    busy = sum(t1 - t0 for _, t0, t1, _ in it) - sum(t1 - t0 for _, t0, t1, _ in steps)
    return 1e3 * busy / len(it)
