"""Host time a decode or verify step waits for its logits: the program's
``serve.decode.wait`` span, until they are on the host, mean over the
window."""

from bench import program_spans


def read(run):
    if run.kind != "serve":
        return None
    return program_spans.mean_ms(run, "serve.decode.wait")
