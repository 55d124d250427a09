"""Host time a decode or verify step takes to enqueue its work: the
program's ``serve.decode.launch`` span, from the step function's call to
its return, mean over the window."""

from bench import program_spans


def read(run):
    if run.kind != "serve":
        return None
    return program_spans.mean_ms(run, "serve.decode.launch")
