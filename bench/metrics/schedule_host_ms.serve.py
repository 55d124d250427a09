"""Host time an engine iteration spends in its scheduling passes: the
program's ``serve.schedule`` spans summed within each ``serve.iteration``,
mean over the window's iterations."""

from bench import program_spans


def read(run):
    if run.kind != "serve":
        return None
    its = program_spans.window(run, "serve.iteration")
    if not its:
        return None
    held = {id(s) for s in its}
    busy = sum(s.t1 - s.t0 for s in program_spans.window(run, "serve.schedule")
               if id(s.parent) in held)
    return 1e3 * busy / len(its)
