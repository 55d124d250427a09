"""Share of the prefill rows' positions that hold prompt tokens: the
``tokens`` over the ``width`` of the program's ``serve.prefill`` spans,
summed over the window."""

from bench import program_spans


def read(run):
    if run.kind != "serve":
        return None
    rows = program_spans.window(run, "serve.prefill")
    width = sum(s.attrs["width"] for s in rows)
    if not width:
        return None
    return 100.0 * sum(s.attrs["tokens"] for s in rows) / width
