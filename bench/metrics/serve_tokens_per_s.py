"""Generated tokens emitted in the window (first tokens at prefill and
decode tokens), over the window."""


def read(run):
    return run.tokens / run.window_s if run.kind == "serve" else None
