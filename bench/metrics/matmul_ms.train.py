"""Device time a step under aten's matrix-product ops (the outermost of
mm, addmm, bmm, matmul, linear), over the profiled steps."""


def read(run):
    prof = run.profile
    if run.kind != "train" or prof is None or prof["matmul_s"] == 0.0:
        return None
    return 1e3 * prof["matmul_s"] / run.profiled_steps
