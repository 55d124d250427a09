"""The training driver: one object, the port's train step with its model
and AdamW state, driven step after step.

Set-up makes the mix's host batches and the weights from the seed, loads
the weights into the program's ``models.lm.LM``, builds
``runtime.steps.make_train_step(cfg, impl="kernel", opt=...)`` and runs its
first ``checked_steps`` steps through the window's own call and feed
(``place_batch``, ``step_fn``, ``float(loss)``) on batches that all differ:
they compile and warm every kernel, and give the readings the check
compares (each step's loss, every leaf's norm of the first clipped
gradient, worked out from AdamW's first moment, and of the weights' change
after the last of them). The window then runs steps on the same object,
cycling the batches, for ``--seconds``; a traced run profiles
``trace_steps`` of them. Once the window has closed and the peak memory is
read, one late step follows, untimed, through the same call and feed on
the state the window left (whatever the program chose or kept over the
window's steps), and gives its loss and each leaf's clipped gradient
(from the change of AdamW's first moment); the program's weights before it
are kept. The program's state is then freed, and the plain reference works
out the late step at those weights, and runs the checked steps from the
seed's weights and the same batches. The late step follows the program
from its own state; the checked steps hold that state's start to the
reference by themselves.
"""

from __future__ import annotations

import gc
import math
from statistics import median
from types import SimpleNamespace

from bench import checks, flops, traffic, weights


def run(ctx):
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step, place_batch

    cfg, conf, mix, rec, dev = ctx.cfg, ctx.config, ctx.mix, ctx.rec, ctx.device
    ref = ctx.reference
    leaves = ref.leaves(conf)
    opt = AdamWConfig(**mix["optimizer"])
    checked = mix["checked_steps"]
    host = [traffic.train_batch(mix, conf, ctx.seed, i) for i in range(mix["pool"])]
    tokens_per_step = mix["batch"] * mix["seq_len"]

    params = lm.LM(cfg, cfg.vocab_size, device=dev)
    weights.load(lambda n, t: params.get_parameter(n).copy_(t), leaves, ctx.seed, dev)
    opt_state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, impl="kernel", opt=opt, device=dev).step_fn

    def one_step(i: int) -> float:
        with rec.span("batch"):
            batch = place_batch(host[i % len(host)], dev)
        with rec.span("step"):
            _, _, metrics = step_fn(params, opt_state, batch, i)
            return float(metrics["loss"])     # waits for the step

    losses, first_grad = [], {}
    for i in range(checked):
        losses.append(one_step(i))
        if i == 0:
            with torch.no_grad():
                first_grad = {n: float(torch.linalg.vector_norm(m)) / (1 - opt.b1)
                              for n, m in opt_state.m.items()}
    change = weights.change_norms(params.get_parameter, leaves, ctx.seed, dev)
    if dev != "cpu":
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = rec.clock() - ctx.t_start

    # -- the window --------------------------------------------------------
    prof, profiled, window_losses = ctx.profile, 0, []
    t0 = rec.clock()
    i = checked
    while True:
        if prof is not None and profiled == 0 and not prof.active and i > checked:
            prof.start()
        window_losses.append(one_step(i))
        i += 1
        if prof is not None and prof.active:
            profiled += 1
            if profiled == mix["trace_steps"]:
                prof.stop()
        done_tracing = prof is None or (profiled >= mix["trace_steps"] and not prof.active)
        if rec.clock() - t0 >= ctx.seconds and done_tracing:
            break
    t1 = rec.clock()
    if dev != "cpu":
        peak_window = torch.cuda.max_memory_allocated()
    else:
        peak_setup = peak_window = 0

    # -- a late step: the one after the window's last, untimed, through the
    # same call and feed on the state the window left ----------------------
    with torch.no_grad():
        late_at = {n: t.detach().clone() for n, t in params.named_parameters()}
        m_before = {n: t.clone() for n, t in opt_state.m.items()}
    late_batch = host[i % len(host)]
    late_loss = one_step(i)
    with torch.no_grad():
        late_grad = {n: float(torch.linalg.vector_norm(opt_state.m[n] - opt.b1 * m))
                     / (1 - opt.b1) for n, m in m_before.items()}
    del params, opt_state, step_fn, m_before
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    # -- the reference: the late step at the program's weights, then the
    # checked steps from the same weights and batches as the program's ------
    t_ref = rec.clock()
    with ref.full_f32():
        ref_late_loss, ref_late_grad = ref.grad_norms(
            late_at, conf, {k: torch.as_tensor(v, device=dev) for k, v in late_batch.items()},
            mix["optimizer"])
        del late_at
        gc.collect()
        p = weights.own(leaves, ctx.seed, dev)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in host[j].items()}
                   for j in range(checked)]
        ref_losses, ref_grad = ref.train(p, conf, batches, mix["optimizer"])
        ref_change = weights.change_norms(p.__getitem__, leaves, ctx.seed, dev)
    del p, batches
    gc.collect()
    ctx.log(f"set-up {setup_s:.1f} s; window {t1 - t0:.2f} s, {len(window_losses)} "
            f"steps; reference {rec.clock() - t_ref:.1f} s")

    # leaves the reference's gradient leaves at nought to rounding move under
    # Adam by round-off alone: left out of the change, by a rule on that
    # gradient (under a thousandth of the median leaf's)
    grad_floor = 1e-3 * median(ref_grad.values())
    moved = [n for n in ref_grad if ref_grad[n] >= grad_floor]
    grad_gap, grad_leaf = checks.worst_leaf(first_grad, ref_grad, list(ref_grad))
    change_gap, change_leaf = checks.worst_leaf(change, ref_change, moved)
    late_grad_gap, late_leaf = checks.worst_leaf(late_grad, ref_late_grad, list(ref_late_grad))
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": grad_gap, "change_gap": change_gap,
        "late_loss_gap": abs(late_loss - ref_late_loss) / abs(ref_late_loss),
        "late_grad_gap": late_grad_gap}
    ctx.log(f"losses {losses} reference {ref_losses}; {len(ref_grad) - len(moved)} "
            f"leaves with a reference gradient under {grad_floor:.3e} left out of "
            f"change_gap; worst grad leaf {grad_leaf}, worst change leaf {change_leaf}; "
            f"late step {i}: loss {late_loss} reference {ref_late_loss}, worst grad "
            f"leaf {late_leaf}")
    steps = len(window_losses)
    failed = sum(not math.isfinite(x) for x in window_losses + losses)
    run_record = SimpleNamespace(
        kind="train", cell=ctx.cell, config=conf, mix=mix, rec=rec,
        setup_s=setup_s, window_s=t1 - t0, t0=t0, t1=t1, steps=steps,
        tokens=steps * tokens_per_step,
        model_flops=steps * flops.train_step_flops(conf, mix["batch"], mix["seq_len"]),
        step_flops=flops.train_step_flops(conf, mix["batch"], mix["seq_len"]),
        profiled_steps=profiled, peak_window_bytes=peak_window,
        profiled=None if prof is None else prof.interval,
        profile=None if prof is None else prof.reduce(ctx.log), dtype=conf["dtype"])
    return SimpleNamespace(run=run_record, numbers=numbers, attempted=steps,
                           failed=failed, peak_bytes=max(peak_setup, peak_window))

