"""The plain reference against the port's plain path (the CUDA kernels'
plain versions on the CPU), at a small size, on the same weights from the
same seed: logits, loss, every gradient, and the AdamW step. The test
imports both; the reference imports neither."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import cell, traffic, weights
from bench.reference import transformer as ref
from bench_small import config, mix
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.steps import place_batch

CASES = [("granite-3-2b", "train-4k"), ("hubert-xlarge", "train-1k")]


def _both(name, seed=3):
    conf = config(name)
    cfg = cell.arch_config(conf)
    model = lm.LM(cfg, cfg.vocab_size, device="cpu")
    weights.load(lambda n, t: model.get_parameter(n).copy_(t), ref.leaves(conf),
                 seed, "cpu")
    return conf, cfg, model, weights.own(ref.leaves(conf), seed, "cpu")


def test_leaves_are_the_programs():
    for name, _ in CASES:
        conf, cfg, model, p = _both(name)
        assert {n: tuple(t.shape) for n, t in model.named_parameters()} == \
            {n: tuple(t.shape) for n, t in p.items()}


@pytest.mark.parametrize("name,traffic_name", CASES)
def test_loss_and_gradients(name, traffic_name):
    conf, cfg, model, p = _both(name)
    host = traffic.train_batch(mix(traffic_name), conf, 11, 0)
    batch = place_batch(host, "cpu")
    loss, _ = lm.loss_fn(cfg, model, batch, Ctx(impl="kernel"))
    loss.backward()
    for t in p.values():
        t.requires_grad_(True)
    rloss = ref.loss(p, conf, {k: torch.as_tensor(v) for k, v in host.items()})
    rloss.backward()
    assert abs(float(loss.detach()) - float(rloss.detach())) <= 1e-6 * abs(float(rloss.detach()))
    for n, w in model.named_parameters():
        g = torch.zeros_like(w) if w.grad is None else w.grad
        rg = torch.zeros_like(w) if p[n].grad is None else p[n].grad
        scale = max(float(rg.abs().max()), 1e-12)
        assert float((g - rg).abs().max()) <= 5e-5 * scale, n


def test_adamw_step_matches():
    conf, cfg, model, p = _both("granite-3-2b")
    opt = AdamWConfig(**mix("train-4k")["optimizer"])
    host = [traffic.train_batch(mix("train-4k"), conf, 5, i) for i in range(2)]
    state = adamw_init(model, opt)
    for i, hb in enumerate(host):
        loss, _ = lm.loss_fn(cfg, model, place_batch(hb, "cpu"), Ctx(impl="kernel"))
        loss.backward()
        grads = {n: w.grad for n, w in model.named_parameters()}
        for w in model.parameters():
            w.grad = None
        adamw_update(grads, state, model, opt)
    ref.train(p, conf, [{k: torch.as_tensor(v) for k, v in hb.items()} for hb in host],
              dataclasses.asdict(opt))
    for n, w in model.named_parameters():
        assert float((w.detach() - p[n]).abs().max()) <= 1e-5, n


def test_served_logits():
    conf, cfg, model, p = _both("granite-3-2b")
    tokens = torch.as_tensor(np.arange(40) % conf["vocab_size"])
    with torch.no_grad():
        got, _, _ = lm.forward(cfg, model, Ctx(impl="kernel"), tokens=tokens[None])
    want = ref.logits_rows(p, conf, tokens, list(range(40)))
    assert float((got[0] - want).abs().max()) <= 1e-5 * float(want.abs().max())
