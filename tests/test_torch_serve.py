"""The port's contiguous serving slice against the JAX package, on the CPU.

JAX ``make_serve_steps(impl="xla")`` prefill + 8 greedy decode steps
against the port's ``make_serve_steps(impl="kernel", device="cpu")`` (the
kernels' plain versions) with the JAX weights carried across by
``models/convert.py``: logits within 1e-4 at every step and identical greedy
tokens. 1e-4 and not the kernels' 2e-5: the logits come out of two layers of
f32 projections and a vocab-wide head whose sums XLA and torch order
differently.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime.steps import make_serve_steps  # noqa: E402

LOGIT_TOL = 1e-4
B, PROMPT, STEPS = 2, 24, 8


def _jax_serve(cfg, params, prompt):
    arts = j_make_serve_steps(cfg, impl="xla", max_len=PROMPT + STEPS + 1,
                              batch=B, xla_chunk=16)
    caches = arts.cache_init_fn()
    logits, caches = arts.prefill_fn(params, jnp.asarray(prompt), None, caches)
    out_logits = [np.asarray(logits)]
    toks = [np.asarray(jnp.argmax(logits[:, :cfg.vocab_size], axis=-1))]
    for i in range(STEPS):
        logits, caches = arts.decode_fn(params, jnp.asarray(toks[-1]), caches,
                                        jnp.int32(PROMPT + i))
        out_logits.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits[:, :cfg.vocab_size], axis=-1)))
    return np.stack(toks, axis=1), out_logits


@pytest.mark.parametrize("arch,impl,num_splits,window", [
    ("granite_3_2b", "kernel", 1, None),
    ("qwen3_14b", "kernel", 1, None),
    ("granite_3_2b", "kernel", 3, None),
    ("qwen3_14b", "torch", 2, None),
    # sliding window 8 < prompt: the cache is a ring of 8 slots, filled by
    # the prefill's roll and wrapped by every decode write
    ("granite_3_2b", "kernel", 1, 8),
])
def test_serve_slice_matches_jax(arch, impl, num_splits, window):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                               attn_window=window)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                               attn_window=window)
    # granite's vocab 251 padded to 256 (as a sharded JAX run pads it): the
    # converter keeps the padding and greedy decoding ignores the pad logits
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3), vocab_pad_to=8)
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    j_tokens, j_logits = _jax_serve(jcfg, params, prompt)

    tparams = convert_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    arts = make_serve_steps(tcfg, impl=impl, max_len=PROMPT + STEPS + 1,
                            batch=B, torch_chunk=16, num_splits=num_splits,
                            device="cpu")
    res = tserve.greedy_generate(arts, tparams,
                                 torch.from_numpy(prompt).long(), STEPS + 1,
                                 tcfg.vocab_size)
    assert len(res.logits) == len(j_logits) == STEPS + 1
    for step, (tl, jl) in enumerate(zip(res.logits, j_logits)):
        assert tl.shape == jl.shape
        err = float(np.abs(tl.numpy() - jl).max())
        assert err < LOGIT_TOL, f"step {step}: max |dlogit| {err}"
    np.testing.assert_array_equal(res.tokens.numpy(), j_tokens)


def test_convert_rejects_mismatched_params():
    jcfg = dataclasses.replace(jconfigs.smoke_config("granite_3_2b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                               dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises((ValueError, KeyError)):
        convert_params(tcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_14b", "deepseek_67b",
                                  "deepseek_coder_33b", "deepseek_moe_16b",
                                  "dbrx_132b"])
def test_configs_match_jax(arch):
    """The port's copies of the dense and MoE configs carry the JAX fields
    (the MoE settings too)."""
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim", "qk_norm",
              "causal", "attn_window", "block_pattern", "mlp_type",
              "dropout_rate")
    for get in ("get_config", "smoke_config"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}
        assert (t.moe is None) == (j.moe is None)
        if j.moe is not None:
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    assert tconfigs.ARCHS == jconfigs.ARCHS


def test_unported_family_is_named():
    """No family of the JAX package is left unported: the configs name no
    refused arch, llava-next-34b (vlm) serves, and hubert-xlarge (encoder)
    exits with JAX's encoder-only refusal."""
    assert not hasattr(tconfigs, "UNPORTED_FAMILIES")
    assert {tconfigs.get_config(a).family for a in tconfigs.ARCHS} == \
        {jconfigs.get_config(a).family for a in jconfigs.ARCHS}
    res = tserve.main(["--arch", "llava_next_34b", "--smoke", "--device",
                       "cpu", "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    assert res.tokens.shape == (1, 2)
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        tserve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_every_arch_builds_an_lm(arch):
    """Every arch of ``ARCHS`` builds the port's ``LM``: its SMOKE config
    with random weights on the CPU, its full config on the meta device
    (shapes only); a frontend arch carries ``frontend_proj [1024, d]``."""
    for cfg, device in ((tconfigs.smoke_config(arch), "cpu"),
                        (tconfigs.get_config(arch), "meta")):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        model = (tlm.init_params(cfg, seed=0, device=device) if device == "cpu"
                 else tlm.LM(cfg, cfg.vocab_size, device=device))
        assert len(model.blocks) == cfg.num_layers
        assert hasattr(model, "frontend_proj") == (cfg.frontend is not None)
        if cfg.frontend is not None:
            assert model.frontend_proj.shape == (tlm.FRONTEND_DIM, cfg.d_model)


@pytest.mark.parametrize("change", [dict(family="audio_lm"),
                                    dict(mlp_type="swiglu"),
                                    dict(frontend=None),
                                    dict(family="dense", frontend="vision")])
def test_lm_guard_refuses_configs_no_arch_has(change):
    """The ``LM`` guard refuses a made-up family or ``mlp_type``, an encoder
    without a frontend and a dense arch with one."""
    cfg = dataclasses.replace(tconfigs.smoke_config("hubert_xlarge"), **change)
    with pytest.raises(NotImplementedError, match="not an arch of repro_torch"):
        tlm.LM(cfg, cfg.vocab_size, device="meta")


def test_serve_cli_runs_on_cpu(capsys):
    res = tserve.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x16 in" in out and "decode: 3 steps in" in out
    assert res.tokens.shape == (2, 4)
    assert all(torch.isfinite(x).all() for x in res.logits)


def test_init_params_shapes():
    cfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                              dtype=torch.float32)
    model = tlm.init_params(cfg, seed=1, device="cpu")
    assert model.embed.shape == (256, 64) and model.lm_head.shape == (64, 256)
    blk = model.blocks[0]
    assert blk.mixer.wq.shape == (64, 4 * 16) and blk.mixer.wk.shape == (64, 2 * 16)
    assert blk.mlp.wi.shape == (64, 256) and blk.mlp.wo.shape == (128, 64)
    assert float(blk.mixer.q_norm.detach().min()) == 1.0
    assert abs(float(model.embed.detach().std()) - 0.02) < 0.005
