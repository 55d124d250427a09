"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, on the CPU.

JAX's rules run on a host-only mesh (the one CPU device tiled, as
``tests/test_sharding_rules.py`` builds it; a spec consults only the
mesh's shape); the port's take an object with that shape. For all ten
archs (CONFIG and SMOKE) on five meshes, in training, serving and decode:
the rule dicts, every parameter's spec (by port name and shape, against
JAX's ``spec_for`` of its spec with the stacked ``layers`` lead dropped),
the fallbacks, ``vocab_pad_for`` and ``uses_fsdp_profile`` are equal. Then
the counterparts of the JAX suite's rule tests, and the config fields.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.sharding import (_fsdp_rules, default_rules,  # noqa: E402
                                             uses_fsdp_profile, vocab_pad_for)
from repro_torch.models import lm  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4": ((4,), ("model",)),
    "2x4": ((2, 4), ("data", "model")),
}
MODES = {"train": {}, "serve": {"serve": True},
         "decode": {"serve": True, "decode": True}}


def fake_mesh(shape, axes):
    """JAX's host-only mesh (``tests/test_sharding_rules.py``)."""
    devs = np.tile(np.array(jax.devices()[:1]), int(np.prod(shape)))
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def shape_of(shape, axes):
    """The port's view of a mesh: its axis sizes."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


MESH = shape_of(*MESHES["16x16"])
MESH3 = shape_of(*MESHES["2x16x16"])


def _jax_leaves(tree, path=()):
    """{path tuple: leaf} of a JAX params / specs tree (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _jax_path(cfg, name: str):
    """The JAX path of a port parameter, and whether it is stacked."""
    if not name.startswith("blocks."):
        return (name,), False
    _, i, rest = name.split(".", 2)
    period = len(cfg.block_pattern)
    n_super = cfg.num_layers // period
    i = int(i)
    if i < n_super * period:
        return ("blocks", f"sub_{i % period}", *rest.split(".")), True
    return ("tail", f"tail_{i - n_super * period}", *rest.split(".")), False


@functools.lru_cache(maxsize=None)
def _abstract(arch, smoke, vpad):
    """JAX's (shapes, specs) leaves of an arch's params, by path."""
    cfg = (jconfigs.smoke_config if smoke else jconfigs.get_config)(arch)
    shapes, specs = jlm.abstract_params(cfg, vocab_pad_to=vpad)
    return _jax_leaves(shapes), _jax_leaves(specs)


def _jp(p, n):
    """A JAX PartitionSpec as the port's tuple of ``n`` entries."""
    return tuple(p) + (None,) * (n - len(tuple(p)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_rules_and_param_specs_match_jax(arch, smoke, mesh_name):
    get = "smoke_config" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
    shape, axes = MESHES[mesh_name]
    jmesh, tmesh = fake_mesh(shape, axes), shape_of(shape, axes)
    assert vocab_pad_for(tmesh) == jsharding.vocab_pad_for(jmesh)
    assert uses_fsdp_profile(tcfg) == jsharding.uses_fsdp_profile(jcfg)
    vpad = vocab_pad_for(tmesh)
    jshapes, jspecs = _abstract(arch, smoke, vpad)
    logical = lm.param_specs(tcfg)
    tshapes = {n: tuple(p.shape) for n, p in
               lm.LM(tcfg, lm.padded_vocab(tcfg, vpad), device="meta")
               .named_parameters()}
    assert len(tshapes) == len(logical)
    assert sum(int(np.prod(s)) for s in tshapes.values()) == \
        sum(int(np.prod(s.shape)) for s in jshapes.values())
    for mode, kw in MODES.items():
        jr = jsharding.default_rules(jmesh, jcfg, **kw)
        tr = default_rules(tmesh, tcfg, **kw)
        assert tr.rules == jr.rules, mode
        for name, tshape in tshapes.items():
            path, stacked = _jax_path(jcfg, name)
            jspec, jshape = jspecs[path], tuple(jshapes[path].shape)
            if stacked:
                assert jspec[0] == "layers"
                jspec, jshape = jspec[1:], jshape[1:]
            assert logical[name] == tuple(jspec), name
            assert tshape == jshape, name
            want = _jp(jr.spec_for(tuple(jspec), jshape), len(jspec))
            assert tr.spec_for(logical[name], tshape) == want, (mode, name)
        assert tr.fallbacks == jr.fallbacks, mode


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_sharding_fields_match_jax(arch, smoke):
    get = "smoke_config" if smoke else "get_config"
    j, t = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
    assert (t.fsdp, t.sharding_profile, t.ctx_parallel_attn) == \
        (j.fsdp, j.sharding_profile, j.ctx_parallel_attn)


# --- the counterparts of tests/test_sharding_rules.py ---------------------

def test_divisible_dims_shard():
    rules = default_rules(MESH, configs.get_config("granite_3_2b"))
    assert rules.spec_for(("embed", "mlp"), (2048, 8192)) == (None, "model")
    assert rules.spec_for(("batch", None), (256, 4096)) == ("data", None)


def test_non_divisible_falls_back_to_replication():
    cfg = dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                              ctx_parallel_attn=False)
    rules = default_rules(MESH, cfg)
    spec = rules.spec_for(("batch", "heads", "seq_full", "head_dim"),
                          (256, 10, 4096, 256))
    assert spec == ("data", None, None, None)
    assert rules.rules["heads"] is None


def test_non_divisible_heads_with_ctx_parallel_shard_seq():
    rules = default_rules(MESH, configs.get_config("recurrentgemma_2b"))
    spec = rules.spec_for(("batch", "heads", "seq_full", "head_dim"),
                          (256, 10, 4096, 256))
    assert spec == ("data", None, "model", None)


def test_axis_used_at_most_once():
    rules = default_rules(MESH, configs.get_config("deepseek_moe_16b"))
    spec = rules.spec_for(("batch", "kv_heads", "kv_cache_seq", "head_dim"),
                          (128, 16, 32768, 128))
    assert spec == ("data", "model", None, None)
    rules2 = default_rules(MESH, configs.get_config("granite_3_2b"))
    spec2 = rules2.spec_for(("batch", "kv_heads", "kv_cache_seq", "head_dim"),
                            (128, 8, 32768, 64))
    assert spec2 == ("data", None, "model", None)


def test_multipod_batch_spans_pod_and_data():
    rules = default_rules(MESH3, configs.get_config("granite_3_2b"))
    assert rules.spec_for(("batch", None), (256, 4096)) == (("pod", "data"), None)


def test_fsdp_profile_shards_params_over_both_axes():
    cfg = dataclasses.replace(configs.get_config("deepseek_67b"),
                              sharding_profile="fsdp")
    rules = default_rules(MESH, cfg)
    assert rules.spec_for(("embed", "mlp"), (8192, 22016)) == \
        (("data", "model"), None)
    assert rules.spec_for(("batch", None), (256, 4096)) == \
        (("data", "model"), None)
    assert rules.rules["heads"] is None and rules.rules["mlp"] is None


def test_vocab_padding_divisibility():
    rules = default_rules(MESH, configs.get_config("granite_3_2b"))
    assert rules.spec_for(("vocab", "embed"), (49155, 2048)) == (None, None)
    assert rules.spec_for(("vocab", "embed"), (49168, 2048)) == ("model", None)
    assert lm.padded_vocab(configs.get_config("granite_3_2b"),
                           vocab_pad_for(MESH)) == 49168


def test_fsdp_profile_needs_explicit_opt_in():
    cfg = configs.get_config("granite_3_2b")
    assert cfg.sharding_profile == "fsdp" and not cfg.fsdp
    rules = default_rules(MESH, cfg)
    assert rules.rules["mlp"] == "model"
    assert rules.rules["vocab"] == "model"
    assert rules.rules["embed"] is None
    cfg2 = dataclasses.replace(cfg, fsdp=True)
    rules2 = default_rules(MESH, cfg2)
    assert rules2.rules["embed"] == ("data", "model")
    assert rules2.rules["mlp"] is None
    assert default_rules(MESH, cfg2, serve=True).rules["mlp"] == "model"


def test_fsdp_rules_direct():
    cfg = configs.get_config("deepseek_67b")
    rules = _fsdp_rules(MESH, cfg)
    assert rules.rules["batch"] == ("data", "model")
    assert rules.rules["embed"] == ("data", "model")
    assert rules.rules["moe_groups"] == ("data", "model")
    for name in ("heads", "kv_heads", "mlp", "vocab", "experts", "rnn",
                 "q_proj", "kv_proj", "kv_cache_seq", "seq"):
        assert rules.rules[name] is None, name
    assert _fsdp_rules(MESH3, cfg).rules["batch"] == ("data", "model")
    assert rules.spec_for(("embed", "mlp"), (100, 22016)) == (None, None)
    mesh1 = shape_of((8,), ("data",))
    assert _fsdp_rules(mesh1, cfg).rules["embed"] == "data"


def test_vocab_pad_for():
    assert vocab_pad_for(MESH) == 16
    assert vocab_pad_for(MESH3) == 16
    assert vocab_pad_for(shape_of((8,), ("data",))) == 1


def test_all_archs_build_rules_on_both_meshes():
    for name in configs.ARCHS:
        cfg = configs.get_config(name)
        for mesh in (MESH, MESH3):
            assert "batch" in default_rules(mesh, cfg).rules
