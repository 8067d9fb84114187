"""The port's placement plan (``repro_torch/parallel/sharding.py``) against the
reference's, for all twelve configs' full-size parameter shapes on the
production meshes (16, 16) and (2, 16, 16), with and without ``fsdp``: leaf
for leaf against the reference's ``param_spec_candidates``, ``_fit_spec`` and
``_add_fsdp_axis`` over a stand-in mesh with only ``.shape``, and against the
reference's ``make_param_shardings`` over an abstract JAX mesh; and the batch
and cache plans.  Pure functions of shapes: nothing is allocated."""
import types

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch import configs, convert
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.models.transformer import build_model
from repro_torch.parallel import sharding

MESHES = {"data16_model16": ((16, 16), ("data", "model")),
          "pod2_data16_model16": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _reference_by_functions(tree, mesh, fsdp):
    """The reference's ``make_param_shardings`` leaf rule, composed from its
    own functions over a mesh with only ``.shape``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(p.key for p in path if hasattr(p, "key"))
        stacked = any(n in ("layers", "groups") for n in names)
        spec = ()
        for cand in ref_sharding.param_spec_candidates(names, leaf.shape, stacked):
            fitted = ref_sharding._fit_spec(leaf.shape, cand, mesh)
            if fitted is not None:
                spec = fitted
                if fsdp:
                    fitted2 = ref_sharding._fit_spec(leaf.shape, ref_sharding._add_fsdp_axis(fitted, leaf.shape, mesh),
                                                     mesh)
                    spec = fitted2 if fitted2 is not None else fitted
                break
        out["/".join(names)] = tuple(spec)
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_plan_matches_the_reference(arch, mesh_name, fsdp):
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init, jax.random.PRNGKey(0))
    plan = convert.flatten(sharding.make_param_shardings(convert.unflatten(convert.expected_shapes(
        configs.get_config(arch))), _stand_in(mesh_name), fsdp=fsdp))
    by_functions = _reference_by_functions(ref_shapes, _stand_in(mesh_name), fsdp)
    shape, axes = MESHES[mesh_name]
    whole = ref_sharding.make_param_shardings(ref_shapes, AbstractMesh(shape, axes), fsdp=fsdp)
    by_function = {"/".join(p.key for p in path): tuple(s.spec)
                   for path, s in jax.tree_util.tree_flatten_with_path(whole)[0]}
    assert set(plan) == set(by_functions) == set(by_function)
    for path, spec in plan.items():
        assert tuple(spec) == by_functions[path] == by_function[path], path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_plan_matches_the_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    cfg = configs.get_config(arch)
    caches = build_model(cfg).cache_shape(32, 64)
    plan = sharding.make_cache_shardings(caches, _stand_in(mesh_name))
    for name, (leaf_shape, _) in caches.items():
        want = ref_sharding.make_cache_shardings(jax.ShapeDtypeStruct(leaf_shape, jnp.float32),
                                                 AbstractMesh(shape, axes)).spec
        assert tuple(plan[name]) == tuple(want), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["gpt_a", "hubert_xlarge", "qwen2_vl_7b"])
def test_batch_plan_matches_the_reference(arch, mesh_name):
    """A token batch, an audio batch and a VLM batch, whose (3, B, T) int32
    positions split on dim 1."""
    shape, axes = MESHES[mesh_name]
    cfg = configs.get_smoke_config(arch)
    batch = next(make_batches(cfg, DataConfig(seed=0, batch_size=32, seq_len=8)))
    plan = sharding.make_batch_shardings(batch, _stand_in(mesh_name))
    want = ref_sharding.make_batch_shardings({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()},
                                             AbstractMesh(shape, axes))
    assert {k: tuple(v) for k, v in plan.items()} == {k: tuple(s.spec) for k, s in want.items()}
    if "positions" in batch:
        assert tuple(plan["positions"]) == (None, "data", None)


def test_fit_spec_drops_what_does_not_divide():
    mesh = _stand_in("pod2_data16_model16")
    for shape, spec in [((48, 8), sharding.P(None, "model")), ((60, 2048, 1408), sharding.P("model", None, None)),
                        ((32, 6144), sharding.P(("data", "model"), None)), ((7,), sharding.P("data"))]:
        got = sharding._fit_spec(shape, spec, mesh)
        want = ref_sharding._fit_spec(shape, ref_sharding.P(*spec), mesh)
        assert (got is None and want is None) or tuple(got) == tuple(want), (shape, spec)
    assert repr(sharding.P(None, "model")) == "P(None, 'model')"
