"""The dry-run's shapes (``repro_torch/launch/shapes.py``) against the
reference's ``repro/launch/shapes.py``: the shape table, the per-shape policy,
and every batch and cache leaf's global shape, dtype, fitted spec and local
shape, on both production meshes, equal exactly.  The reference's specs need
no devices: an ``AbstractMesh`` of the production shape carries them, and
``NamedSharding.shard_shape`` gives its local shapes."""
import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import shapes as ref
from repro.models.transformer import build_model as ref_build
from repro_torch.configs import ARCHS
from repro_torch.launch import shapes as port
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models.transformer import build_model

MESHES = {"single": False, "multi": True}


def _meshes(multi_pod):
    shape, names = production_mesh_shape(multi_pod)
    return AbstractMesh(shape, names), Mesh(shape, names)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _ref_leaf(sds):
    return (tuple(sds.shape), _dtype(sds.dtype), tuple(sds.sharding.spec), tuple(sds.sharding.shard_shape(sds.shape)))


def _port_leaf(leaf, mesh):
    return (leaf.shape, _dtype(leaf.dtype), tuple(leaf.spec), port.local_shape(leaf.shape, leaf.spec, mesh))


def _flat_ref(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_the_tables_are_the_reference_s():
    assert port.SHAPES == ref.SHAPES
    assert port.LONG_WINDOW == ref.LONG_WINDOW
    assert ARCHS[:10] == REF_ARCHS[:10]
    assert port.batch_axes(True) == ref.batch_axes(True) and port.batch_axes(False) == ref.batch_axes(False)
    assert port.seq_axes(True) == ref.seq_axes(True) and port.seq_axes(False) == ref.seq_axes(False)


@pytest.mark.parametrize("arch", ARCHS[:10])
def test_policy_batch_and_cache_leaves_equal_the_reference_s(arch):
    for shape in port.SHAPES:
        assert port.shape_supported(arch, shape) == ref.shape_supported(arch, shape)
        cfg, rcfg = port.config_for(arch, shape), ref.config_for(arch, shape)
        assert (cfg.window, cfg.num_layers, cfg.d_model, cfg.name) == (rcfg.window, rcfg.num_layers, rcfg.d_model,
                                                                        rcfg.name)
        if not port.shape_supported(arch, shape)[0]:
            continue
        for mesh_name, multi in MESHES.items():
            amesh, pmesh = _meshes(multi)
            for pipeline in (False, True):
                got = {k: _port_leaf(v, pmesh) for k, v in
                       port.batch_specs(cfg, shape, pmesh, multi_pod=multi, pipeline=pipeline).items()}
                want = {k: _ref_leaf(v) for k, v in
                        ref.batch_specs(rcfg, shape, amesh, multi_pod=multi, pipeline=pipeline).items()}
                assert got == want, (arch, shape, mesh_name, pipeline)
            got = {k: _port_leaf(v, pmesh) for k, v in
                   port.cache_specs(cfg, shape, pmesh, build_model(cfg), multi_pod=multi).items()}
            want = {k: _ref_leaf(v) for k, v in
                    _flat_ref(ref.cache_specs(rcfg, shape, amesh, ref_build(rcfg), multi_pod=multi)).items()}
            assert got == want, (arch, shape, mesh_name)
            assert all(v.value.device.type == "meta" for v in
                       port.cache_specs(cfg, shape, pmesh, build_model(cfg), multi_pod=multi).values())
