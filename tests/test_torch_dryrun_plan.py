"""``plan_bytes_per_device`` of the port's dry-run against the reference's
placement plan: for every arch the f32 parameters one device holds under
``make_param_shardings`` equal the sum of the reference's ``shard_shape``s,
on both production meshes, with fsdp on and off, and on the head-aligned
single-pod mesh of ``--relayout``.  The reference's shardings are taken on an
``AbstractMesh``; no device is needed."""
import math

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.models.transformer import build_model as ref_build
from repro.parallel.sharding import make_param_shardings as ref_shardings
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape


def _ref_plan_bytes(p_shapes, mesh, fsdp):
    shardings = ref_shardings(p_shapes, mesh, fsdp=fsdp)
    return sum(math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
               for s, sh in zip(jax.tree.leaves(p_shapes), jax.tree.leaves(shardings)))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_bytes_equal_the_reference_shard_shapes(arch):
    cfg = get_config(arch)
    p_shapes = jax.eval_shape(ref_build(ref_config(arch)).init, jax.random.PRNGKey(0))
    for multi in (False, True):
        shape, names = production_mesh_shape(multi)
        for fsdp in (False, True):
            got = dryrun.plan_bytes(cfg, dryrun.plan_mesh(cfg, multi), fsdp=fsdp)
            assert got == _ref_plan_bytes(p_shapes, AbstractMesh(shape, names), fsdp), (arch, multi, fsdp)
    # --relayout: the same 256 devices as (256 / tp, tp), tp on head boundaries
    tp = dryrun.head_aligned_tp(cfg)
    mesh = dryrun.plan_mesh(cfg, False, relayout=True)
    assert dict(mesh.shape) == {"data": 256 // tp, "model": tp}
    for fsdp in (False, True):
        got = dryrun.plan_bytes(cfg, mesh, fsdp=fsdp)
        assert got == _ref_plan_bytes(p_shapes, AbstractMesh((256 // tp, tp), ("data", "model")), fsdp), (arch, fsdp)
