"""The placement plan over every config and mesh (ROADMAP 7b-vi, 7f-iii):
``model_plan`` raises nothing for any config of ``ARCHS``, full and smoke,
on the meshes below, with fsdp off, and on at the reference's 4 MiB and at 0;
the tensor-parallel context keys each plan (``split_dims``,
``stacked_dims``) and the FSDP context finds its dims (``data_dims``).  A
stacked axis is split only where the plan's rule lands on it: ``data`` on a
layer or group axis, ``model`` on the hybrid's M.  Shapes only
(``expected_shapes``): nothing is made."""
import pytest

from repro_torch import configs
from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import FSDP_MIN_BYTES

MESHES = [(2, 2), (1, 2), (2, 1), (16, 16), (2, 16, 16), (2, 2, 2), (2, 2, 1), (1, 4), (4, 1), (1, 3), (5, 1),
          (1, 5)]
VARIANTS = [dict(fsdp=False), dict(fsdp=True, min_bytes=FSDP_MIN_BYTES), dict(fsdp=True, min_bytes=0)]


def _mesh(shape):
    return Mesh(shape, ("pod", "data", "model") if len(shape) == 3 else ("data", "model"))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_the_plan_of_every_config_on_every_mesh(arch, smoke):
    cfg = (configs.get_smoke_config if smoke else configs.get_config)(arch)
    for shape in MESHES:
        for kw in VARIANTS:
            plan = tp.model_plan(cfg, _mesh(shape), **kw)
            if plan is None:
                assert not kw["fsdp"] and (shape[-1] == 1 or not tp.tp_family(cfg)), (shape, kw)
                continue
            specs = flatten(plan)
            for axis in ("model", "data"):
                tp.split_dims(plan, axis)
                assert set(tp.stacked_dims(plan, axis).values()) <= {0 if axis == "data" else 1}, (shape, kw)
                for p, spec in specs.items():
                    stacked = [d for d, e in enumerate(tuple(spec)[:tp.lead_axes(p)]) if tp.is_split((e,), axis)]
                    assert stacked in ([], [0] if axis == "data" else [1]), (shape, kw, p, spec)
            dims = fsdp.data_dims(plan)
            assert all(tuple(specs[p])[d] == "data" for p, d in dims.items())
