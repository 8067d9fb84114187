"""Meshes of ranks (``repro_torch/launch/mesh.py``): the host and production
mesh shapes against the reference's arithmetic (its ``make_host_mesh`` and
``make_production_mesh`` over n stand-in devices), the row-major rank layout,
a world of one process as a mesh of ones whose collectives are identities,
and the launcher's refusal of a multi-rank mesh without process groups
(data parallelism and checkpoints under ``--pipeline`` now run)."""
import dataclasses
import os

import pytest
import torch

from repro.launch import mesh as ref_mesh
from repro_torch import configs
from repro_torch.launch import mesh
from repro_torch.launch.train import train
from repro_torch.parallel.pipeline import make_pipeline_loss
from repro_torch.parallel.transport import Transport


@pytest.fixture
def stand_in_devices(monkeypatch):
    """The reference's mesh functions over ``n`` stand-in devices: returns a
    function of n giving what they would pass to ``jax.make_mesh``."""

    def shapes(n, **kw):
        monkeypatch.setattr(ref_mesh.jax, "devices", lambda: [None] * n)
        monkeypatch.setattr(ref_mesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
        return kw

    return shapes


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_host_mesh_shapes_match_the_reference(stand_in_devices, n, multi_pod):
    stand_in_devices(n)
    try:
        want = ref_mesh.make_host_mesh(multi_pod=multi_pod)
    except AssertionError:
        with pytest.raises(ValueError):
            mesh.host_mesh_shape(n, multi_pod)
        return
    assert mesh.host_mesh_shape(n, multi_pod) == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes_match_the_reference(stand_in_devices, multi_pod):
    stand_in_devices(1)
    assert mesh.production_mesh_shape(multi_pod) == ref_mesh.make_production_mesh(multi_pod=multi_pod)


def test_a_world_of_one_refuses_the_production_mesh_and_names_the_sizes():
    with pytest.raises(ValueError, match="needs 512 ranks; the world has 1"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh.make_production_mesh()


def test_ranks_are_laid_out_row_major():
    """rank = (pod * DP + data) * TP + model, as jax.make_mesh lays devices out."""
    for r in range(2 * 3 * 4):
        m = mesh.Mesh((2, 3, 4), ("pod", "data", "model"), r)
        c = m.coords
        assert (c["pod"] * 3 + c["data"]) * 4 + c["model"] == r
        assert m.rank_at(pod=1 - c["pod"]) == ((1 - c["pod"]) * 3 + c["data"]) * 4 + c["model"]


def test_a_world_of_one_is_a_mesh_of_ones_with_identity_collectives():
    m = mesh.make_host_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0 and m.size == 1
    m3 = mesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    tr = Transport(m3)
    t = torch.arange(6.0).reshape(2, 3)
    assert tr.all_reduce(t, "data") is t and torch.equal(tr.all_gather(t, "model", 1), t)
    assert all(v == 0 for ops in tr.bytes.values() for v in ops.values())
    with pytest.raises(ValueError, match="no neighbour"):
        tr.send(t, "pod", 1)


def test_the_launcher_refuses_what_is_not_ported(tmp_path):
    """Slices 7d and 7c are ported: a plain step over several ranks needs the
    mesh's process groups (``make_mesh``) and refuses a mesh without them, and
    a pipelined run on a world of one saves its state as a plain run does."""
    cfg = configs.get_smoke_config("gpt_a")
    with pytest.raises(RuntimeError, match="make_mesh"):
        train(cfg, steps=1, batch=8, seq=8, device="cpu", mesh=mesh.Mesh((2, 2), ("data", "model")))
    out = train(cfg, steps=1, batch=8, seq=8, device="cpu", pipeline=True, ckpt_dir=str(tmp_path),
                mesh=mesh.Mesh((1, 1, 1), ("pod", "data", "model")))
    assert out["checkpoint"]["path"] == str(tmp_path / "step_00000001.npz")
    assert os.path.exists(out["checkpoint"]["path"])


def test_the_pipeline_refuses_what_the_reference_refuses():
    m = mesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = configs.get_smoke_config("gpt_a")
    with pytest.raises(ValueError, match="untied"):
        make_pipeline_loss(dataclasses.replace(cfg, tie_embeddings=True), m)
    with pytest.raises(ValueError, match="boundary"):
        make_pipeline_loss(cfg, m, boundary="diagonal")
    loss = make_pipeline_loss(cfg, m, n_micro=3)
    with pytest.raises(ValueError, match="microbatches"):
        loss({}, {"tokens": torch.zeros((4, 8), dtype=torch.int32)})
