"""Helpers of the tensor-parallel tests (``tests/test_torch_tensor_parallel*.py``).

``tp_loss_rank`` is a rank of a ``gloo`` world spawned by
``torch_pipeline_helpers.spawn``: this rank's shards of the whole model under
the placement plan (``shard_params``), and one ``DataParallelLoss`` call with
tensor parallelism over ``model`` on a global batch.  ``gathered`` puts
the ranks' gradient blocks back together.  This module imports no JAX at its
top, so the ranks never load it; ``reference_value_and_grad`` (the parent's) does.
"""
from __future__ import annotations

import numpy as np
import torch

AXES = ("data", "model")


def tp_loss_rank(rank: int, cfg, shape, params, batches) -> dict:
    """This rank of (data, model) = ``shape``: its shards of ``params`` (the
    whole model where ``model_plan`` gives no plan) and, for
    each batch of ``batches``, the loss, gradients (its blocks, summed over
    ``data``), their norm and the transport's byte counts of one call."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = make_mesh(shape, AXES)
    plan = model_plan(cfg, mesh)
    shards = shard_params(params, mesh, plan) if plan is not None else params
    out = {"coords": mesh.coords, "runs": []}
    for batch in batches:
        loss_fn = DataParallelLoss(build_model(cfg).loss, mesh, plan=plan)
        loss, grads = loss_fn(shards, batch)
        out["runs"].append({"loss": loss, "grads": {p: g.detach() for p, g in grads.items()},
                            "grad_norm": loss_fn.grad_norm(grads), "bytes": loss_fn.transport.counts()})
    return out


def gathered(results, plan, run: int) -> dict:
    """The whole model's gradients of run ``run`` (flat) from the ranks of
    ``data`` coordinate 0, in ``model`` order (``unshard``)."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.parallel.sharding import unshard

    ranks = sorted((r for r in results if r["coords"]["data"] == 0), key=lambda r: r["coords"]["model"])
    return flatten(unshard([unflatten(r["runs"][run]["grads"]) for r in ranks], plan))


def reference_value_and_grad(ref_cfg, ref_params, batch_np: dict):
    """``jax.value_and_grad`` of the reference's ``model.loss`` on one batch:
    (value, flat gradients as numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import build_model

    from torch_pipeline_helpers import _jax_flat

    model = build_model(ref_cfg)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (value, _), grads = jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch), has_aux=True))(ref_params)
    return float(value), {k: np.asarray(v) for k, v in _jax_flat(grads).items()}


def close_in_norm(got: dict, want: dict, tol: float) -> None:
    """Every leaf of ``got`` (torch) within ``tol`` of ``want`` (numpy),
    relative in norm; the same keys."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = torch.from_numpy(np.array(w, dtype=np.float32))
        g = got[k].float()
        assert float((g - w).norm()) <= tol * float(w.norm()), (k, float((g - w).norm() / w.norm()))
