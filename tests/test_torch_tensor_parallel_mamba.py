"""Tensor parallelism over ``model`` for the pure Mamba2 stack on the plain step
(ROADMAP 7b-v): ``DataParallelLoss`` with the reference's placement plan on
``gloo`` ranks of the CPU, each holding its shards, against
``jax.value_and_grad`` of the reference's ``model.loss`` on the whole batch,
zamba2 smoke as the pure stack (``family="ssm"``, the same ``replace`` in both
packages) in f32 from the port's seed-0 parameters.

The plan splits the stack by heads, as the reference's Mamba2 docstring lays
it out: ``w_z``, ``w_x`` and ``conv_x`` on d_inner, ``w_out`` on its rows and
``norm_scale`` on its features; ``w_bc``, ``w_dt``, ``conv_bc``, ``A_log``,
``D`` and ``dt_bias`` stay whole.  A rank runs the SSD on 4 of the smoke's 8
heads, and the gated norm's statistic spans the ranks.  Cases: (data, model)
= (1, 2) and (2, 2), and (1, 2) with remat "full", so that the recomputation
runs under the ``model`` context.  Loss f32 1e-5, gradients 1e-4 relative in
norm a leaf, and the global norm.  The transport counts, over ``model`` and
``data``, what the code owes (``bytes_owed``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, spawn
from torch_tp_helpers import close_in_norm, gathered, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
AXES = ("data", "model")
ARCH = "zamba2_2p7b"
CASES = [((1, 2), "none"), ((2, 2), "none"), ((1, 2), "full")]
IDS = [f"{'x'.join(map(str, m))}-remat_{r}" for m, r in CASES]
HEADS = {"w_z": 1, "w_x": 1, "conv_x": 1, "w_out": 0, "norm_scale": 0}
WHOLE = ("w_bc", "w_dt", "conv_bc", "A_log", "D", "dt_bias")


def pure_case(remat: str = "none"):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of the pure
    Mamba2 stack at zamba2 smoke's widths in f32 under ``remat``."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), family="ssm", dtype=torch.float32, remat=remat)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), family="ssm", dtype=jnp.float32, remat=remat)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def bytes_owed(cfg, shape, shard_elems: int) -> dict:
    """What one ``DataParallelLoss`` call and its ``grad_norm`` put on each
    axis from a rank, in f32, from the code.  ``act`` is a rank's (rows, SEQ,
    d), ``tok`` its rows x SEQ, H the layer's heads.

    ``model``, a layer: forward, the gated norm's sum of squares (tok) and
    ``w_out``'s output (act) are reduced; backward, the gradients of
    ``copy_in(x)`` (act), of B and C (tok x 2 d_state) and of the sum of
    squares (tok) are summed, and ``slice_`` gathers those of dt (tok x H /
    TP), A and D (H / TP each).  Under remat "full" the recomputation
    repeats the sum of squares' reduction and stops at ``w_out``'s product,
    the last that saves a tensor, before its sum.  Then the embedding
    gathers its columns (act / TP); the head sums the loss's input gradient
    (act) and the cross entropy's sums (2, rows, SEQ) and gathers its maxima
    (1, rows, SEQ); the norm reduces one f32.

    ``data``: the mask count, the gradients of the rank's shards and the
    loss, where ``data`` splits the batch."""
    DP, TP = shape
    tok = BATCH // DP * SEQ
    act = 4 * tok * cfg.d_model
    H = cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim
    k = 2 if cfg.remat == "full" else 1
    layer_reduce = k * 4 * tok + act + act + 4 * tok * 2 * cfg.ssm.d_state + 4 * tok
    layer_gather = 4 * tok * H // TP + 2 * 4 * H // TP
    reduce = cfg.num_layers * layer_reduce + act + 4 * 2 * tok + 4
    gather = cfg.num_layers * layer_gather + act // TP + 4 * tok
    data = 4 * shard_elems + 8 if DP > 1 else 0
    return {"data": {"send": 0, "all_reduce": data, "all_gather": 0, "reduce_scatter": 0},
            "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    shape, remat = request.param
    cfg, ref_cfg, params = pure_case(remat)
    assert tp.tp_family(cfg)
    batch = input_batch_for(cfg, BATCH, SEQ)
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path_factory.mktemp("pure"), cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return {"cfg": cfg, "shape": shape, "plan": tp.model_plan(cfg, Mesh(shape, AXES)), "ref": ref,
            "results": results}


def test_the_tp_pure_stack_loss_and_gradients_are_the_reference_s(case):
    ref_loss, ref_grads = case["ref"]
    results, plan = case["results"], case["plan"]
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)


def test_the_stack_splits_by_heads(case):
    """The plan's dims, and each rank's gradients: its columns of d_inner in
    ``w_z``, ``w_x`` and ``conv_x``, its rows of ``w_out``, its features of
    ``norm_scale``; the leaves the SSD's heads share whole, the same bits on
    every ``model`` rank of a ``data`` rank."""
    cfg, TP = case["cfg"], case["shape"][1]
    dims = tp.split_dims(case["plan"])
    assert {n: dims[n] for n in HEADS} == HEADS and all(dims[n] is None for n in WHOLE + ("ln",))
    L, d, W = cfg.num_layers, cfg.d_model, cfg.ssm.conv_width
    d_in = d * cfg.ssm.expand
    for r in case["results"]:
        g = r["runs"][0]["grads"]
        assert tuple(g["layers/mamba/w_z"].shape) == (L, d, d_in // TP)
        assert tuple(g["layers/mamba/conv_x"].shape) == (L, W, d_in // TP)
        assert tuple(g["layers/mamba/w_out"].shape) == (L, d_in // TP, d)
        assert tuple(g["layers/mamba/norm_scale"].shape) == (L, d_in // TP)
        peer = next(q for q in case["results"] if q["coords"]["data"] == r["coords"]["data"]
                    and q["coords"]["model"] != r["coords"]["model"])
        for leaf in [f"layers/mamba/{n}" for n in WHOLE] + ["layers/ln", "final_norm"]:
            assert torch.equal(g[leaf], peer["runs"][0]["grads"][leaf]), leaf


def test_bytes_each_rank_puts_on_each_axis(case):
    for r in case["results"]:
        elems = sum(g.numel() for g in r["runs"][0]["grads"].values())
        want = bytes_owed(case["cfg"], case["shape"], elems)
        assert r["runs"][0]["bytes"] == want, (r["coords"], r["runs"][0]["bytes"], want)


def test_no_context_and_one_rank_change_nothing():
    """With a context of one ``model`` rank (a plan made for two) the pure
    stack computes the loss and gradients of no context, bit for bit."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.transport import Transport

    cfg, _, params = pure_case()
    batch = {k: torch.from_numpy(v) for k, v in input_batch_for(cfg, 2, SEQ).items()}
    model = build_model(cfg)

    def loss_and_grads():
        leaves = [t.detach().requires_grad_(True) for t in convert.flatten(params).values()]
        loss, _ = model.loss(convert.unflatten(dict(zip(convert.flatten(params), leaves))), batch)
        return loss, torch.autograd.grad(loss, leaves)

    plain, plain_grads = loss_and_grads()
    mesh = Mesh((1, 1), AXES)
    with tp.use(tp.TPContext(mesh, Transport(mesh), tp.model_plan(cfg, Mesh((1, 2), AXES)))):
        same, same_grads = loss_and_grads()
    assert torch.equal(plain, same)
    assert all(torch.equal(a, b) for a, b in zip(plain_grads, same_grads))
