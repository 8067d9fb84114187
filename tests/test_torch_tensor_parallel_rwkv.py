"""Tensor parallelism over ``model`` for RWKV-6 on the plain step (ROADMAP
7b-iii): ``DataParallelLoss`` with the reference's placement plan on ``gloo``
ranks of the CPU, each holding its shards, against ``jax.value_and_grad`` of
the reference's ``model.loss`` on the whole batch, rwkv6 smoke in f32 from the
port's seed-0 parameters.

The plan splits the time mix by heads (``wr``, ``wk``, ``wv``, ``wg`` and
``w_lora_b`` on their output dim, ``w0`` and ``u`` on the heads, ``wo`` on its
rows) and the channel mix on d_ff and d (``ck``, ``cr`` on their output dim,
``cv`` on its rows); the ``mu_*``, ``ln_scale`` and ``w_lora_a`` stay whole, and
a rank runs the WKV-6 recurrence on its one of the smoke's two heads.  Cases:
(data, model) = (1, 2) and (2, 2), and (1, 2) with remat "full", so that the
recomputation runs under the ``model`` context.  Loss f32 1e-5, gradients 1e-4
relative in norm a leaf, and the global norm.  The transport counts, over
``model`` and ``data``, what the code owes (``bytes_owed``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.mesh import Mesh
from repro_torch.models.rwkv import LORA
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, spawn
from torch_tp_helpers import close_in_norm, gathered, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
AXES = ("data", "model")
ARCH = "rwkv6_7b"
CASES = [((1, 2), "none"), ((2, 2), "none"), ((1, 2), "full")]
IDS = [f"{'x'.join(map(str, m))}-remat_{r}" for m, r in CASES]
SPLIT = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w0": 0, "u": 0, "w_lora_a": None, "w_lora_b": 1,
         "ck": 1, "cv": 0, "cr": 1}


def rwkv_case(remat: str = "none"):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of rwkv6 smoke
    in f32 under ``remat``."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype=torch.float32, remat=remat)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), dtype=jnp.float32, remat=remat)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def bytes_owed(cfg, shape, shard_elems: int) -> dict:
    """What one ``DataParallelLoss`` call and its ``grad_norm`` put on each
    axis from a rank, in f32, from the code.  ``act`` is a rank's (rows, SEQ,
    d).

    ``model``, a layer: forward, ``wo``'s output and ``cv``'s are reduced
    (2 act) and the receptance's columns gathered (act / TP); backward, the
    gradients of the four ``copy_in`` inputs of the time mix (4 act), of the
    LoRA's ``tanh`` (rows, SEQ, 64) and of ``xk2`` (act) are summed.  Under
    remat "full" the recomputation repeats the forward's three: the block's
    last product reads both ``cv``'s sum and the gathered receptance.  Then
    the embedding gathers its columns (act / TP); the head sums the loss's
    input gradient (act) and the cross entropy's sums (2, rows, SEQ) and
    gathers its maxima (1, rows, SEQ); the norm reduces one f32.

    ``data``: the mask count, the gradients of the rank's shards and the
    loss, where ``data`` splits the batch."""
    DP, TP = shape
    tok = BATCH // DP * SEQ
    act = 4 * tok * cfg.d_model
    k = 2 if cfg.remat == "full" else 1
    layer_reduce = k * 2 * act + 5 * act + 4 * tok * LORA
    layer_gather = k * act // TP
    reduce = cfg.num_layers * layer_reduce + act + 4 * 2 * tok + 4
    gather = cfg.num_layers * layer_gather + act // TP + 4 * tok
    data = 4 * shard_elems + 8 if DP > 1 else 0
    return {"data": {"send": 0, "all_reduce": data, "all_gather": 0, "reduce_scatter": 0},
            "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    shape, remat = request.param
    cfg, ref_cfg, params = rwkv_case(remat)
    assert tp.tp_family(cfg)
    batch = input_batch_for(cfg, BATCH, SEQ)
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path_factory.mktemp("rwkv"), cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return {"cfg": cfg, "shape": shape, "plan": tp.model_plan(cfg, Mesh(shape, AXES)), "ref": ref,
            "results": results}


def test_the_tp_rwkv_loss_and_gradients_are_the_reference_s(case):
    ref_loss, ref_grads = case["ref"]
    results, plan = case["results"], case["plan"]
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)


def test_the_time_mix_splits_by_heads(case):
    """The plan's dims, and each rank's gradients: its head of ``u`` and of
    ``w0``, its columns of the projections, the whole ``mu_*`` and
    ``w_lora_a``, the same bits on every ``model`` rank of a ``data`` rank."""
    cfg, TP = case["cfg"], case["shape"][1]
    dims = tp.split_dims(case["plan"])
    assert {n: dims[n] for n in SPLIT} == SPLIT
    assert all(dims[f"mu_{n}"] is None for n in ("r", "k", "v", "w", "g", "ck")) and dims["ln_scale"] is None
    L, d, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.rwkv.head_dim
    for r in case["results"]:
        g = r["runs"][0]["grads"]
        assert tuple(g["layers/u"].shape) == (L, H // TP, hd) and tuple(g["layers/w0"].shape) == (L, d // TP)
        assert tuple(g["layers/wr"].shape) == (L, d, d // TP) and tuple(g["layers/wo"].shape) == (L, d // TP, d)
        assert tuple(g["layers/cv"].shape) == (L, cfg.d_ff // TP, d)
        peer = next(q for q in case["results"] if q["coords"]["data"] == r["coords"]["data"]
                    and q["coords"]["model"] != r["coords"]["model"])
        for leaf in ("layers/mu_r", "layers/mu_w", "layers/mu_ck", "layers/w_lora_a", "layers/ln_scale", "final_norm"):
            assert torch.equal(g[leaf], peer["runs"][0]["grads"][leaf]), leaf


def test_bytes_each_rank_puts_on_each_axis(case):
    for r in case["results"]:
        elems = sum(g.numel() for g in r["runs"][0]["grads"].values())
        want = bytes_owed(case["cfg"], case["shape"], elems)
        assert r["runs"][0]["bytes"] == want, (r["coords"], r["runs"][0]["bytes"], want)


def test_no_context_and_one_rank_change_nothing():
    """With a context of one ``model`` rank (a plan made for two) RWKV-6
    computes the loss and gradients of no context, bit for bit."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.transport import Transport

    cfg, _, params = rwkv_case()
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


def test_rwkv_raises_where_its_heads_do_not_divide_model():
    """rwkv6 smoke's 2 heads on a ``model`` axis of 4: the plan splits the
    projections' 128 columns (32 a rank, half a head) but leaves ``u`` (2,
    64) whole.  Once refused, the cut route now runs it: rank 0's block on
    ``meta`` over a ``MetaTransport`` gathers r, k, v, g, the log-decay and
    the receptance (its 32 columns each), runs all 2 heads and gives the
    whole (1, SEQ, d) output; the spawned runs against the reference are
    ``test_torch_tensor_parallel_cut_heads.py``'s."""
    from repro_torch.models.rwkv import _rwkv_split, rwkv6_apply
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.transport import MetaTransport

    cfg, _, params = rwkv_case()
    mesh = Mesh((1, 4), AXES, 0)
    plan = tp.model_plan(cfg, mesh)
    assert tp.split_dims(plan)["wr"] == 1 and tp.split_dims(plan)["u"] is None
    layer = {k: v[0].to("meta") for k, v in shard_params(params, mesh, plan)["layers"].items()}
    assert tuple(layer["wr"].shape) == (128, 32) and tuple(layer["u"].shape) == (2, 64)
    transport = MetaTransport(mesh)
    with tp.use(tp.TPContext(mesh, transport, plan)):
        assert _rwkv_split(cfg) == ("cut", True, True)
        out, _ = rwkv6_apply(layer, cfg, torch.zeros(1, SEQ, cfg.d_model, device="meta"))
    assert tuple(out.shape) == (1, SEQ, cfg.d_model)
    act = 4 * SEQ * cfg.d_model
    assert transport.counts()["model"] == {"send": 0, "all_reduce": 2 * act, "all_gather": 6 * act // 4,
                                           "reduce_scatter": 0}
