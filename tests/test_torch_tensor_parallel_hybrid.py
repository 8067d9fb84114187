"""Tensor parallelism over ``model`` for the Zamba2 hybrid on the plain step
(ROADMAP 7b-iii): ``DataParallelLoss`` with the reference's placement plan on
``gloo`` ranks of the CPU, each holding its shards, against
``jax.value_and_grad`` of the reference's ``model.loss`` on the whole batch,
zamba2 smoke in f32 from the port's seed-0 parameters.

The plan is the reference's, not its docstring's head split: the hybrid's
Mamba2 leaves carry two stacked axes (G, M), the plan adds one leading
``None`` (ROADMAP Queue 3 (p)), so ``w_z`` and ``w_x`` split on d, their
contracting dim, ``conv_x`` on its taps (4 taps, 2 a rank), and ``w_out``
and ``norm_scale``, whose ``model`` entry lands on M = 1, stay whole with the
rest of the layer; the shared block splits as the dense family's.  Cases:
(data, model) = (1, 2) and (2, 2), and (1, 2) with remat "full".  Loss f32
1e-5, gradients 1e-4 relative in norm a leaf, and the global norm; the
transport's bytes as the code owes them (``bytes_owed``).  Beside them, on
no ranks: ``split_dims`` of the (G, M) leaves, the plan where it puts
``model`` on M (``stacked_dims``), and the pure Mamba2 stack's plan, by heads."""
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
WHOLE = ("w_bc", "w_dt", "conv_bc", "A_log", "D", "dt_bias", "w_out", "norm_scale", "ln")


def hybrid_case(remat: str = "none"):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of zamba2
    smoke in f32 under ``remat``."""
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
    d), ``inner`` its (rows, SEQ, d_inner).

    ``model``, a Mamba2 layer: forward, ``w_z``'s and ``w_x``'s partial
    outputs and the convolution's partial sums are reduced (3 inner);
    backward, the convolution's input gradient is summed (inner) and the
    gradient of the sliced x gathered (act / TP).  The shared block, once a
    group: the attention's and the FFN's outputs reduced forward and their
    inputs' gradients backward (4 act).  Under remat "full" the
    recomputation repeats a group's forward reductions, all of them: the
    group ends in the FFN's sum times the gate, whose product keeps both.
    Then the embedding gathers its columns (act / TP); the head sums the
    loss's input gradient (act) and the cross entropy's sums (2, rows, SEQ)
    and gathers its maxima (1, rows, SEQ); the norm reduces one f32.

    ``data``: the mask count, the gradients of the rank's shards and the
    loss, where ``data`` splits the batch."""
    DP, TP = shape
    tok = BATCH // DP * SEQ
    act, inner = 4 * tok * cfg.d_model, 4 * tok * cfg.d_model * cfg.ssm.expand
    G, M = cfg.num_layers // cfg.attn_period, cfg.attn_period - 1
    k = 2 if cfg.remat == "full" else 1
    group_reduce = M * (3 * k + 1) * inner + (2 * k + 2) * act
    reduce = G * group_reduce + act + 4 * 2 * tok + 4
    gather = G * M * act // TP + act // TP + 4 * tok
    data = 4 * shard_elems + 8 if DP > 1 else 0
    return {"data": {"send": 0, "all_reduce": data, "all_gather": 0, "reduce_scatter": 0},
            "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    shape, remat = request.param
    cfg, ref_cfg, params = hybrid_case(remat)
    assert tp.tp_family(cfg)
    batch = input_batch_for(cfg, BATCH, SEQ)
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path_factory.mktemp("hybrid"), cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return {"cfg": cfg, "shape": shape, "plan": tp.model_plan(cfg, Mesh(shape, AXES)), "ref": ref,
            "results": results}


def test_the_tp_hybrid_loss_and_gradients_are_the_reference_s(case):
    ref_loss, ref_grads = case["ref"]
    results, plan = case["results"], case["plan"]
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)


def test_the_mamba_layers_split_where_the_plan_puts_them(case):
    """Each rank's gradients: its rows (of d) of ``w_z`` and ``w_x``, its two
    of the four taps of ``conv_x``, the shared block's heads; the rest of the
    Mamba2 layer whole, the same bits on every ``model`` rank of a ``data``
    rank."""
    cfg, TP = case["cfg"], case["shape"][1]
    dims = tp.split_dims(case["plan"])
    assert (dims["w_z"], dims["w_x"], dims["conv_x"]) == (0, 0, 0)
    assert all(dims[n] is None for n in WHOLE) and (dims["wq"], dims["wo"]) == (1, 0)
    G, M, d, W = cfg.num_layers // cfg.attn_period, cfg.attn_period - 1, cfg.d_model, cfg.ssm.conv_width
    d_in = d * cfg.ssm.expand
    for r in case["results"]:
        g = r["runs"][0]["grads"]
        assert tuple(g["groups/mamba/mamba/w_z"].shape) == (G, M, d // TP, d_in)
        assert tuple(g["groups/mamba/mamba/conv_x"].shape) == (G, M, W // TP, d_in)
        assert tuple(g["groups/mamba/mamba/w_out"].shape) == (G, M, d_in, d)
        peer = next(q for q in case["results"] if q["coords"]["data"] == r["coords"]["data"]
                    and q["coords"]["model"] != r["coords"]["model"])
        for leaf in [f"groups/mamba/mamba/{n}" for n in WHOLE[:-1]] + ["groups/mamba/ln", "groups/gate"]:
            assert torch.equal(g[leaf], peer["runs"][0]["grads"][leaf]), leaf


def test_bytes_each_rank_puts_on_each_axis(case):
    for r in case["results"]:
        elems = sum(g.numel() for g in r["runs"][0]["grads"].values())
        want = bytes_owed(case["cfg"], case["shape"], elems)
        assert r["runs"][0]["bytes"] == want, (r["coords"], r["runs"][0]["bytes"], want)


def test_no_context_and_one_rank_change_nothing():
    """With a context of one ``model`` rank (a plan made for two) the hybrid
    computes the loss and gradients of no context, bit for bit."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.transport import Transport

    cfg, _, params = hybrid_case()
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


@pytest.mark.parametrize("model,conv_x", [(2, 0), (16, None)])
def test_split_dims_strip_both_stacked_axes_of_the_mamba_leaves(model, conv_x):
    """Zamba2-2.7B's (9, 5, ...) Mamba2 leaves: stripped of G and M, ``w_z``
    and ``w_x`` split on dim 0 (d), ``conv_x`` on its taps where ``model``
    divides 4; the leaves whose ``model`` entry lands on M = 5 whole."""
    cfg = configs.get_config(ARCH)
    plan = tp.model_plan(cfg, Mesh((1, model), AXES))
    assert tp.lead_axes("groups/mamba/mamba/w_z") == tp.lead_axes("groups/mamba/ln") == 2
    assert tp.lead_axes("groups/gate") == tp.lead_axes("layers/wq") == 1 and tp.lead_axes("shared_attn/attn/wq") == 0
    dims = tp.split_dims(plan)
    assert (dims["w_z"], dims["w_x"], dims["conv_x"]) == (0, 0, conv_x)
    assert all(dims[n] is None for n in WHOLE) and dims["gate"] is None
    assert (dims["wq"], dims["wk"], dims["wv"], dims["wo"], dims["w_gate"], dims["w_down"]) == (1, 1, 1, 0, 1, 0)


def test_the_plan_on_an_even_number_of_mamba_layers_a_group_raises():
    """Once a refusal, now the plan that runs (7b-vi): with attn_period 3 (M
    = 2 Mamba2 layers a group) the plan puts ``model`` on M for ``w_out`` and
    ``norm_scale``, a stacked axis; ``model_plan`` gives it, ``split_dims``
    keys those leaves as whole a layer and ``stacked_dims`` on M, which each
    group gathers (``tensor_parallel.gather_stacked``; the parity is
    ``test_torch_tensor_parallel_hybrid_m.py``'s and
    ``test_torch_pipeline_tp_hybrid_m.py``'s)."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), num_layers=6, attn_period=3)
    plan = tp.model_plan(cfg, Mesh((1, 2), AXES))
    from repro_torch.convert import flatten

    specs = flatten(plan)
    assert tuple(specs["groups/mamba/mamba/w_out"]) == (None, "model", None, None)
    assert tuple(specs["groups/mamba/mamba/norm_scale"]) == (None, "model", None)
    dims = tp.split_dims(plan)
    assert dims["w_out"] is None and dims["norm_scale"] is None and (dims["w_z"], dims["w_x"]) == (0, 0)
    assert tp.stacked_dims(plan) == {"w_out": 1, "norm_scale": 1}


def test_the_pure_mamba2_stack_keeps_replicas_and_says_so():
    """The pure stack (``family="ssm"``, one stacked axis) kept whole
    replicas on its ``model`` ranks and the launcher said so; it is now in
    ``tp_family`` with RWKV-6 and the hybrid, and splits by heads: on (2, 2)
    its plan puts ``w_z``, ``w_x`` and ``conv_x`` on d_inner and ``w_out``
    and ``norm_scale`` on their rows, each rank 4 of the smoke's 8 heads,
    and leaves the rest of the layer whole.  No family keeps replicas, so
    the launcher's note is gone (``test_torch_tensor_parallel_mamba.py``
    runs the split against the reference)."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import shard_params

    pure = dataclasses.replace(configs.get_smoke_config(ARCH), family="ssm")
    mesh = Mesh((2, 2), AXES)
    plan = tp.model_plan(pure, mesh)
    assert tp.tp_family(pure) and plan is not None and not hasattr(tp, "replicated_note")
    dims = tp.split_dims(plan)
    assert (dims["w_z"], dims["w_x"], dims["conv_x"], dims["w_out"], dims["norm_scale"]) == (1, 1, 1, 0, 0)
    assert all(dims[n] is None for n in WHOLE[:-3] + ("ln",))
    gen = torch.Generator()
    gen.manual_seed(0)
    d_in = pure.d_model * pure.ssm.expand
    m = shard_params(build_model(pure).init(gen), Mesh((2, 2), AXES, 1), plan)["layers"]["mamba"]
    assert tuple(m["w_z"].shape[1:]) == (pure.d_model, d_in // 2) and tuple(m["w_out"].shape[1:]) == (d_in // 2,
                                                                                                        pure.d_model)
    assert tuple(m["A_log"].shape[1:]) == (d_in // pure.ssm.head_dim,)
    for arch in (ARCH, "rwkv6_7b"):
        assert tp.tp_family(configs.get_config(arch)) and tp.model_plan(configs.get_config(arch), mesh) is not None
