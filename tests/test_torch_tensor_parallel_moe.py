"""Tensor parallelism over ``model`` for the MoE and MLA families on the plain
step (ROADMAP 7b-ii): ``DataParallelLoss`` with the reference's placement plan
on ``gloo`` ranks of the CPU, each holding its shards, against
``jax.value_and_grad`` of the reference's ``model.loss`` on the whole batch,
the smoke configs in f32 from the port's seed-0 parameters.

Cases: deepseek_v2_lite_16b at (data, model) = (1, 2) and (2, 2), its 4
experts split on the expert dim (expert parallelism), MLA at 2 of its 4 heads a
rank, and under (2, 2) the aux's whole-batch means over ``data``;
qwen2_moe_a2p7b at (1, 2), expert parallelism beside GQA; and qwen2_moe_a2p7b
with 3 experts (the same ``replace`` in both packages) at (1, 2), which
``MOE_RULES`` split on the features instead (3 experts do not divide 2, 128
features do).  Loss f32 1e-5, gradients 1e-4 relative in norm a leaf, the
bounds of the port's ``Model.loss`` against the reference's, and the global
norm.  The transport counts, over ``model`` and ``data``, what the code owes
(``bytes_owed``): the ``out_buf`` gather under expert parallelism, its
reduction under the feature split."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.mesh import Mesh
from repro_torch.models.moe import capacity
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, spawn
from torch_tp_helpers import close_in_norm, gathered, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
AXES = ("data", "model")
CASES = [("deepseek_v2_lite_16b", (1, 2), None), ("deepseek_v2_lite_16b", (2, 2), None),
         ("qwen2_moe_a2p7b", (1, 2), None), ("qwen2_moe_a2p7b", (1, 2), 3)]
IDS = [f"{a}-{'x'.join(map(str, m))}{f'-{e}experts' if e else ''}" for a, m, e in CASES]


def moe_case(arch: str, experts=None):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of ``arch``'s
    smoke config in f32, with ``experts`` routed experts where given."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, num_experts=experts))
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def bytes_owed(cfg, shape, shard_elems: int) -> dict:
    """What one ``DataParallelLoss`` call and its ``grad_norm`` put on each
    axis from a rank, in f32, for a smoke config (remat "none": nothing is
    recomputed), from the code.  ``act`` is a rank's (rows, SEQ, d).

    ``model``, a layer: the attention reduces ``wo``'s output forward and
    its input's gradient backward (``copy_in`` of x), and MLA its latent's
    gradient (rows, SEQ, r + rope) too; the routed experts sum the
    dispatch's input gradient (act) backward and, under expert parallelism,
    gather ``out_buf`` (rows, E / TP, C, d) forward, under the feature split
    reduce it, (rows, E, C, d); the shared expert reduces its three outputs
    forward, (rows, SEQ, sf) twice and act, and gathers the gradients of its
    two sliced inputs backward, (rows, SEQ, d / TP) and (rows, SEQ, sf / TP).
    Then the embedding gathers its columns (act / TP); the head sums the
    loss's input gradient (act) and the cross entropy's sums (2, rows, SEQ)
    and gathers its maxima (1, rows, SEQ); the norm reduces one f32.

    ``data``: the mask count, the gradients of the rank's shards and the
    loss, and a layer's aux means (2, E), where ``data`` splits the batch."""
    DP, TP = shape
    rows = BATCH // DP
    tok = rows * SEQ
    d, m, E = cfg.d_model, cfg.moe, cfg.moe.num_experts
    act = 4 * tok * d
    sf = m.num_shared_experts * m.expert_d_ff
    C = capacity(SEQ, cfg)
    ep = E % TP == 0
    attn = 2 * act + (4 * tok * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) if cfg.mla else 0)
    routed = act + (0 if ep else 4 * rows * E * C * d)
    shared = 2 * 4 * tok * sf + act
    reduce = cfg.num_layers * (attn + routed + shared) + act + 4 * 2 * tok + 4
    gather = cfg.num_layers * ((4 * rows * E // TP * C * d if ep else 0) + 4 * tok * (d + sf) // TP)
    gather += act // TP + 4 * tok
    data = 4 * shard_elems + 8 + cfg.num_layers * 2 * E * 4 if DP > 1 else 0
    return {"data": {"send": 0, "all_reduce": data, "all_gather": 0, "reduce_scatter": 0},
            "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    arch, shape, experts = request.param
    cfg, ref_cfg, params = moe_case(arch, experts)
    assert cfg.remat == "none" and tp.tp_family(cfg)
    batch = input_batch_for(cfg, BATCH, SEQ)
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path_factory.mktemp(arch), cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return {"cfg": cfg, "shape": shape, "plan": tp.model_plan(cfg, Mesh(shape, AXES)), "ref": ref,
            "results": results}


def test_the_tp_moe_loss_and_gradients_are_the_reference_s(case):
    ref_loss, ref_grads = case["ref"]
    results, plan = case["results"], case["plan"]
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)


def test_the_experts_split_as_moe_rules_place_them(case):
    cfg, plan = case["cfg"], case["plan"]
    dims = tp.split_dims(plan)
    routed = [dims[f"moe/{n}"] for n in ("w_gate", "w_up", "w_down")]
    assert routed == ([0, 0, 0] if cfg.moe.num_experts % case["shape"][1] == 0 else [2, 2, 1])
    assert [dims[f"moe/shared/{n}"] for n in ("w_gate", "w_up", "w_down")] == [0, 0, 0]
    assert dims["moe/router"] is None
    L, E, d, f, TP = cfg.num_layers, cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff, case["shape"][1]
    want = (L, E // TP, d, f) if routed[0] == 0 else (L, E, d, f // TP)
    for r in case["results"]:  # each rank's gradient is its block of the routed experts
        assert tuple(r["runs"][0]["grads"]["layers/moe/w_gate"].shape) == want
    if cfg.mla is not None:
        assert [dims[n] for n in ("wq", "w_uk", "w_uv", "wo", "w_dkv")] == [1, 1, 1, 0, None]


def test_bytes_each_rank_puts_on_each_axis(case):
    for r in case["results"]:
        elems = sum(g.numel() for g in r["runs"][0]["grads"].values())
        want = bytes_owed(case["cfg"], case["shape"], elems)
        assert r["runs"][0]["bytes"] == want, (r["coords"], r["runs"][0]["bytes"], want)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen2_moe_a2p7b"])
def test_no_context_and_one_rank_change_nothing(arch):
    """With a context of one ``model`` rank (a plan made for two) the MoE and
    MLA paths compute the loss and gradients of no context, bit for bit."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.transport import Transport

    cfg, _, params = moe_case(arch)
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


def test_mla_raises_where_its_heads_do_not_divide_model():
    """deepseek smoke's 4 heads on a ``model`` axis of 16: the plan splits
    ``wq``'s 192, ``w_uk``'s and ``w_uv``'s 128 columns and ``wo``'s 128
    rows, inside a head.  Once refused, the cut route now runs it: each
    rank holds its 12 columns of ``wq`` (a quarter of a head), 8 of ``w_uk``
    and ``w_uv``, 8 rows of ``wo`` and the whole ``w_dkv``; rank 0's layer on
    ``meta`` over a ``MetaTransport`` gathers ``wq``'s output, ``w_uk`` and
    ``w_uv``, attends with all 4 heads, and sums ``wo``'s output.  The
    spawned runs against the reference are
    ``test_torch_tensor_parallel_cut_heads.py``'s."""
    from repro_torch.models.attention import _mla_split, mla_apply
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.transport import MetaTransport

    cfg, _, params = moe_case("deepseek_v2_lite_16b")
    m = cfg.mla
    TP = 16
    plan = tp.model_plan(cfg, Mesh((1, TP), AXES))
    assert tp.split_dims(plan)["wq"] == 1 and cfg.num_heads % TP
    want = {"wq": (cfg.d_model, 192 // TP), "w_dkv": (cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim),
            "w_uk": (m.kv_lora_rank, 128 // TP), "w_uv": (m.kv_lora_rank, 128 // TP), "wo": (128 // TP, cfg.d_model)}
    for rank in range(TP):
        attn = shard_params(params, Mesh((1, TP), AXES, rank), plan)["layers"]["attn"]
        assert {k: tuple(v.shape[1:]) for k, v in attn.items()} == want
    mesh = Mesh((1, TP), AXES, 0)
    layer = {k: v[0].to("meta") for k, v in shard_params(params, mesh, plan)["layers"]["attn"].items()}
    transport = MetaTransport(mesh)
    with tp.use(tp.TPContext(mesh, transport, plan)):
        assert _mla_split(cfg) == ({"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0}, False)
        out, _ = mla_apply(layer, cfg, torch.zeros(1, SEQ, cfg.d_model, device="meta"),
                           torch.arange(SEQ, device="meta")[None])
    assert tuple(out.shape) == (1, SEQ, cfg.d_model)
    assert transport.counts()["model"] == {"send": 0, "all_reduce": 4 * SEQ * cfg.d_model,
                                           "all_gather": 4 * (SEQ * 192 + 2 * m.kv_lora_rank * 128) // TP,
                                           "reduce_scatter": 0}
