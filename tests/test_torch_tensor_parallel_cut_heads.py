"""Tensor parallelism over ``model`` where the plan cuts inside a head (ROADMAP
Queue 1 (a)): the reference's ``_fit_spec`` drops a ``model`` entry only
where it does not divide the dim, so it splits columns that divide while the
heads do not, and GSPMD re-lays the heads out.  ``DataParallelLoss`` with
that plan on ``gloo`` ranks of the CPU, each holding its shards, against
``jax.value_and_grad`` of the reference's ``model.loss`` on the whole batch,
smoke configs in f32 from the port's seed-0 parameters.

Cases: deepseek_v2_lite's MLA on (data, model) = (1, 3), where only ``wq``'s
192 columns divide (its 4 heads, ``w_uk``'s, ``w_uv``'s and ``wo``'s 128 do
not, nor do the experts, the embedding or the head); with 2 heads (the same
``replace`` in both packages) on (1, 4), where ``wq``, ``w_uk``, ``w_uv`` and
``wo`` are all split and the 2 heads are not, beside expert parallelism;
rwkv6 on (1, 4), its 2 heads of 64 cut in half (``u`` whole); and the pure
Mamba2 stack (zamba2 smoke with ``family="ssm"``, d_inner 384 in 3 heads of
128) on (1, 2), d_inner split and the heads not.  Every rank runs all the
heads.  Loss f32 1e-5, gradients 1e-4 relative in norm a leaf,
and the global norm; the transport counts, over ``model`` and ``data``, what
the code owes (``bytes_owed``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.mesh import Mesh
from repro_torch.models.moe import capacity
from repro_torch.models.rwkv import LORA
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, spawn
from torch_tp_helpers import close_in_norm, gathered, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
AXES = ("data", "model")
PURE = {"family": "ssm", "ssm": {"head_dim": 128, "expand": 3}}  # 3 heads of 128 in d_inner 384
CASES = [("deepseek_v2_lite_16b", (1, 3), {}), ("deepseek_v2_lite_16b", (1, 4), {"num_heads": 2, "num_kv_heads": 2}),
         ("rwkv6_7b", (1, 4), {}), ("zamba2_2p7b", (1, 2), PURE)]
IDS = ["deepseek_v2_lite_16b-1x3", "deepseek_v2_lite_16b-1x4-2heads", "rwkv6_7b-1x4", "mamba2_pure-1x2-3heads"]


def cut_case(arch: str, change: dict):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of ``arch``'s
    smoke config in f32 with ``change``'s fields (``ssm``'s a dict of its
    own fields), the same in both packages."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch.models.transformer import build_model

    def changed(smoke, dtype):
        fields = {k: v for k, v in change.items() if k != "ssm"}
        if "ssm" in change:
            fields["ssm"] = dataclasses.replace(smoke.ssm, **change["ssm"])
        return dataclasses.replace(smoke, dtype=dtype, **fields)

    cfg = changed(configs.get_smoke_config(arch), torch.float32)
    ref_cfg = changed(ref_configs.get_smoke_config(arch), jnp.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def mla_layer(cfg, TP: int, tok: int, rows: int, dims: dict) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one deepseek smoke layer,
    f32, remat "none", on the cut route.  The attention: backward, the
    gradient of ``copy_in(x)`` before ``wq`` (act) is summed; forward,
    ``wq``'s output (tok x H (dn + dr) / TP) and the whole ``w_uk`` and
    ``w_uv`` (r x H dn / TP, r x H v / TP) are gathered where split; where
    ``wo`` is split its output is summed forward (act) and the gradient of
    its sliced input gathered backward (tok x H v / TP).  The latent takes
    no ``copy_in``.  The MoE where its experts are split on their expert
    dim, as ``test_torch_tensor_parallel_moe.py`` owes it: the dispatch's
    input gradient summed (act), ``out_buf`` gathered (rows, E / TP, C, d);
    the shared expert's three outputs reduced (tok x sf twice and act) and
    its two sliced inputs' gradients gathered (tok x (d + sf) / TP)."""
    m, e, d, H = cfg.mla, cfg.moe, cfg.d_model, cfg.num_heads
    act = 4 * tok * d
    reduce, gather = act, 4 * tok * H * (m.qk_nope_head_dim + m.qk_rope_head_dim) // TP
    if dims["w_uk"] == 1:
        gather += 4 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim) // TP
    if dims["wo"] == 0:
        reduce, gather = reduce + act, gather + 4 * tok * H * m.v_head_dim // TP
    if dims["moe/w_gate"] == 0:
        sf = e.num_shared_experts * e.expert_d_ff
        reduce += act + 2 * 4 * tok * sf + act
        gather += 4 * rows * e.num_experts // TP * capacity(SEQ, cfg) * d + 4 * tok * (d + sf) // TP
    return reduce, gather


def rwkv_layer(cfg, TP: int, tok: int, rows: int, dims: dict) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one RWKV-6 layer, f32,
    remat "none", on the cut route: forward, ``wo``'s and ``cv``'s outputs
    reduced (2 act) and r, k, v, g, the log-decay and the receptance
    gathered (6 act / TP); backward, the gradients of the time mix's four
    ``copy_in`` inputs, of the LoRA's ``tanh`` (tok x 64) and of ``xk2``
    summed (5 act), and that of ``wo``'s sliced input gathered (act / TP)."""
    act = 4 * tok * cfg.d_model
    return 7 * act + 4 * tok * LORA, 7 * act // TP


def mamba_layer(cfg, TP: int, tok: int, rows: int, dims: dict) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one pure-stack Mamba2
    layer, f32, remat "none", on the cut route: forward, z and the convolved
    x (tok x d_inner / TP each) and ``norm_scale`` (d_inner / TP) gathered
    and ``w_out``'s output reduced (act); backward, the gradient of
    ``copy_in(x)`` summed (act) and that of ``w_out``'s sliced input
    gathered (tok x d_inner / TP).  B, C, dt, A and D are read whole, as
    every rank computes them."""
    act, inner = 4 * tok * cfg.d_model, 4 * tok * cfg.d_model * cfg.ssm.expand
    return 2 * act, 3 * inner // TP + 4 * cfg.d_model * cfg.ssm.expand // TP


def bytes_owed(cfg, shape, plan, shard_elems: int) -> dict:
    """What one ``DataParallelLoss`` call and its ``grad_norm`` put on each
    axis from a rank, in f32, from the code: each layer's (``mla_layer``,
    ``rwkv_layer``, ``mamba_layer``); the embedding gathers its columns where split (act /
    TP); the head, where split, sums the loss's input gradient (act) and the
    cross entropy's sums (2, rows, SEQ) and gathers its maxima (1, rows,
    SEQ); the norm reduces one f32.  ``data`` splits nothing here."""
    DP, TP = shape
    rows = BATCH // DP
    tok = rows * SEQ
    act = 4 * tok * cfg.d_model
    dims = tp.split_dims(plan)
    layer = rwkv_layer if cfg.rwkv else mla_layer if cfg.mla else mamba_layer
    reduce, gather = layer(cfg, TP, tok, rows, dims)
    reduce, gather = cfg.num_layers * reduce + 4, cfg.num_layers * gather
    if dims["embed"] == 1:
        gather += act // TP
    if dims["lm_head"] == 1:
        reduce, gather = reduce + act + 4 * 2 * tok, gather + 4 * tok
    return {"data": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0},
            "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    arch, shape, change = request.param
    cfg, ref_cfg, params = cut_case(arch, change)
    batch = input_batch_for(cfg, BATCH, SEQ)
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path_factory.mktemp(arch), cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return {"cfg": cfg, "shape": shape, "plan": tp.model_plan(cfg, Mesh(shape, AXES)), "ref": ref,
            "results": results}


def test_the_cut_heads_loss_and_gradients_are_the_reference_s(case):
    ref_loss, ref_grads = case["ref"]
    results, plan = case["results"], case["plan"]
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)


def test_the_plan_cuts_inside_a_head(case):
    """The plan splits the head-major columns and not the heads: MLA's ``wq``
    alone at (1, 3) and its four leaves at (1, 4), RWKV-6's time mix with
    ``u`` whole, the pure stack's d_inner; each rank's gradient is its block
    of a split leaf, and the leaves every rank computes whole (MLA's latent
    down-projection, RWKV-6's ``u`` and ``w_lora_a``, the Mamba2 layer's
    ``w_bc``, ``A_log`` and ``D``) have the same bits on every rank."""
    cfg, TP = case["cfg"], case["shape"][1]
    dims = tp.split_dims(case["plan"])
    if cfg.ssm is not None:
        d_in = cfg.d_model * cfg.ssm.expand
        assert (d_in // cfg.ssm.head_dim) % TP and [dims[n] for n in ("w_z", "w_x", "conv_x", "w_out")] == [1, 1, 1, 0]
        leaves = ("layers/mamba/w_bc", "layers/mamba/A_log", "layers/mamba/D", "layers/mamba/conv_bc")
        shapes = {"layers/mamba/w_z": (cfg.num_layers, cfg.d_model, d_in // TP),
                  "layers/mamba/A_log": (cfg.num_layers, d_in // cfg.ssm.head_dim)}
    elif cfg.mla is not None:
        assert cfg.num_heads % TP
        want = [1, None, None, None] if TP == 3 else [1, 1, 1, 0]
        assert [dims[n] for n in ("wq", "w_uk", "w_uv", "wo")] == want and dims["w_dkv"] is None
        m = cfg.mla
        cols = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        leaves, shapes = ("layers/attn/w_dkv",), {"layers/attn/wq": (cfg.num_layers, cfg.d_model, cols // TP)}
    else:
        assert cfg.num_heads % TP and [dims[n] for n in ("wr", "w0", "wo", "u", "w_lora_b")] == [1, 0, 0, None, 1]
        leaves = ("layers/u", "layers/w_lora_a", "layers/mu_w")
        shapes = {"layers/u": (cfg.num_layers, cfg.num_heads, cfg.rwkv.head_dim),
                  "layers/w0": (cfg.num_layers, cfg.d_model // TP)}
    for r in case["results"]:
        g = r["runs"][0]["grads"]
        assert {p: tuple(g[p].shape) for p in shapes} == shapes
        for leaf in leaves:
            assert all(torch.equal(g[leaf], q["runs"][0]["grads"][leaf]) for q in case["results"]), leaf


def test_bytes_each_rank_puts_on_each_axis(case):
    for r in case["results"]:
        elems = sum(g.numel() for g in r["runs"][0]["grads"].values())
        want = bytes_owed(case["cfg"], case["shape"], case["plan"], elems)
        assert r["runs"][0]["bytes"] == want, (r["coords"], r["runs"][0]["bytes"], want)
