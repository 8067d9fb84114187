"""Helpers of the tests of tensor parallelism inside the pipeline's stages
(``tests/test_torch_pipeline_tp*.py``, ROADMAP 7b-iv): one spawned run of a
smoke config on a (pod, data, model) mesh with both boundaries
(``torch_pipeline_helpers.pipeline_case`` with ``tensor_parallel``), and the
checks each file makes of it: the loss and every gradient against the
reference's microbatch mean, ``striped`` against ``direct`` bit for bit, the
shapes each rank holds against the reference's ``shard_shape`` of its stage's
rows, and the bytes of a call against ``bytes_owed``, written from the code.
This module imports no JAX at its top; its checks import the reference."""
from __future__ import annotations

import numpy as np

from torch_pipeline_helpers import AXES, hold_against_reference, hold_boundaries_equal, pipeline_case

REF_TOL = 2e-5  # the pipelined f32 tests' bound against the reference (test_torch_pipeline_dense.py)
N_MICRO, BATCH, SEQ = 4, 8, 32


def run(tmp_path_factory, arch: str, shape, train_steps: int = 0, experts=None, **replace) -> dict:
    """``pipeline_case`` of ``arch`` (with ``experts`` routed experts where
    given, and ``replace``'s fields) on ``shape``, tensor-parallel, both
    boundaries, with the plan of the mesh."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan

    case = pipeline_case(tmp_path_factory.mktemp(f"tp_{arch}"), arch, shape, ("direct", "striped"), n_micro=N_MICRO,
                         batch=BATCH, seq=SEQ, train_steps=train_steps, tensor_parallel=True, experts=experts,
                         **replace)
    case["plan"] = model_plan(case["cfg"], Mesh(shape, AXES))
    case["shape"] = tuple(shape)
    assert case["plan"] is not None
    return case


def hold_parity(case, boundary: str) -> None:
    hold_against_reference(case["results"], case["ref"], "layers", boundary, REF_TOL, cfg=case["cfg"],
                           plan=case["plan"])


def hold_boundaries(case) -> None:
    """``striped`` bit-equal to ``direct``, with 1/TP of its ``pod`` sends."""
    hold_boundaries_equal(case["results"])
    TP = case["shape"][2]
    for r in case["results"]:
        d, s = r["runs"]["direct"]["bytes"]["pod"]["send"], r["runs"]["striped"]["bytes"]["pod"]["send"]
        assert d == TP * s > 0


def hold_shard_shapes(case, arch: str) -> None:
    """Each rank's leaves have the reference's ``shard_shape`` on an
    ``AbstractMesh`` of the same shape, of each leaf with its stack (the
    layers, or the hybrid's groups) cut to the rank's stage rows."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro import configs as ref_configs
    from repro.models.transformer import build_model as ref_build_model
    from repro.parallel import sharding as ref_sharding
    from repro_torch.models.transformer import build_pipeline_parts
    from repro_torch.parallel.pipeline import stack_length, stage_layer_range
    from torch_pipeline_helpers import _jax_flat

    cfg, shape = case["cfg"], case["shape"]
    ref_shapes = jax.eval_shape(ref_build_model(case.get("ref_cfg") or ref_configs.get_smoke_config(arch)).init,
                                jax.random.PRNGKey(0))
    amesh = AbstractMesh(shape, AXES)
    specs = _jax_flat(ref_sharding.make_param_shardings(ref_shapes, amesh))
    whole = {p: tuple(v.shape) for p, v in _jax_flat(ref_shapes).items()}
    key, L = build_pipeline_parts(cfg).layer_key + "/", stack_length(cfg)
    for r in case["results"]:
        lo, hi = (min(i, L) for i in stage_layer_range(L, shape[0], r["coords"]["pod"]))
        stage = {p: ((hi - lo,) + w[1:] if p.startswith(key) else w) for p, w in whole.items()}
        assert set(r["shapes"]) == set(specs)
        for p, got in r["shapes"].items():
            assert got == tuple(NamedSharding(amesh, specs[p].spec).shard_shape(stage[p])), (r["coords"], p, got)
        assert sum(np.prod(s) for s in r["shapes"].values()) < sum(np.prod(s) for s in stage.values())


def dense_row(cfg, TP: int, tok: int) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one transformer layer and
    one microbatch of ``tok`` tokens a rank, f32, remat "none": the
    attention's and the FFN's outputs reduced forward and their inputs'
    gradients backward (4 act); where the heads do not line up with the
    ranks (Granite's one kv head) the attention gathers q, k and v forward
    and ``wo``'s input's gradient backward instead of attending on its own
    heads."""
    hd, H, Hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    local = H % TP == 0 and Hkv % TP == 0
    return 4 * 4 * tok * cfg.d_model, 0 if local else 4 * tok * (2 * H * hd + 2 * Hkv * hd) // TP


def bytes_owed(cfg, shape, stage: int, boundary: str, block_elems: dict, row=dense_row) -> dict:
    """What one call of the pipelined loss and ``grad_norm`` puts on each
    axis from a rank of ``stage``, in f32, for a config with remat "none"
    (no recomputation), from the code.  A microbatch's activation ``act`` is
    (rows, SEQ, d), rows = BATCH / (N_MICRO DP).

    ``pod``: a boundary sends N_MICRO activations forward from stage 0 and
    as many gradients back from stage 1, ``striped`` 1/TP of each; the
    gradients of ``rest`` (its blocks), the loss and the layers' squared
    norm are all-reduced.  ``data``: the layer and ``rest`` blocks' gradients
    and the loss.  ``model``, a microbatch: each row of the stack (a layer,
    or the hybrid's group) what ``row`` says (``dense_row`` for a
    transformer layer); stage 0 gathers the embedding's columns; the last
    stage reduces the loss's input gradient (act) and the
    vocabulary-parallel cross entropy's sums (2, rows, SEQ) and gathers its
    maxima (1, rows, SEQ); ``striped`` gathers what the rank receives (act /
    TP).  The norm reduces the split leaves' squares (2 f32) over
    ``model``."""
    from repro_torch.parallel.pipeline import stack_length

    S, DP, TP = shape
    rows = BATCH // (N_MICRO * DP)
    tok = rows * SEQ
    act = 4 * tok * cfg.d_model
    per = stack_length(cfg) // S
    row_reduce, row_gather = row(cfg, TP, tok)
    last = stage == S - 1
    gather = per * row_gather
    gather += act // TP if stage == 0 else 4 * tok  # the embedding's columns, the maxima
    gather += act // TP if boundary == "striped" else 0
    reduce = per * row_reduce + (act + 4 * 2 * tok if last else 0)
    sends = N_MICRO * act // (TP if boundary == "striped" else 1)
    out = {"pod": {"send": sends, "all_reduce": 4 * block_elems["rest"] + 8, "all_gather": 0, "reduce_scatter": 0},
           "model": {"send": 0, "all_reduce": N_MICRO * reduce + 8, "all_gather": N_MICRO * gather,
                     "reduce_scatter": 0}}
    out["data"] = {"send": 0, "all_reduce": 4 * (block_elems["layers"] + block_elems["rest"]) + 4 if DP > 1 else 0,
                   "all_gather": 0, "reduce_scatter": 0}
    return out


def hold_bytes(case, row=dense_row) -> None:
    from repro_torch.models.transformer import build_pipeline_parts

    key = build_pipeline_parts(case["cfg"]).layer_key + "/"
    for r in case["results"]:
        shapes = r["shapes"]
        elems = {"layers": sum(int(np.prod(s)) for p, s in shapes.items() if p.startswith(key)),
                 "rest": sum(int(np.prod(s)) for p, s in shapes.items() if not p.startswith(key))}
        for boundary in ("direct", "striped"):
            want = bytes_owed(case["cfg"], case["shape"], r["coords"]["pod"], boundary, elems, row)
            assert r["runs"][boundary]["bytes"] == want, (r["coords"], boundary, r["runs"][boundary]["bytes"], want)
