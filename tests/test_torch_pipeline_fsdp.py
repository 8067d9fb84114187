"""FSDP over ``data`` inside the pipeline's stages (ROADMAP 7f-ii): gpt_a on
a (pod, data, model) = (2, 2, 1) mesh of ``gloo`` CPU ranks, each holding its
``data`` blocks of its stage under the plan with fsdp on, gathered once a step
before the first microbatch and reduce-scattered once after the last
(``torch_pipeline_fsdp_helpers``).

  * gpt_a smoke at a threshold of 0 (every leaf with a dim that ``data``
    divides split) and at the reference's 4 MiB (which splits none of the
    smoke's leaves: the call is the control's program);
  * gpt_a widened to d_model 512 and d_ff 2048 at the reference's 4 MiB,
    which splits the FFN's two matrices over ``data``.

For both boundaries the loss and every gradient, put together over ``data``
and ``pod``, against ``jax.value_and_grad`` of the reference's microbatch mean
at 2e-5, and ``grad_norm`` the whole gradient's; bit-equal to the call
without FSDP on the same mesh; the ``data`` bytes as the code owes them, the
same at n_micro 2 and 4; two trained steps within 1e-5 of the control's.
``gather_train_state`` of the trained FSDP state (threshold 0) is the state
put together from the ranks' blocks."""
import pytest

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.pipeline import stage_params
from repro_torch.parallel.sharding import FSDP_MIN_BYTES, shard_params
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import (AXES, hold_bit_equal, hold_bytes, hold_reference, hold_train, run, smoke,
                                         split_over_data)

SHAPE = (2, 2, 1)
CASES = [("gpt_a", 0), ("gpt_a", FSDP_MIN_BYTES), ("gpt_a_wide", FSDP_MIN_BYTES)]
IDS = ["smoke-threshold0", "smoke-4MiB", "wide-4MiB"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run(tmp_path_factory, SHAPE, {"gpt_a": (*smoke("gpt_a"), (0, FSDP_MIN_BYTES)),
                                         "gpt_a_wide": (*smoke("gpt_a", {"d_model": 512, "d_ff": 2048}),
                                                        (FSDP_MIN_BYTES,))}, train_steps=2, gather=True)


@pytest.mark.parametrize("boundary", ["direct", "striped"])
@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_loss_and_gradients_match_the_reference(world, name, min_bytes, boundary):
    hold_reference(world[name], min_bytes, boundary)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_bit_equal_to_the_call_without_fsdp(world, name, min_bytes):
    hold_bit_equal(world[name], min_bytes)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_data_bytes_are_the_code_s_once_a_step(world, name, min_bytes):
    hold_bytes(world[name], min_bytes)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_two_steps_are_the_control_s(world, name, min_bytes):
    hold_train(world[name], min_bytes)


def test_which_leaves_the_plans_split(world):
    assert split_over_data(world["gpt_a"], FSDP_MIN_BYTES) == []
    assert split_over_data(world["gpt_a_wide"], FSDP_MIN_BYTES) == ["layers/ffn/w_down", "layers/ffn/w_up"]
    every = split_over_data(world["gpt_a"], 0)  # every matrix; the norms keep an empty rule, so stay whole
    assert every == sorted(["embed", "lm_head", "layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
                            "layers/attn/wo", "layers/ffn/w_up", "layers/ffn/w_down"])


def test_gather_train_state_refuses_an_fsdp_state(world):
    """Once a refusal, now the gather (Queue 1 (d)): after the two trained
    steps at a threshold of 0, ``gather_train_state`` on every rank gives
    rank 0 the whole state, each stage put together over ``data`` and the
    stages in layer order: bit for bit the ranks' blocks of parameters and
    both moments put together here, and cut by the plan again every rank's
    own blocks; the other ranks get None."""
    from repro_torch.convert import flatten
    from torch_pipeline_fsdp_helpers import _plans, assembled

    case = world["gpt_a"]
    fplan = _plans(case, 0)[1]
    ranks = case["results"]
    state = ranks[0]["fsdp"][0]["gathered"]
    assert all(r["fsdp"][0]["gathered"] is None for r in ranks[1:])
    whole = {"params": flatten(state["params"]), "mu": flatten(state["opt"].mu), "nu": flatten(state["opt"].nu)}
    for part, tree in whole.items():
        want = assembled(case, fplan, lambda r: r["fsdp"][0]["train"][part])
        assert tree.keys() == want.keys() and all(torch.equal(tree[p], want[p]) for p in want), part
    for r in ranks:
        mesh = Mesh(SHAPE, AXES, Mesh(SHAPE, AXES).rank_at(**r["coords"]))
        for part, tree in (("params", state["params"]), ("mu", state["opt"].mu), ("nu", state["opt"].nu)):
            cut = flatten(shard_params(stage_params(tree, case["cfg"], mesh), mesh, fplan))
            got = r["fsdp"][0]["train"][part]
            assert all(torch.equal(cut[p], got[p]) for p in got), (r["coords"], part)
