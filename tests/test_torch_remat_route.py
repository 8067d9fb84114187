"""A rematerialised block recomputes in the backward under the attention impl
its forward ran under.  Qwen2-VL's batches of ``embeds`` with their own (3, B,
T) positions run pinned to the masked plain ``sdpa`` (``_inputs_to_embeds``),
a pin that ends with the loss, before its backward: recomputed under the
default impl, the block took another path (the flash attention's plain
version, with no position mask), and ``torch.utils.checkpoint`` refused the
different saved tensors (the config's own remat="full" could not train such a
batch).  Every remat policy now gives the gradients of "none" bit for bit."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.models import attention
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import accumulated_value_and_grad
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread)


def _grads(remat: str):
    cfg = dataclasses.replace(get_smoke_config("qwen2_vl_7b"), dtype=torch.float32, remat=remat)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    batch = next(make_batches(cfg, DataConfig(seed=0, batch_size=2, seq_len=16)))
    assert batch["positions"].shape == (3, 2, 16)
    attention.sdpa_masked_calls = 0
    loss, _, grads = accumulated_value_and_grad(build_model(cfg).loss, params,
                                                {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, grads, attention.sdpa_masked_calls


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_recomputation_keeps_the_batch_s_attention_route(remat):
    loss0, grads0, calls0 = _grads("none")
    loss, grads, calls = _grads(remat)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, grads0[k]) for k, g in grads.items())
    layers = get_smoke_config("qwen2_vl_7b").num_layers
    assert calls0 == layers and calls == 2 * layers  # the masked path again in every recomputation
