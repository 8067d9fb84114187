"""The MoE layer's backward adds no two contributions into one element by
an accumulating scatter, so that on the card, where such a scatter adds with
float atomics in any order, two identical calls give the same bits.

The dispatch took each (token, k) assignment's row with a gather of ``x`` by
token index: each token's row taken K times, so the gather's backward
scatter-added K gradients into each token's row.  On an H100 that made two
identical pipelined DeepSeek-V2-Lite calls differ by up to 3.5e-3 of a leaf's
largest gradient (bf16 atomics), where the reference's are deterministic
(ROADMAP Queue 3 (q)).  The rows now come from a token-major copy of ``x``
taken by the permutation ``order``, and a token's K gradients are summed by
the copy's backward.  The CPU adds in a fixed order, so the test reads every
accumulating scatter of the backward (``TorchDispatchMode``) and counts the
elements that receive more than one nonzero contribution."""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.transformer import build_model
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread)

aten = torch.ops.aten


def _targets(shape, dim, index) -> torch.Tensor:
    """The flat position in a tensor of ``shape`` that each element of a
    scatter's ``index`` along ``dim`` adds into."""
    coords = list(torch.meshgrid(*[torch.arange(n) for n in index.shape], indexing="ij"))
    coords[dim] = index
    flat = torch.zeros(index.shape, dtype=torch.int64)
    for c, n in zip(coords, shape):
        flat = flat * n + c
    return flat


class Collisions(TorchDispatchMode):
    """Counts, over every accumulating scatter it sees, the elements of the
    result that receive two or more nonzero contributions."""

    def __init__(self):
        super().__init__()
        self.count, self.ops = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (aten.scatter_add.default, aten.scatter_add_.default):
            out, dim, index, src = args[:4]
            nonzero = (src != 0)[tuple(slice(0, n) for n in index.shape)]
            hit = torch.bincount(_targets(out.shape, dim, index)[nonzero], minlength=out.numel())
            self.count += int((hit > 1).sum())
            self.ops.append(str(func))
        elif func in (aten.index_add.default, aten.index_add_.default):
            out, dim, index, src = args[:4]
            nonzero = (src != 0).movedim(dim, 0).reshape(index.numel(), -1).any(1)
            hit = torch.bincount(index[nonzero], minlength=out.shape[dim])
            self.count += int((hit > 1).sum())
            self.ops.append(str(func))
        elif func in (aten.index_put.default, aten.index_put_.default) and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            raise AssertionError("an accumulating index_put in the MoE layer's backward: check it for collisions")
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen2_moe_a2p7b"])
def test_no_element_of_the_backward_takes_two_contributions(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items() if isinstance(v, torch.Tensor)}
    layer["shared"] = {k: v[0] for k, v in params["layers"]["moe"].get("shared", {}).items()}
    if not layer["shared"]:
        del layer["shared"]
    x = torch.randn(2, 64, cfg.d_model, generator=gen).to(dtype).requires_grad_(True)
    y, aux = moe.moe_apply(layer, cfg, x)
    dy = torch.randn(y.shape, generator=gen).to(dtype)
    seen = Collisions()
    with seen:
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])
    assert seen.ops, "the backward ran no accumulating scatter: the check saw nothing"
    assert seen.count == 0, f"{seen.count} elements took two or more contributions ({seen.ops})"
    assert torch.isfinite(x.grad).all()

