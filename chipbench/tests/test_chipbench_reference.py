"""The plain references against the program's CPU path at small sizes, in
float32: a train step with accumulation and AdamW for both families, and a
ragged ``SplitwiseCluster.serve``.  Run from the root of the checkout:
``python3 -m pytest -q chipbench/tests``."""
import pytest

import chipbench_cpu as cpu


@pytest.mark.parametrize("cell", ["gpta-stage-train", "rwkv6-stage-train"])
def test_train_step_matches_the_reference(cell):
    checks = cpu.drive(cpu.small_cell(cell, limits={}))["checks"]  # every number, compared or not
    assert checks["loss_1"]["value"] < 1e-5 and checks["loss_2"]["value"] < 1e-5
    assert checks["grad_norm"]["value"] < 1e-4
    assert checks["grad_leaf"]["value"] < 1e-4
    assert checks["grad_diff"]["value"] < 1e-4
    assert checks["change_leaf"]["value"] < 1e-4


def test_ragged_serve_matches_the_reference():
    result = cpu.drive(cpu.small_cell("gpta-prefill-ragged", limits={}))
    run = result.pop("_run")
    assert result["failed"] == 0 and run["pad_slots"] > 0  # the batches were ragged
    assert result["attempted"] % cpu.PREFILL["lengths"]["cycle"] == 0  # whole cycles of lengths
    assert result["checks"]["served_gap"]["value"] < 1e-4
    assert result["checks"]["cache_gap"]["value"] < 1e-5


@pytest.mark.parametrize("cell", ["gpta-stage-train", "rwkv6-stage-train"])
def test_the_references_fast_forms_against_direct_ones(cell):
    """The reference's chunked recurrence against the recurrence taken one
    token at a time, its blocked attention against whole score matrices."""
    import torch

    from chipbench import weights
    from chipbench.reference import dense, rwkv6
    from chipbench.reference.common import Precision
    from chipbench.spec import shapes

    c = cpu.small_cell(cell)
    m = shapes(c.config)
    ref = rwkv6 if m.get("rwkv") else dense
    params = weights.make(ref.layout(m), 5, "cpu", lambda p: torch.float32)
    tokens = torch.randint(0, m["vocab_size"], (1, 32), generator=torch.Generator().manual_seed(1))
    if ref is rwkv6:
        lp = {k: w[0] for k, w in params["layers"].items()}
        B, T, H, D = 1, 32, m["d_model"] // 64, 64
        g = torch.Generator().manual_seed(2)
        r, k, v = (torch.randn(B, T, H, D, generator=g) for _ in range(3))
        logw = -torch.rand(B, T, H, D, generator=g) * 2
        u = lp["u"]
        S = torch.zeros(B, H, D, D)
        ys = []
        for t in range(T):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            ys.append(torch.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv))
            S = torch.exp(logw[:, t])[..., None] * S + kv
        assert torch.allclose(rwkv6.wkv(r, k, v, logw, u), torch.stack(ys, 1), rtol=1e-4, atol=1e-5)
    else:
        g = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(1, 40, 2, 32, generator=g) for _ in range(3))
        old = dense.Q_BLOCK
        dense.Q_BLOCK = 16
        try:
            got = dense._attention(q, k, v)
        finally:
            dense.Q_BLOCK = old
        want = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True).transpose(1, 2).reshape(1, 40, 64)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    loss = ref.loss(m, Precision("f32"), params, tokens)
    assert torch.isfinite(loss)


def test_the_gradient_sketch_estimates_the_norm_of_a_difference():
    import torch

    from chipbench import compare
    from chipbench.spec import load_module

    driver = load_module("drivers", "train")
    g = torch.Generator().manual_seed(3)
    x = {"a": torch.randn(64, 96, generator=g), "b": torch.randn(300, generator=g)}
    y = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in x.items()}
    sx, sy = driver._sketch(x, 2**31 + 7, 1.0), driver._sketch(y, 2**31 + 7, 1.0)
    for k in x:
        want = float((x[k] - y[k]).norm())
        assert 0.5 * want < compare._sketch_gap(sx[k], sy[k]) < 1.5 * want
    assert driver._sketch(x, 2**31 + 7, 2.0)["a"] == [2 * v for v in sx["a"]]
