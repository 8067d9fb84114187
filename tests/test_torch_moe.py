"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on converted weights: the two configs of the family, the
capacity, the top-k order among ties, ``moe_apply``'s output and aux loss in
f32 and bf16, forced capacity drops, a decode step, and the reference's
pairing of gate weights with expert slots (ROADMAP Queue 3 (e))."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro_torch import configs, convert
from repro_torch.models import moe
from repro_torch.models.modules import ModelConfig
from repro_torch.models.transformer import build_model
from torch_helpers import as_f32, reference_params

ARCHS = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# f32: the same arithmetic summed in another order (the router's and experts'
# products, the K contributions of a token).  bf16: the experts' products and
# the weighted contributions round to bf16 as in the reference; one rounding
# of the output (relative 2**-8) on top, so 2e-2 as atol and rtol.
Y_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the aux loss is f32 in both dtypes: a mean of f32 gates and of 0/1 routes
AUX_TOL = dict(atol=1e-6, rtol=1e-5)


def _layer0(tree):
    """Layer 0 of a layer-stacked parameter tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _setup(arch, dtype, **moe_changes):
    """(reference cfg, port cfg, reference layer-0 MoE params, port's) for ``arch``
    smoke; ``moe_changes`` replace fields of both MoEConfigs."""
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    if moe_changes:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_changes))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    ref_params, tree = reference_params(ref_cfg, seed=0)
    params = build_model(cfg).cast_params(convert.from_reference(tree, cfg))
    return ref_cfg, cfg, jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]), _layer0(params["layers"])["moe"]


def _x(cfg, shape_bt, seed=1):
    return np.random.default_rng(seed).standard_normal(shape_bt + (cfg.d_model,)).astype(np.float32)


def _both(ref_cfg, cfg, ref_p, p, x, dtype):
    jdt, tdt = _T[dtype]
    y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x).to(tdt))
    ref_y, ref_aux = ref_moe.moe_apply(ref_p, ref_cfg, jnp.asarray(x, jdt))
    return y, aux, ref_y, ref_aux


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_mirrors_reference(arch, size):
    get, ref_get = ((configs.get_config, ref_configs.get_config) if size == "full"
                    else (configs.get_smoke_config, ref_configs.get_smoke_config))
    cfg, ref_cfg = get(arch), ref_get(arch)
    for f in dataclasses.fields(ref_cfg):
        want, got = getattr(ref_cfg, f.name), getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert got == _DTYPES[jnp.dtype(want).name], f.name
        elif dataclasses.is_dataclass(want):  # the sub-configs are the port's own classes
            assert type(got).__name__ == type(want).__name__ and dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


def test_cli_ids_resolve_as_the_reference_s():
    for cli in ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b"):
        assert configs.canon(cli) == ref_configs.canon(cli)
        assert cli in configs.CLI_IDS and configs.get_config(cli).name == ref_configs.get_config(cli).name


@pytest.mark.parametrize("T", [1, 2, 7, 12, 16, 100, 512, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch, T):
    for size in (configs.get_config, configs.get_smoke_config):
        cfg = size(arch)
        ref_cfg = (ref_configs.get_config if size is configs.get_config else ref_configs.get_smoke_config)(arch)
        assert moe.capacity(T, cfg) == ref_moe.capacity(T, ref_cfg)
    assert moe.capacity(1, configs.get_config(arch)) == 8  # a decode step


# -- top-k order ----------------------------------------------------------------


def test_top_k_breaks_ties_toward_the_lower_index_as_jax():
    """Gates rounded to a few levels have many ties; the indices and values
    equal ``jax.lax.top_k``'s exactly, and all-equal rows pick 0..K-1."""
    rng = np.random.default_rng(5)
    g = np.round(rng.random((64, 60)) * 4).astype(np.float32) / 4
    g[:8] = 1.0 / 60  # all equal
    for k in (1, 4, 6):
        v, i = moe.top_k(torch.from_numpy(g), k)
        rv, ri = jax.lax.top_k(jnp.asarray(g), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        assert (i[:8].numpy() == np.arange(k)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_all_zero_rows_route_to_the_first_experts(arch, dtype):
    """x = 0 gives equal gates everywhere: both packages route every token to
    experts 0..K-1, fill their capacity in token order and drop the rest."""
    ref_cfg, cfg, ref_p, p = _setup(arch, dtype)
    x = np.zeros((2, 16, cfg.d_model), np.float32)
    gates = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    assert (moe.top_k(gates, cfg.moe.top_k)[1].numpy() == np.arange(cfg.moe.top_k)).all()
    y, aux, ref_y, ref_aux = _both(ref_cfg, cfg, ref_p, p, x, dtype)
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **Y_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(ref_aux), **AUX_TOL)


# -- moe_apply -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16), (3, 40), (1, 7)], ids=lambda s: f"B{s[0]}T{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, shape, dtype):
    ref_cfg, cfg, ref_p, p = _setup(arch, dtype)
    x = _x(cfg, shape)
    y, aux, ref_y, ref_aux = _both(ref_cfg, cfg, ref_p, p, x, dtype)
    assert y.dtype == _T[dtype][1] and y.shape == shape + (cfg.d_model,)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **Y_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(ref_aux), **AUX_TOL)
    # the routes themselves: the same top-k expert ids as the reference's, in the same order
    xin = torch.from_numpy(x).to(_T[dtype][1])
    ids = moe.top_k(torch.softmax(xin.float() @ p["router"], dim=-1), cfg.moe.top_k)[1]
    ref_gates = jax.nn.softmax(jnp.asarray(x, _T[dtype][0]).astype(jnp.float32) @ ref_p["router"], axis=-1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(ref_gates, cfg.moe.top_k)[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch, dtype):
    """A router column biased so that expert 2 wins every token: 40 tokens a
    sequence against a capacity of 32, so 8 of expert 2's assignments a
    sequence are dropped, in both packages alike."""
    ref_cfg, cfg, ref_p, p = _setup(arch, dtype)
    x = _x(cfg, (2, 40))
    bias = np.zeros(cfg.moe.num_experts, np.float32)
    bias[2] = 50.0
    # the bias enters through a constant input channel: router row 0 carries it, x[..., 0] = 1
    router = np.asarray(ref_p["router"]).copy()
    router[0] += bias
    x[..., 0] = 1.0
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    ids = moe.top_k(torch.softmax(torch.from_numpy(x).to(_T[dtype][1]).float() @ p["router"], -1), cfg.moe.top_k)[1]
    per_seq = (ids == 2).sum(dim=(1, 2))
    C = moe.capacity(40, cfg)
    assert C == 32 and (per_seq == 40).all(), (per_seq, C)  # drops happen in every sequence
    y, aux, ref_y, ref_aux = _both(ref_cfg, cfg, ref_p, p, x, dtype)
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **Y_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(ref_aux), **AUX_TOL)
    # without the capacity (cf 8: 40 x K / E x 8 slots) the output is another one
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    y8, _ = moe.moe_apply(p, cfg8, torch.from_numpy(x).to(_T[dtype][1]))
    assert (y8.float() - y.float()).abs().max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    """T = 1: a capacity of 8 slots an expert for one token."""
    ref_cfg, cfg, ref_p, p = _setup(arch, dtype)
    x = _x(cfg, (4, 1), seed=3)
    y, aux, ref_y, ref_aux = _both(ref_cfg, cfg, ref_p, p, x, dtype)
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **Y_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(ref_aux), **AUX_TOL)


def test_moe_apply_is_differentiable_like_the_reference():
    """d(sum(y * r) + aux)/d(x, router, experts) against jax.grad, f32."""
    ref_cfg, cfg, ref_p, p = _setup("qwen2_moe_a2p7b", "float32")
    x = _x(cfg, (2, 16))
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_f(params, xx):
        y, aux = ref_moe.moe_apply(params, ref_cfg, xx)
        return jnp.sum(y * r) + aux

    ref_gp, ref_gx = jax.grad(ref_f, argnums=(0, 1))(ref_p, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in convert.flatten(p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(convert.unflatten(leaves), cfg, xt)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, [xt] + list(leaves.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_gx), atol=1e-5, rtol=1e-4)
    ref_flat = convert.flatten(jax.tree.map(np.asarray, ref_gp))
    for (path, _), g in zip(leaves.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), ref_flat[path], atol=1e-5, rtol=1e-4, err_msg=path)


def test_combine_has_a_fixed_order():
    """Two calls on the same inputs give the same bits (no atomics, no order
    that changes from run to run)."""
    _, cfg, _, p = _setup("deepseek_v2_lite_16b", "float32")
    x = torch.from_numpy(_x(cfg, (3, 40)))
    a, b = moe.moe_apply(p, cfg, x), moe.moe_apply(p, cfg, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- the reference's gate pairing (ROADMAP Queue 3 (e)) ---------------------------


def _sorted_dispatch_moe(p, cfg: ModelConfig, x: np.ndarray, pair_by_order: bool) -> np.ndarray:
    """The sort-based dispatch in numpy (f64), no capacity: each slot of the
    expert-sorted order runs its expert on its token and is weighted by
    ``flat_w[slot]`` (the reference's pairing) or ``flat_w[order[slot]]`` (the
    slot's own (token, k) weight)."""
    K = cfg.moe.top_k
    f64 = {k: np.asarray(v, np.float64) for k, v in convert.flatten(p).items()}
    silu = lambda a: a / (1 + np.exp(-a))  # noqa: E731
    B, T, d = x.shape
    logits = x.astype(np.float64) @ f64["router"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    top_i = np.argsort(-gates, axis=-1, kind="stable")[..., :K]
    top_w = np.take_along_axis(gates, top_i, -1)
    y = np.zeros((B, T, d))
    for b in range(B):
        flat_e, flat_w = top_i[b].reshape(-1), top_w[b].reshape(-1)
        order = np.argsort(flat_e, kind="stable")
        for slot, j in enumerate(order):
            e, t = flat_e[j], j // K
            h = silu(x[b, t] @ f64["w_gate"][e]) * (x[b, t] @ f64["w_up"][e])
            w = flat_w[j] if pair_by_order else flat_w[slot]
            y[b, t] += w * (h @ f64["w_down"][e])
    sh = silu(x @ f64["shared/w_gate"]) * (x @ f64["shared/w_up"])
    return y + sh @ f64["shared/w_down"]


def _per_token_moe(p, cfg: ModelConfig, x: np.ndarray) -> np.ndarray:
    """The MoE as a per-token top-k: each token's K experts, each weighted by its own gate."""
    K = cfg.moe.top_k
    f64 = {k: np.asarray(v, np.float64) for k, v in convert.flatten(p).items()}
    silu = lambda a: a / (1 + np.exp(-a))  # noqa: E731
    logits = x.astype(np.float64) @ f64["router"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    top_i = np.argsort(-gates, axis=-1, kind="stable")[..., :K]
    y = np.zeros(x.shape)
    for idx in np.ndindex(x.shape[:2]):
        for e in top_i[idx]:
            h = silu(x[idx] @ f64["w_gate"][e]) * (x[idx] @ f64["w_up"][e])
            y[idx] += gates[idx][e] * (h @ f64["w_down"][e])
    sh = silu(x @ f64["shared/w_gate"]) * (x @ f64["shared/w_up"])
    return y + sh @ f64["shared/w_down"]


def test_reference_pairs_gate_weights_with_other_slots():
    """Queue 3 (e): at capacity factor 8 (nothing dropped), the reference's
    ``moe_apply`` and the port's differ from a per-token top-k MoE, because
    ``repro/models/moe.py:113`` multiplies the expert-sorted slots by the
    token-major ``flat_w``; taking ``flat_w`` through ``order`` (``:81``)
    first closes the gap.  The port mirrors the reference."""
    ref_cfg, cfg, ref_p, p = _setup("qwen2_moe_a2p7b", "float32", capacity_factor=8.0)
    x = _x(cfg, (2, 16))
    y, _, ref_y, _ = _both(ref_cfg, cfg, ref_p, p, x, "float32")
    as_reference = _sorted_dispatch_moe(p, cfg, x, pair_by_order=False)
    fixed = _sorted_dispatch_moe(p, cfg, x, pair_by_order=True)
    per_token = _per_token_moe(p, cfg, x)
    # the numpy dispatch with the reference's pairing is the reference, and the port
    np.testing.assert_allclose(as_f32(ref_y), as_reference, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(as_f32(y), as_reference, atol=1e-5, rtol=1e-5)
    # with each slot's own weight it is the per-token MoE, to f64 rounding
    np.testing.assert_allclose(fixed, per_token, atol=1e-12, rtol=1e-12)
    # and the reference is not: about 1 at outputs of about 3 on this input
    gap = np.abs(as_f32(ref_y) - per_token).max()
    assert gap > 0.25, gap


@pytest.mark.parametrize("extra", [[], ["--splitwise"]], ids=["generate", "splitwise"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_serve_cli_serves_the_moe_family_on_the_cpu(arch, extra, capsys):
    """The launcher takes the family's CLI ids; ragged batches of 3 prompts."""
    from repro_torch.launch import serve

    done = serve.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--max-new", "3", "--batch", "3",
                       "--prompt-len", "12", "--max-len", "32"] + extra)
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert f"arch={configs.get_smoke_config(arch).name}" in out and "device=cpu" in out
    assert ("KV bytes moved" in out) == ("--splitwise" in extra)
