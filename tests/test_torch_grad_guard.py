"""The kernels' wrappers refuse to be differentiated.

The CUDA kernels' raw wrappers (the four forward kernels and WKV-6's
backward) write their outputs through raw pointers, so a loss on the card
would get no gradient through them and nothing would say so.  Each wrapper
therefore raises ``ValueError`` when gradients are
enabled and an input requires grad, before it looks at the device, so the
check shows here on the CPU.  Under ``torch.no_grad()`` the same call reaches
the device check and raises for the CPU tensor, as before.  Serving runs under
``torch.no_grad()`` and is unaffected.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import flatten
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_cuda
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import Request, ServingEngine


# each wrapper with CPU inputs of which one requires grad
def _rmsnorm():
    return rmsnorm_rows, (torch.zeros(4, 64, requires_grad=True), torch.ones(64)), {}


def _flash():
    q = torch.zeros(1, 8, 2, 32)
    return flash_attention_cuda, (q, q.clone().requires_grad_(True), q), {"causal": True}


def _decode():
    q = torch.zeros(1, 1, 2, 32, requires_grad=True)
    kv = torch.zeros(1, 8, 2, 32)
    pos = (torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 8, dtype=torch.int32))
    return decode_attention_cuda, (q, kv, kv, *pos), {}


def _wkv6():
    r = torch.zeros(1, 4, 2, 32)
    state = torch.zeros(1, 2, 32, 32)
    u = torch.zeros(2, 32, requires_grad=True)  # the bonus, a parameter
    return wkv6_cuda, (r, r, r, r, u, state), {}


def _wkv6_bwd():
    r = torch.zeros(1, 4, 2, 32)
    return wkv6_bwd_cuda, (r, r, r.clone().requires_grad_(True), r, torch.zeros(2, 32), r), {}


WRAPPERS = {"rmsnorm": _rmsnorm, "flash_attention": _flash, "decode_attention": _decode, "wkv6": _wkv6,
            "wkv6_bwd": _wkv6_bwd}


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_an_input_that_requires_grad(name):
    fn, args, kwargs = WRAPPERS[name]()
    with pytest.raises(ValueError, match="gradients") as info:
        fn(*args, **kwargs)
    assert name in str(info.value)


@pytest.mark.parametrize("name", WRAPPERS)
def test_under_no_grad_only_the_device_check_remains(name):
    fn, args, kwargs = WRAPPERS[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(*args, **kwargs)


@pytest.mark.parametrize("arch", ["gpt_a", "rwkv6_7b"])
def test_serving_with_parameters_that_require_grad_still_runs(arch):
    """The engine's prefill and decode steps run under torch.no_grad(), so
    parameters that require grad (as a trainer's would) do not trip the guard."""
    cfg = configs.get_smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    leaves = [t for t in flatten(params).values() if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    engine = ServingEngine(cfg, params, max_batch=2, max_len=32, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    out = engine.generate([Request(i, p, max_new_tokens=3) for i, p in enumerate(prompts)])
    assert all(len(r.generated) == 3 and all(0 <= t < cfg.vocab_size for t in r.generated) for r in out)
