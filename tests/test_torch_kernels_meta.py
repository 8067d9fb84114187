"""The kernels' wrappers on ``meta`` tensors (the dry-run's path): the
outputs' shapes and dtypes are the CPU path's, forward and backward; each call
records one launch of its kernel, as the card's wrappers count theirs (a
backward's kernels once); the recorded operations and bytes are the kernel
modules' cost formulas, the ones ``chip_smoke.py``'s bound column reads, and
give the kernel table's bounds (PERF.md) at GPT-A's shapes; what a wrapper
allocates is what the card's wrapper allocates; and the module counters that
``chip_smoke.py`` holds exact are never touched on ``meta``."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import wkv6
from repro_torch.launch.dryrun import count

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ((rms, "launches"), (rms, "bwd_launches"), (fa, "launches"), (fa, "bwd_launches"), (dec, "launches"),
            (wkv6, "launches"), (wkv6, "bwd_launches"), (wkv6, "bwd_chunk_launches"))


def _counters():
    return [getattr(m, n) for m, n in COUNTERS]


def _inputs(seed, specs):
    """CPU tensors from a seeded numpy draw (int32 specs get positions)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, dtype in specs:
        if dtype == torch.int32:
            out.append(torch.from_numpy(rng.integers(-1, shape[-1], size=shape).astype(np.int32)))
        else:
            out.append(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype))
    return out


def _meta(ts):
    return [torch.empty_like(t, device="meta") for t in ts]


def _sig(x):
    return [(tuple(t.shape), t.dtype) for t in (x if isinstance(x, (tuple, list)) else (x,))]


def _wkv_specs(B, T, H, D, dtype):
    return [((B, T, H, D), dtype)] * 3 + [((B, T, H, D), torch.float32), ((H, D), torch.float32)]


def _wkv_cpu(seed, B, T, H, D, dtype):
    r, k, v, w, u = _inputs(seed, _wkv_specs(B, T, H, D, dtype))
    return [r, k, v, -torch.exp(w.float()) * 0.1, u]


# (name, a call through ops, its CPU inputs, the cost formula of that call)
FORWARD = {
    "rmsnorm_bf16": ("rmsnorm", lambda x, s: ops.rmsnorm(x, s), lambda: _inputs(0, [((2, 5, 64), torch.bfloat16),
                                                                                  ((64,), torch.float32)]),
                     rms.fwd_cost(10, 64, torch.bfloat16)),
    "rmsnorm_f32": ("rmsnorm", lambda x, s: ops.rmsnorm(x, s), lambda: _inputs(1, [((7, 48), torch.float32),
                                                                                 ((48,), torch.float32)]),
                    rms.fwd_cost(7, 48, torch.float32)),
    "flash_causal_gqa": ("flash_attention", lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                         lambda: _inputs(2, [((2, 9, 4, 32), torch.bfloat16), ((2, 9, 2, 32), torch.bfloat16),
                                             ((2, 9, 2, 32), torch.bfloat16)]),
                         fa.fwd_cost(2, 9, 9, 4, 2, 32, True, torch.bfloat16)),
    "flash_full_f32": ("flash_attention", lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
                       lambda: _inputs(3, [((1, 6, 2, 80), torch.float32)] * 3),
                       fa.fwd_cost(1, 6, 6, 2, 2, 80, False, torch.float32)),
    "decode": ("decode_attention", lambda q, k, v, qp, kp: ops.decode_attention(q, k, v, qp, kp),
               lambda: _inputs(4, [((2, 1, 4, 32), torch.bfloat16), ((2, 17, 2, 32), torch.bfloat16),
                                   ((2, 17, 2, 32), torch.bfloat16), ((2, 1), torch.int32), ((2, 17), torch.int32)]),
               dec.cost_of(2, 17, 4, 2, 32, 2 * 17, torch.bfloat16)),
    "wkv6_chunked": ("wkv6", lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u), lambda: _wkv_cpu(5, 2, 40, 2, 64,
                                                                                        torch.bfloat16),
                     wkv6.fwd_cost(2, 40, 2, 64, torch.bfloat16, False)),
    "wkv6_step_state": ("wkv6", lambda r, k, v, w, u, S: ops.wkv6(r, k, v, w, u, S),
                        lambda: _wkv_cpu(6, 2, 1, 2, 32, torch.float32) + [torch.zeros(2, 2, 32, 32)],
                        wkv6.fwd_cost(2, 1, 2, 32, torch.float32, True)),
}


@pytest.mark.parametrize("case", FORWARD)
def test_forward_on_meta_is_the_cpu_path_s_shape_and_one_recorded_launch(case):
    name, call, make, want_cost = FORWARD[case]
    cpu = make()
    before = _counters()
    with torch.no_grad():
        want = _sig(call(*[t.clone() for t in cpu]))
        with cost.recording() as rec:
            got = call(*_meta(cpu))
    assert _sig(got) == want and all(t.device.type == "meta" for t in (got if isinstance(got, tuple) else (got,)))
    assert rec.launches == {name: 1}
    assert (rec.bytes, rec.flops) == want_cost[:2]
    assert _counters() == before


BACKWARD = {
    "rmsnorm": (lambda x, s: ops.rmsnorm(x, s), lambda: _inputs(7, [((3, 4, 64), torch.bfloat16),
                                                                     ((64,), torch.float32)]),
                {"rmsnorm": 1, "rmsnorm_bwd": 1}),
    "flash": (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
              lambda: _inputs(8, [((2, 7, 4, 64), torch.bfloat16), ((2, 7, 1, 64), torch.bfloat16),
                                  ((2, 7, 1, 64), torch.bfloat16)]),
              {"flash_attention": 1, "flash_attention_bwd": 1}),
    "wkv6_chunked": (lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u), lambda: _wkv_cpu(9, 1, 64, 2, 64, torch.bfloat16),
                     {"wkv6": 1, "wkv6_bwd": 1}),
    "wkv6_sequential": (lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u), lambda: _wkv_cpu(10, 2, 5, 1, 32, torch.float32),
                        {"wkv6": 1, "wkv6_bwd": 1}),
}


def _grads(call, inputs):
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    out = call(*leaves)
    out.float().sum().backward()
    return [(tuple(t.grad.shape), t.grad.dtype) for t in leaves], _sig(out)


@pytest.mark.parametrize("case", BACKWARD)
def test_backward_on_meta_is_the_cpu_path_s_shape_and_one_recorded_launch_each_way(case):
    call, make, want_launches = BACKWARD[case]
    cpu = make()
    before = _counters()
    want = _grads(call, cpu)
    with cost.recording() as rec:
        got = _grads(call, _meta(cpu))
    assert got == want
    assert rec.launches == want_launches
    assert _counters() == before


def _r(n):
    return -(-n // 512) * 512


def test_decode_allocates_the_partials_of_split_plan():
    B, S, Hq, Hkv, D = 2, 1000, 8, 2, 64
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in ((B, 1, Hq, D), (B, S, Hkv, D),
                                                                           (B, S, Hkv, D)))
    qp, kp = torch.empty((B, 1), dtype=torch.int32, device="meta"), torch.empty((B, S), dtype=torch.int32, device="meta")
    args = (q, k, v, qp, kp)
    c = count(lambda: ops.decode_attention(*args), args)
    nsplit, _ = dec.split_plan(B, Hkv, S, cost.SM_COUNT)
    assert nsplit > 1
    held = sum(_r(t.numel() * t.element_size()) for t in args)
    assert c["peak_bytes"] == held + _r(B * Hq * D * 2) + _r(nsplit * B * Hq * D * 4) + _r(2 * nsplit * B * Hq * 4)
    assert c["launches"] == {"decode_attention": 1} and c["kernel_bytes"] == dec.cost_of(B, S, Hq, Hkv, D, B * S,
                                                                                         torch.bfloat16)[0]


@pytest.mark.parametrize("T, chunked", [(128, True), (16, False)])
def test_wkv6_backward_allocates_its_route_s_workspace(T, chunked):
    B, H, D = 1, 2, 64
    r, k, v, w, dy = (torch.empty((B, T, H, D), dtype=torch.float32 if i == 3 else torch.bfloat16, device="meta")
                      for i in range(5))
    u = torch.empty((H, D), device="meta")
    args = (r, k, v, w, u, dy)
    assert wkv6.bwd_chunked(torch.bfloat16, T, D, True) == chunked
    c = count(lambda: wkv6.wkv6_bwd_meta(*args), args)
    held = sum(_r(t.numel() * t.element_size()) for t in args)
    grads = 3 * _r(B * T * H * D * 2) + _r(B * T * H * D * 4) + _r(H * D * 4)
    work = B * H * -(-T // 64) * D * D * 4 if chunked else B * H * T * D * 4
    assert c["peak_bytes"] == held + grads + _r(B * H * D * 4) + _r(work)
    assert c["launches"] == {"wkv6_bwd": 1}


def test_cost_formulas_give_the_kernel_table_s_bounds_at_gpt_a_s_shapes():
    """The formulas moved from chip_smoke.py into the kernel modules, checked
    against the numbers its inline formulas gave (PERF.md's kernel table)."""
    bf = torch.bfloat16
    assert rms.fwd_cost(2048, 4096, bf)[:2] == (2 * 2048 * 4096 * 2 + 4096 * 4, 4 * 2048 * 4096)
    assert rms.bwd_cost(2048, 4096, bf)[:2] == (3 * 2048 * 4096 * 2 + 2 * 4096 * 4, 10 * 2048 * 4096)
    assert fa.fwd_cost(4, 512, 512, 32, 32, 128, True, bf)[:2] == (4 * 4 * 512 * 32 * 128 * 2,
                                                                  4 * 4 * 32 * 128 * (512 * 513 // 2))
    assert fa.fwd_cost(4, 512, 512, 56, 8, 128, True, bf)[0] == (2 * 4 * 512 * 56 * 128 + 2 * 4 * 512 * 8 * 128) * 2
    assert fa.bwd_cost(4, 512, 512, 32, 32, 128, True, bf)[:2] == (8 * 4 * 512 * 32 * 128 * 2 + 2 * 4 * 32 * 512 * 4,
                                                                  5 * 2 * 4 * 32 * 128 * (512 * 513 // 2))
    valid = 4 * 520
    assert dec.cost_of(4, 1024, 32, 32, 128, valid, bf)[:2] == (
        2 * valid * 32 * 128 * 2 + 4 * 1024 * 4 + 4 * 4 + 2 * 4 * 32 * 128 * 2, 4 * valid * 32 * 128)
    n = 4 * 512 * 64 * 64
    assert wkv6.fwd_cost(4, 512, 64, 64, bf, True) == (4 * n * 2 + n * 4 + 64 * 64 * 4 + 2 * 4 * 64 * 64 * 64 * 4,
                                                       wkv6.chunk_flops(4, 512, 64), cost.BF16_FLOPS)
    assert wkv6.fwd_cost(4, 1, 64, 64, bf, True)[1:] == (4 * 64 * (5 * 64 * 64 + 5 * 64), cost.F32_FLOPS)
    assert wkv6.bwd_cost(4, 512, 64, 64, bf) == (7 * n * 2 + 2 * n * 4 + 2 * 64 * 64 * 4,
                                                 wkv6.bwd_chunk_flops(4, 512, 64), cost.BF16_FLOPS)
    assert wkv6.chunk_flops(4, 512, 64) == 4 * 64 * 8 * (sum(24 * w + 16 * (w + 1) for w in range(4)) + 640) * 4096
    assert cost.bound(rms.fwd_cost(2048, 4096, bf))["bound_by"] == "bytes"


def test_chip_smoke_reads_the_kernel_modules_formulas():
    """chip_smoke.py defines no formula of its own: its bound column calls the
    modules' cost functions and its peaks are ``kernels/cost.py``'s."""
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert not defined & {"wkv6_bwd_flops", "wkv6_chunk_flops", "wkv6_bwd_chunk_flops"}
    called = {n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert {"fwd_cost", "bwd_cost", "cost_of", "bound"} <= called
    assert "3.35e12" not in src and "989e12" not in src and "67e12" not in src


@pytest.mark.parametrize("dtype, d, vec, threads", [
    (torch.bfloat16, 1024, 1, 32), (torch.bfloat16, 1025, 1, 64), (torch.bfloat16, 2048, 1, 64),
    (torch.bfloat16, 2560, 1, 128), (torch.bfloat16, 4096, 1, 128), (torch.bfloat16, 5120, 1, 0),
    (torch.bfloat16, 4096, 0, 0), (torch.float32, 512, 1, 32), (torch.float32, 2048, 1, 128),
    (torch.float32, 4096, 1, 256)])
def test_rmsnorm_backward_grid_follows_csrc_s_arithmetic(dtype, d, vec, threads):
    """``bwd_threads`` as csrc's: 32 threads doubled until a thread's four
    16-byte chunks cover the row, none past 4096 or without ``vec``; the grid one
    wave of the kernel's blocks an SM, evened out over the rows."""
    assert rms.bwd_threads(d, dtype, vec) == threads
    wave = 132 * rms.BWD_BLOCKS_PER_SM[(dtype, threads)]
    for n in (1, wave - 1, wave, wave + 1, 2048, 4 * wave + 3):
        blocks, nt = rms.bwd_grid_at(n, d, dtype, vec, 132)
        per = -(-n // blocks)
        assert nt == threads and blocks <= min(n, wave) and (blocks - 1) * per < n <= blocks * per
    assert rms.bwd_grid_at(2048, 4096, torch.bfloat16, 1, 132) == (256, 128)  # GPT-A's rows: 2 blocks an SM, 8 rows each


def test_rmsnorm_backward_on_meta_allocates_the_partials_of_its_grid():
    n, d = 2048, 4096
    x, dy = (torch.empty((n, d), dtype=torch.bfloat16, device="meta") for _ in range(2))
    scale = torch.empty((d,), device="meta")
    args = (x, scale, dy)
    c = count(lambda: rms.rmsnorm_bwd_rows_meta(*args), args)
    blocks, _ = rms.bwd_grid_at(n, d, torch.bfloat16, 1, cost.SM_COUNT)
    held = sum(_r(t.numel() * t.element_size()) for t in args)
    assert c["peak_bytes"] == held + _r(n * d * 2) + _r(d * 4) + _r(blocks * d * 4)
    assert c["launches"] == {"rmsnorm_bwd": 1}


@pytest.mark.parametrize("call, match", [
    (lambda m: rms.rmsnorm_rows_meta(m((4, 64)).t(), m((4,))), "contiguous"),
    (lambda m: rms.rmsnorm_bwd_rows_meta(m((4, 64)), m((64,), torch.bfloat16), m((4, 64))), "scale must be"),
    (lambda m: fa.flash_attention_meta(m((1, 8, 2, 48)), m((1, 8, 2, 48)), m((1, 8, 2, 48)), causal=True),
     "head size"),
    (lambda m: fa.flash_attention_meta(m((1, 8, 2, 41))[..., :32], m((1, 8, 2, 32)), m((1, 8, 2, 32)), causal=True),
     "16-byte"),
    (lambda m: dec.decode_attention_meta(m((1, 1, 2, 32)), m((1, 8, 2, 32)), m((1, 8, 2, 32)),
                                         m((1, 1), torch.int32), m((1, 8), torch.int64)), "kv_pos must be"),
    (lambda m: wkv6.wkv6_meta(*(m((1, 4, 2, 64)) for _ in range(4)), m((2, 32))), r"u must be \(2, 64\)"),
])
def test_meta_wrappers_refuse_what_the_card_s_wrappers_refuse(call, match):
    """The meta wrappers run the card wrappers' own checks (one helper a kernel)."""
    with pytest.raises(ValueError, match=match):
        call(lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta"))


def test_meta_wrappers_refuse_an_input_that_requires_grad():
    x = torch.empty((4, 64), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="gradients"):
        rms.rmsnorm_rows_meta(x, torch.empty((64,), device="meta"))
