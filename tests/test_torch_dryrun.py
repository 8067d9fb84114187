"""The port's dry-run (``repro_torch/launch/dryrun.py``): its counters against
hand counts, its pipelined step's transport bytes against the card's counters
(PERF.md section 5), ``run_one`` on full-size combinations, and the roofline's
table functions against the reference's (``benchmarks/roofline.py``) on the
same files."""
import dataclasses
import json
import math

import pytest
import torch

import benchmarks.roofline as ref_roofline
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import expected_shapes, flatten
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import build_model

META = torch.device("meta")
AXES = ("pod", "data", "model")


def _r(n):
    return -(-n // 512) * 512


def test_live_bytes_follow_storages_through_views_in_place_ops_and_frees():
    live = dryrun.LiveBytes()
    with live:
        a = torch.empty(1000, device=META)  # 4000 bytes -> 4096
        assert live.current == 4096
        v = a[10:]  # a view: no storage
        v.add_(1.0)  # in place: no storage
        assert live.current == 4096
        b = a * 2
        assert live.current == 8192
        del a  # the view keeps the storage
        assert live.current == 8192
        del v
        assert live.current == 4096
        c = torch.empty(100, dtype=torch.bfloat16, device=META)  # 200 bytes -> 512
        assert live.current == 4096 + 512
        del b, c
        assert live.current == 0
    assert live.peak == 8192


def test_live_bytes_keep_tensors_saved_for_backward_until_the_graph_goes():
    w = torch.empty(256, device=META, requires_grad=True)  # made before the mode: tracked as an argument
    live = dryrun.LiveBytes()
    with live:
        live.track(w)
        assert live.current == 1024
        x = torch.empty(256, device=META, requires_grad=True)
        y = x * w  # mul saves x and w
        t = y.sin()  # sin saves y
        del y
        assert live.current == 4 * 1024  # w, x, y (saved), t
        t.sum().backward()
        # the graph is freed: y goes, the sum's scalar and its gradient too; w.grad and x.grad stay
        assert live.current == 5 * 1024  # w, x, t, w.grad, x.grad
        del t
        assert live.current == 4 * 1024
    assert live.peak >= 6 * 1024  # y's gradient while y was still saved


def test_live_bytes_take_an_indexing_backward_in_place_as_the_card_does():
    """Under any dispatch mode autograd's backward of ``w[idx]`` makes zeros of
    w's shape and a copy of them; without one (the card) it writes into the
    zeros in place, so the gradient of an embedding table is held once."""
    w = torch.empty((1000, 64), device=META, requires_grad=True)  # 256,000 bytes
    idx = torch.empty((10,), dtype=torch.int64, device=META)
    live = dryrun.LiveBytes()
    with live:
        live.track((w, idx))
        w[idx].sum().backward()
        assert live.current == 2 * 256_000 + 512  # w, w.grad, idx
    assert 2 * 256_000 < live.peak < 2 * 256_000 + 8 * 2560  # never a third table


def test_count_reports_argument_bytes_unrounded_and_the_peak_rounded():
    x = torch.empty((3, 5), dtype=torch.bfloat16, device=META)  # 30 bytes
    c = dryrun.count(lambda: x.float() * 2, (x,))
    assert c["argument_bytes"] == 30
    assert c["peak_bytes"] == 512 + 2 * 512  # x, x.float(), the product
    assert c["bytes_accessed"] == (30 + 60) + (60 + 60)  # the cast, the product (the scalar is no tensor)
    assert c["flops"] == 0 and c["launches"] == {}


def test_flops_of_a_one_layer_prefill_equal_a_hand_count():
    cfg = dataclasses.replace(get_smoke_config("gpt_a"), num_layers=1)
    B, T = 2, 16
    N, d, H, hd, dff, V = B * T, cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    fn, args = dryrun.serve_program(cfg, "prefill", B, T)
    c = dryrun.count(fn, args)
    matmuls = 3 * 2 * N * d * H * hd + 2 * N * H * hd * d + 2 * 2 * N * d * dff + 2 * B * d * V
    flash = 4 * B * H * hd * (T * (T + 1) // 2)
    norms = 3 * 4 * N * d
    assert c["aten_flops"] == matmuls
    assert c["kernel_flops"] == flash + norms
    assert c["launches"] == {"rmsnorm": 3, "flash_attention": 1}


def _step_counts(cfg, shape, rank, boundary, batch):
    tokens = {"tokens": torch.empty((batch, 512), dtype=torch.int32, device=META)}
    fn, _, transport = dryrun.train_program(cfg, Mesh(shape, AXES, rank), tokens, boundary=boundary)
    fn()
    return transport.counts()


# the card's transport counters a rank a step (PERF.md section 5): GPT-A at full width with 4 layers, 8 x 512
@pytest.mark.parametrize("shape, boundary, want", [
    ((2, 1, 2), "direct", {"pod": {"send": 33_554_432, "all_reduce": 1_648_377_864, "all_gather": 0}}),
    ((2, 1, 2), "striped", {"pod": {"send": 16_777_216, "all_reduce": 1_648_377_864, "all_gather": 0},
                            "model": {"send": 0, "all_reduce": 0, "all_gather": 16_777_216}}),
    ((2, 2, 1), "direct", {"pod": {"send": 16_777_216, "all_reduce": 1_648_377_864, "all_gather": 0},
                           "data": {"send": 0, "all_reduce": 3_259_056_132, "all_gather": 0}}),
])
def test_meta_pipeline_bytes_equal_the_card_s_counters_gpt_a(shape, boundary, want):
    cfg = dataclasses.replace(get_config("gpt_a"), num_layers=4, dtype=torch.bfloat16)
    for rank in (0, 3):  # a rank of each stage
        got = _step_counts(cfg, shape, rank, boundary, 8)
        assert {a: ops for a, ops in got.items() if any(ops.values())} == want, (rank, got)


def test_meta_pipeline_bytes_equal_the_card_s_counters_zamba2():
    cfg = dataclasses.replace(get_config("zamba2_2p7b"), dtype=torch.bfloat16)
    got = _step_counts(cfg, (2, 1, 1), 0, "striped", 4)
    assert got["pod"] == {"send": 10_485_760, "all_reduce": 1_074_821_128, "all_gather": 0}


def test_meta_transport_raises_where_the_real_one_does():
    from repro_torch.parallel.transport import MetaTransport
    t = MetaTransport(Mesh((2, 1, 1), AXES, 1))
    with pytest.raises(ValueError, match="no neighbour"):
        t.send(torch.empty(4, device=META), "pod", +1)
    assert t.all_reduce(x := torch.empty(4, device=META), "data") is x
    assert t.counts()["pod"]["send"] == 0


FULL = [("gpt_a", "train_4k", "multi"), ("qwen2_moe_a2p7b", "prefill_32k", "single"),
        ("zamba2_2p7b", "long_500k", "multi")]


@pytest.fixture(scope="module")
def full_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    results = {}
    for arch, shape, mesh in FULL:
        r = dryrun.run_one(arch, shape, mesh)
        results[(arch, shape, mesh)] = r
        (out / f"{arch}_{shape}_{mesh}_striped.json").write_text(json.dumps(r))
    return out, results


@pytest.mark.parametrize("combo", FULL, ids=lambda c: "_".join(c))
def test_run_one_completes_full_size_combinations(full_results, combo):
    arch, shape, mesh = combo
    r = full_results[1][combo]
    assert r["status"] == "ok", r
    cfg = shp.config_for(arch, shape)
    s = shp.SHAPES[shape]
    chips = 512 if mesh == "multi" else 256
    tokens = s["global_batch"] * (s["seq_len"] if s["kind"] != "decode" else 1)
    # dryrun.py:423-424 of the reference, term for term
    want = (6.0 if s["kind"] == "train" else 2.0) * cfg.active_param_count() * tokens / chips
    assert r["roofline"]["model_flops_per_device"] == want
    assert r["roofline"]["compute_s"] == want / dryrun.PEAK_FLOPS
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert r["params"] == cfg.param_count() and r["active_params"] == cfg.active_param_count()
    if s["kind"] == "train":
        assert r["program"] == "pipeline" and set(r["stages"]) == {"0", "1"}
        assert r["collectives"]["dcn"] == max(st["collectives"]["dcn"] for st in r["stages"].values()) > 0
        by_axis = r["collectives"]["by_axis"]
        pod = by_axis["pod"]
        assert r["collectives"]["dcn"] == pod["send"] + pod["all_gather"] + 2 * pod["all_reduce"]
    else:
        assert r["program"] == "replica" and r["rows_per_rank"] == 1 and r["collectives"]["dcn"] == 0


def test_single_train_and_encoder_decode_are_skipped_with_reasons():
    """Single x train is no longer skipped (slice 7d): one rank of (16, 16)
    runs the plain data-parallel step on its 16 rows of the batch with the
    whole f32 state, and all-reduces every gradient and the loss's count and
    value over ``data`` alone.  The encoder's decodes stay skipped."""
    r = dryrun.run_one("gpt_a", "train_4k", "single")
    n = sum(math.prod(s) for s in expected_shapes(shp.config_for("gpt_a", "train_4k")).values())
    assert r["status"] == "ok" and r["program"] == "data_parallel" and r["rows_per_rank"] == 16
    assert r["memory"]["argument_bytes"] > 12 * n  # f32 parameters and two moments
    assert r["collectives"]["by_axis"]["data"] == {"send": 0, "all_reduce": 4 * n + 8, "all_gather": 0}
    assert not any(r["collectives"]["by_axis"]["model"].values()) and r["collectives"]["dcn"] == 0
    r = dryrun.run_one("hubert_xlarge", "decode_32k", "multi")
    assert r["status"] == "skipped" and "encoder-only" in r["reason"]


def test_roofline_functions_equal_the_reference_s_on_the_same_files(full_results, tmp_path, monkeypatch):
    d, results = full_results
    # the same files with a row of each other kind: skipped, error, direct, no ratio
    files = dict((p.name, json.loads(p.read_text())) for p in d.iterdir())
    r0 = results[FULL[1]]
    files["a_direct.json"] = {**r0, "boundary": "direct"}
    files["b_noratio.json"] = {**r0, "arch": "x", "roofline": {**r0["roofline"], "useful_flops_ratio": None}}
    files["c_skip.json"] = {"arch": "y", "shape": "train_4k", "mesh": "single", "status": "skipped", "reason": "r"}
    files["d_err.json"] = {"arch": "z", "shape": "train_4k", "mesh": "multi", "status": "error", "error": "e"}
    for name, r in files.items():
        (tmp_path / name).write_text(json.dumps(r))
    monkeypatch.setattr(ref_roofline, "load_results", lambda dryrun_dir=None: roofline.load_results(str(tmp_path)))
    assert roofline.load_results(str(tmp_path)) == [files[n] for n in sorted(files)]
    for mesh in ("single", "multi", None):
        for boundary in ("striped", "direct"):
            got = roofline.roofline_rows(mesh, boundary, dryrun_dir=str(tmp_path))
            assert repr(got) == repr(ref_roofline.roofline_rows(mesh, boundary))
            if mesh:
                assert roofline.markdown_table(mesh, boundary, dryrun_dir=str(tmp_path)) == \
                    ref_roofline.markdown_table(mesh, boundary)
    assert roofline.dominant_term(r0) == ref_roofline.dominant_term(r0)


def test_the_binding_term_weighs_the_counted_flops():
    # DeepSeek-Coder's prefill_32k at its rough size: one row of 32,768 tokens a rank counts
    # more FLOPs than the model's spread over 256 chips, and more seconds than its bytes
    rf = {"compute_s": 0.3, "compute_s_hlo": 2.2, "memory_s": 0.79, "collective_s": 0.0}
    assert roofline.dominant_term({"roofline": rf}) == ("memory", 0.79)
    assert roofline.binding_term({"roofline": rf}) == ("compute", 2.2)
    assert roofline.binding_term({"roofline": {**rf, "collective_s": 3.0}}) == ("collective", 3.0)
    assert roofline.binding_term({"roofline": {**rf, "compute_s_hlo": 0.5}}) == ("memory", 0.79)


def test_argument_bytes_count_a_shared_storage_once():
    model = build_model(get_smoke_config("gpt_a"))
    params = dryrun.meta_params(model)
    n = sum(t.numel() * t.element_size() for t in flatten(params).values())
    assert dryrun.argument_bytes(params) == n
    assert dryrun.argument_bytes((params, params)) == n
