"""The port stands alone: it imports torch and nothing of jax or repro, its
entry points run on the card unless the CPU is asked for, and it calls no
finished kernel."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), f"{path}: imports {name}"


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_finished_kernels_inside_the_package(path):
    """No torch.compile, fused attention or fused norm inside the package
    (``chip_smoke.py`` alone may time one beside a kernel)."""
    tree = ast.parse(path.read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} | \
            {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {"scaled_dot_product_attention", "rms_norm", "compile", "cudnn", "cpp_extension"}, path


def test_package_has_every_serving_module():
    have = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    want = {"__init__.py", "device.py", "convert.py", "models/modules.py", "models/attention.py",
            "models/transformer.py", "configs/__init__.py", "configs/gpt_a.py", "configs/gpt_b.py",
            "configs/minitron_4b.py", "configs/rwkv6_7b.py", "kernels/build.py", "kernels/ops.py",
            "kernels/ref.py", "kernels/rmsnorm.py", "kernels/flash_attention.py", "kernels/decode_attention.py",
            "kernels/wkv6.py", "models/rwkv.py", "serving/engine.py", "launch/serve.py",
            "optim/optimizer.py", "data/pipeline.py", "launch/train.py", "models/moe.py",
            "configs/qwen2_moe_a2p7b.py", "configs/deepseek_v2_lite_16b.py", "configs/deepseek_coder_33b.py",
            "configs/granite_34b.py", "configs/nemotron_4_15b.py", "configs/qwen2_vl_7b.py",
            "configs/hubert_xlarge.py", "models/ssm.py", "configs/zamba2_2p7b.py", "ckpt/__init__.py",
            "ckpt/checkpoint.py", "launch/mesh.py", "parallel/__init__.py", "parallel/pipeline.py",
            "parallel/sharding.py", "parallel/transport.py", "units.py", "obs/__init__.py", "obs/__main__.py",
            "obs/tracer.py", "obs/schema.py", "obs/metrics.py", "obs/crosscheck.py", "obs/export.py", "obs/emit.py",
            "core/__init__.py", "core/wan.py", "core/topology.py", "core/simulator.py", "core/temporal.py",
            "core/fastforward.py", "core/validate.py", "core/dc_selection.py", "core/bubbletea.py",
            "core/failures.py", "core/control.py", "core/fleet.py", "core/reference.py",
            "parallel/data_parallel.py", "examples/__init__.py", "examples/whatif.py", "examples/bubbletea_serve.py",
            "examples/quickstart.py", "examples/train_100m.py", "examples/geo_train.py", "parallel/tensor_parallel.py"}
    assert want <= have
    csrc = {p.name for p in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").iterdir()}
    assert {"rmsnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu", "wkv6.cu"} <= csrc


_BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch.serving.engine, repro_torch.launch.serve, repro_torch.convert, repro_torch.kernels.ref
import repro_torch.models.rwkv, repro_torch.models.ssm, repro_torch.launch.train, repro_torch.optim.optimizer, repro_torch.data.pipeline
import repro_torch.ckpt.checkpoint, repro_torch.launch.mesh, repro_torch.parallel.pipeline, repro_torch.parallel.sharding
import repro_torch.core, repro_torch.core.reference, repro_torch.obs, repro_torch.obs.__main__, repro_torch.units
import repro_torch.parallel.data_parallel, repro_torch.examples.whatif, repro_torch.examples.bubbletea_serve
import repro_torch.examples.quickstart, repro_torch.examples.train_100m, repro_torch.examples.geo_train
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("imported")
"""


def test_engine_imports_where_jax_and_repro_cannot_be_imported():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and "imported" in r.stdout, r.stderr


def test_entry_points_raise_without_a_card_unless_the_cpu_is_asked_for():
    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import ServingEngine, SplitwiseCluster

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    cfg = configs.get_smoke_config("gpt_a")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, max_batch=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        SplitwiseCluster(cfg, params, max_batch=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "gpt-a", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train(cfg, steps=1, batch=2, seq=8)


@pytest.mark.parametrize("example, kwargs", [("quickstart", {"steps": 1}), ("bubbletea_serve", {}),
                                             ("geo_train", {"steps": 1}), ("train_100m", {"argv": ["--steps", "1"]})])
def test_examples_raise_without_a_card_unless_the_cpu_is_asked_for(example, kwargs, tmp_path, capsys):
    """Each example that trains or serves refuses before it prints or writes
    anything (``whatif`` is host code and has no device)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{example}")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing to refuse")
    if "argv" in kwargs:
        kwargs = {"argv": kwargs["argv"] + ["--ckpt-dir", str(tmp_path / "ck")]}
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(**kwargs)
    assert capsys.readouterr().out == "" and not (tmp_path / "ck").exists()


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT), env={"PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and r.stdout.strip() == ""


@pytest.mark.parametrize("extra", [[], ["--splitwise"], ["--arch", "minitron-4b"], ["--arch", "rwkv6-7b"],
                                   ["--arch", "rwkv6-7b", "--splitwise"], ["--arch", "deepseek-coder-33b"],
                                   ["--arch", "granite-34b", "--splitwise", "--layers", "1"],
                                   ["--arch", "nemotron-4-15b"], ["--arch", "qwen2-vl-7b", "--splitwise"],
                                   ["--arch", "zamba2-2.7b"], ["--arch", "zamba2-2.7b", "--splitwise"]])
def test_serve_cli_runs_on_the_cpu(extra, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--device", "cpu", "--requests", "3", "--max-new", "3", "--batch", "2",
                       "--prompt-len", "12", "--max-len", "32"] + extra)
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "device=cpu" in out and "TTFT ms" in out
    assert ("KV bytes moved" in out) == ("--splitwise" in extra)


def test_serve_cli_prints_the_references_analytic_ttft_line(capsys):
    """The reference's launcher ends with the analytic TTFT of the paper's A100
    testbed; the port's prints the same line from its own copy of the model."""
    from repro.core.bubbletea import InferenceModelSpec, PrefillLatencyModel
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2", "--batch", "2", "--prompt-len", "8",
                "--max-len", "16"])
    lm = PrefillLatencyModel(InferenceModelSpec("llama3-8b", 8e9))
    want = f"  [model] A100 TTFT(512, PP=1)={lm.ttft_ms(512,1):.0f}ms (8192, PP=8)={lm.ttft_ms(8192,8):.0f}ms"
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert serve.PrefillLatencyModel.__module__ == "repro_torch.core.bubbletea"


def test_build_refuses_where_there_is_no_nvcc(monkeypatch):
    """A build that cannot be made raises; nothing falls back."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
    assert {"rmsnorm_launch", "rmsnorm_bwd_grid", "rmsnorm_bwd_launch", "flash_attention_launch",
            "flash_attention_bwd_launch", "decode_attention_launch", "wkv6_launch",
            "wkv6_bwd_launch"} == set(build.SIGNATURES)


def test_serve_cli_refuses_the_encoder():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="does not decode"):
        serve.main(["--device", "cpu", "--arch", "hubert-xlarge", "--requests", "1"])
