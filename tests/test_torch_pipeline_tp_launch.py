"""The launcher's ``--pipeline`` under torchrun on the (2, 2, 2) host mesh of
eight ``gloo`` CPU ranks: the MoE family (ROADMAP 7b-ii), RWKV-6 and the
Zamba2 hybrid (7b-iii) split over ``model`` inside the stages, so their
``[train]`` lines carry no note and each run ends with its step line.  No
family keeps ``model`` replicas: the pure Mamba2 stack, which no arch of the
launcher is, splits by heads too (7b-v), and the launcher's note is gone
(``test_torch_tensor_parallel_hybrid.py``, ``test_torch_pipeline_tp_mamba.py``)."""
import os
import subprocess
import sys

from repro_torch import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torchrun_pipeline_says_which_family_keeps_model_replicas():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    for arch, key, note in (("qwen2-moe-a2.7b", "qwen2_moe_a2p7b", ""), ("rwkv6-7b", "rwkv6_7b", ""),
                            ("zamba2-2.7b", "zamba2_2p7b", "")):
        cfg = configs.get_smoke_config(key)
        args = ["--arch", arch, "--smoke", "--pipeline", "--steps", "1", "--batch", "8", "--seq", "16",
                "--device", "cpu"]
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "8",
                            "-m", "repro_torch.launch.train", *args], capture_output=True, text=True, env=env,
                           timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        lines = r.stdout.splitlines()
        assert [ln for ln in lines if ln.startswith("[train]")] == [
            f"[train] arch={cfg.name} device=cpu mesh={{'pod': 2, 'data': 2, 'model': 2}} "
            f"params={cfg.param_count() / 1e6:.1f}M{note}"]
        assert len([ln for ln in lines if ln.startswith("step ")]) == 1
