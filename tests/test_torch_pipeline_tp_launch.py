"""The launcher's ``--pipeline`` under torchrun on the (2, 2, 2) host mesh of
eight ``gloo`` CPU ranks: the MoE family now splits over ``model`` inside the
stages (ROADMAP 7b-ii), so its ``[train]`` line carries no note and the run
ends with its step line; RWKV-6 keeps its ``model`` replicas inside the stages
until 7b-iii, and rank 0's line says so, as it says it on the plain step."""
import os
import subprocess
import sys

from repro_torch import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torchrun_pipeline_says_which_family_keeps_model_replicas():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    for arch, key, note in (("qwen2-moe-a2.7b", "qwen2_moe_a2p7b", ""),
                            ("rwkv6-7b", "rwkv6_7b", " tp=replicated (ROADMAP 7b-iii)")):
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
