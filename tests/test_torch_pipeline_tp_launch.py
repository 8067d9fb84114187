"""The launcher's ``--pipeline`` under torchrun on the (2, 2, 2) host mesh of
eight ``gloo`` CPU ranks for a family that keeps its ``model`` replicas inside
the stages (the MoE and MLA configs until ROADMAP 7b-ii): rank 0's
``[train]`` line says so, as it says it on the plain step, and the run ends
with its step line; the dense family splits (``test_torch_pipeline_launch.py``)
and its line carries no note."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torchrun_pipeline_says_which_family_keeps_model_replicas():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    args = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--pipeline", "--steps", "1", "--batch", "8", "--seq", "16",
            "--device", "cpu"]
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "8",
                        "-m", "repro_torch.launch.train", *args], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("[train]")] == [
        "[train] arch=qwen2-moe-smoke device=cpu mesh={'pod': 2, 'data': 2, 'model': 2} params=0.8M "
        "tp=replicated (ROADMAP 7b-ii)"]
    assert len([ln for ln in lines if ln.startswith("step ")]) == 1
