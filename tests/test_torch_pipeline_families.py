"""The port's cross-pod pipeline for the other branches of
``build_pipeline_parts``, each in f32 on a (pod 2, data 1, model 1) mesh of
two ``gloo`` CPU processes, its loss and every gradient against
``jax.value_and_grad`` of the reference's microbatch mean: RWKV-6 smoke, the
pure Mamba2 stack (Zamba2 smoke with family "ssm"), HuBERT smoke (a batch of
frame ``embeds`` with labels and a mask) and Qwen2-VL smoke (``embeds`` with
(3, B, T) M-RoPE positions, which the pipeline slices on dim 1 and runs under
the masked plain attention, as ``Model.loss`` does)."""
import pytest

from torch_pipeline_helpers import hold_against_reference, pipeline_case

# f32: the same arithmetic in another framework and order of sums; the loss
# and each gradient leaf within 2e-5 (atol = 2e-5 max|ref leaf|)
REF_TOL = 2e-5

CASES = [pytest.param("rwkv6_7b", {}, id="rwkv6_7b"),
         pytest.param("zamba2_2p7b", {"family": "ssm"}, id="ssm"),
         pytest.param("hubert_xlarge", {}, id="hubert_xlarge"),
         pytest.param("qwen2_vl_7b", {}, id="qwen2_vl_7b")]


@pytest.mark.parametrize("arch,replace", CASES)
def test_loss_and_gradients_match_the_reference(tmp_path, arch, replace):
    case = pipeline_case(tmp_path, arch, (2, 1, 1), ("striped",), **replace)
    hold_against_reference(case["results"], case["ref"], "layers", "striped", REF_TOL)
