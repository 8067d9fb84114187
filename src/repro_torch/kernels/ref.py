"""The kernels' plain PyTorch versions under the reference's names
(``repro/kernels/ref.py``): the ground truth the kernels are held against."""
from repro_torch.kernels.decode_attention import NEG_INF, decode_attention_plain as decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_plain as flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_plain as rmsnorm_ref
from repro_torch.kernels.wkv6 import wkv6_plain


def wkv6_ref(r, k, v, logw, u):
    """y of the recurrence from a zero state, the reference's signature."""
    return wkv6_plain(r, k, v, logw, u)[0]


__all__ = ["NEG_INF", "decode_attention_ref", "flash_attention_ref", "rmsnorm_ref", "wkv6_ref"]
