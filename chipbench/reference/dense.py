"""Plain reference of the dense decoder (GPT-A): pre-norm blocks of RMSNorm,
multi-head attention with rotary embeddings (rotate-half, theta from the
configuration) causal over the sequence, and a GELU (tanh form) FFN, each
with its residual; a final RMSNorm and an untied head.  float32 throughout,
attention in query blocks, one layer at a time.  The layout is the program's
(the keys of its parameter dict), so both sides are handed the same leaves."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from chipbench.reference.common import Precision, checkpointed, next_token_nll_sum, rmsnorm, rope

Q_BLOCK = 1024  # queries a block of the attention


def layout(m: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], tuple]]:
    L, d, H, hd, f, V = m["num_layers"], m["d_model"], m["num_heads"], m["head_dim"], m["d_ff"], m["vocab_size"]
    return [
        (("layers", "ln1"), (L, d), ("const", 1.0)),
        (("layers", "ln2"), (L, d), ("const", 1.0)),
        (("layers", "attn", "wq"), (L, d, H * hd), ("fan_in", 1.0)),
        (("layers", "attn", "wk"), (L, d, H * hd), ("fan_in", 1.0)),
        (("layers", "attn", "wv"), (L, d, H * hd), ("fan_in", 1.0)),
        (("layers", "attn", "wo"), (L, H * hd, d), ("fan_in", 1.0)),
        (("layers", "ffn", "w_up"), (L, d, f), ("fan_in", 1.0)),
        (("layers", "ffn", "w_down"), (L, f, d), ("fan_in", 1.0)),
        (("embed",), (V, d), ("normal", 0.02)),
        (("final_norm",), (d,), ("const", 1.0)),
        (("lm_head",), (d, V), ("normal", 0.02)),
    ]


def layer_flops(m: Dict[str, Any], n: int) -> float:
    """One layer's forward operations over a sequence of n tokens: 2 n (4 d H D
    + 2 d f) for the projections and the FFN, and 4 H D for each (query, key)
    pair that causal attention keeps, n (n + 1) / 2 of them."""
    d, f, H, D = m["d_model"], m["d_ff"], m["num_heads"], m["head_dim"]
    return 2 * n * (4 * d * H * D + 2 * d * f) + 4 * H * D * (n * (n + 1) // 2)


F32_LEAVES = ("ln1", "ln2", "final_norm")  # the leaves a served model keeps in float32


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention, (B, T, H, D) each, in query blocks."""
    B, T, H, D = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, D)
    out = []
    for t0 in range(0, T, Q_BLOCK):
        t1 = min(t0 + Q_BLOCK, T)
        s = q[:, :, t0:t1] @ k[:, :, :t1].transpose(-1, -2) * D**-0.5
        keep = torch.arange(t1, device=q.device)[None, :] <= torch.arange(t0, t1, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        out.append(torch.softmax(s, -1) @ v[:, :, :t1])
    return torch.cat(out, 2).transpose(1, 2).reshape(B, T, H * D)


def _block(m: Dict[str, Any], prec: Precision, lp: Dict[str, torch.Tensor], x: torch.Tensor,
           probe: Optional[torch.Tensor] = None):
    """One block; with ``probe`` (H*D, P) also the K and V of the layer
    projected on it, (T, P) each for the batch's one row."""
    B, T, _ = x.shape
    H, hd = m["num_heads"], m["head_dim"]
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    h = rmsnorm(x, lp["ln1"])
    q = rope(prec.mm(h, lp["wq"]).view(B, T, H, hd), pos, m["rope_theta"])
    k = rope(prec.mm(h, lp["wk"]).view(B, T, H, hd), pos, m["rope_theta"])
    v = prec.mm(h, lp["wv"]).view(B, T, H, hd)
    x = x + prec.mm(_attention(q, k, v), lp["wo"])
    h = rmsnorm(x, lp["ln2"])
    x = x + prec.mm(F.gelu(prec.mm(h, lp["w_up"]), approximate="tanh"), lp["w_down"])
    if probe is None:
        return x
    return x, (k.reshape(T, H * hd) @ probe, v.reshape(T, H * hd) @ probe)


def _layer(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    layers = params["layers"]
    return {"ln1": layers["ln1"][i], "ln2": layers["ln2"][i], **{k: w[i] for k, w in layers["attn"].items()},
            **{k: w[i] for k, w in layers["ffn"].items()}}


def loss(m: Dict[str, Any], prec: Precision, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy of tokens (B, T); each layer's
    activations recomputed in the backward."""
    x = params["embed"][tokens.long()]
    for i in range(m["num_layers"]):
        x = checkpointed(lambda lp, h: _block(m, prec, lp, h), _layer(params, i), x)
    x = rmsnorm(x, params["final_norm"])
    B, T = tokens.shape
    return next_token_nll_sum(x, params["lm_head"], tokens, prec) / (B * (T - 1))


@torch.no_grad()
def prefill(m: Dict[str, Any], prec: Precision, params: Dict[str, Any], tokens: torch.Tensor,
            probe: torch.Tensor, all_logits: bool = False):
    """One prompt (T,) through the model.  Returns (logits (T or 1, V), the
    probed K and V of every layer ((L, T, P) each)).  Weights of any dtype
    are taken to float32 a layer at a time."""
    x = params["embed"][tokens.long()][None].float()
    ks, vs = [], []
    for i in range(m["num_layers"]):
        lp = {k: w.float() for k, w in _layer(params, i).items()}
        x, (kp, vp) = _block(m, prec, lp, x, probe)
        ks.append(kp)
        vs.append(vp)
    x = rmsnorm(x[0] if all_logits else x[0, -1:], params["final_norm"])
    return prec.mm(x, params["lm_head"]), torch.stack(ks), torch.stack(vs)
