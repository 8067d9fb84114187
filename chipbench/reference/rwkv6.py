"""Plain reference of RWKV-6 "Finch" (arXiv:2404.05892) as the program
defines its block: RMSNorm (one scale for both halves of a block), token
shifts by learned lerps, receptance, key, value and a SiLU gate, the decay
w_t = exp(-exp(w0 + tanh(x W_a) W_b)) per key channel, the recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),

then the output projection; the channel mix relu(x W_k)^2 W_v * sigmoid(x
W_r).  Departures from the paper, which the program makes too: RMSNorm in
place of LayerNorm, no group norm on y, the LoRA on the decay only.  float32;
the recurrence in chunks of 16 steps, one layer at a time."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from chipbench.reference.common import Precision, checkpointed, next_token_nll_sum, rmsnorm

CHUNK = 16  # steps a chunk of the recurrence
MAX_DECAY = 60.0  # the most log decay a chunk may take: e^60 is far inside float32


def layout(m: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], tuple]]:
    L, d, f, V, hd = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"], m["rwkv"]["head_dim"]
    H, lora = d // hd, m["decay_lora_rank"]
    out = [(("layers", f"mu_{n}"), (L, d), ("uniform", 0.0, 1.0)) for n in ("r", "k", "v", "w", "g")]
    out += [(("layers", n), (L, d, d), ("fan_in", 1.0)) for n in ("wr", "wk", "wv", "wg", "wo")]
    out += [
        (("layers", "w0"), (L, d), ("uniform", -5.0, -0.5)),
        (("layers", "w_lora_a"), (L, d, lora), ("fan_in", 1.0)),
        (("layers", "w_lora_b"), (L, lora, d), ("fan_in", 0.1)),
        (("layers", "u"), (L, H, hd), ("normal", 0.3)),
        (("layers", "ln_scale"), (L, d), ("const", 1.0)),
        (("layers", "mu_ck"), (L, d), ("uniform", 0.0, 1.0)),
        (("layers", "ck"), (L, d, f), ("fan_in", 1.0)),
        (("layers", "cv"), (L, f, d), ("fan_in", 1.0)),
        (("layers", "cr"), (L, d, d), ("fan_in", 1.0)),
        (("embed",), (V, d), ("normal", 0.02)),
        (("final_norm",), (d,), ("const", 1.0)),
        (("lm_head",), (d, V), ("normal", 0.02)),
    ]
    return out


def layer_flops(m: Dict[str, Any], n: int) -> float:
    """One layer's forward operations over n tokens: 2 (6 d^2 + 2 d R + 2 d f)
    a token for the time mix's five products, the decay's LoRA of rank R and
    the channel mix's three; the recurrence 5 D^2 + 5 D a head and token (the
    state's decay and update, the output's product with it, the bonus)."""
    d, f, D, R = m["d_model"], m["d_ff"], m["rwkv"]["head_dim"], m["decay_lora_rank"]
    return n * (2 * (6 * d * d + 2 * d * R + 2 * d * f) + d // D * (5 * D * D + 5 * D))


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y (B, T, H, D) of the recurrence from a zero state; T a multiple of CHUNK."""
    B, T, H, D = r.shape
    n = T // CHUNK

    def chunks(a):  # (B, H, n, C, D)
        return a.reshape(B, n, CHUNK, H, D).permute(0, 3, 1, 2, 4)

    r, k, v, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    inc = lw.cumsum(3)  # log decay through step t of the chunk
    exc = inc - lw  # ... before step t
    if float(-inc[..., -1, :].detach().min()) > MAX_DECAY:
        raise ValueError("wkv: a chunk decays past e^-60; its split exponentials would lose float32's range")
    # within a chunk: y_t += sum_{s<t} (sum_d r_t e^{exc_t} k_s e^{-inc_s}) v_s, the exponent split in two
    rd = r * torch.exp(exc)
    a = rd @ (k * torch.exp(-inc)).transpose(-1, -2)
    a = a * torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device), diagonal=-1)
    y = a @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    # across chunks: chunk j adds `add_j` to the state at its end; the state before chunk i is the sum over
    # j < i of add_j decayed from the end of chunk j to the end of chunk i - 1, all pairs at once (no loop
    # over the chunks), the log decays summed in float64 so that their differences keep float32's precision
    add = torch.einsum("bhnsd,bhnse->bhnde", k * torch.exp(inc[..., -1:, :] - inc), v)
    ends = inc[..., -1, :].double().cumsum(2)  # (B, H, n, D)
    starts = F.pad(ends, (0, 0, 1, 0))[:, :, :-1]
    gap = (starts[:, :, :, None] - ends[:, :, None]).float()  # (B, H, i, j, D)
    later = torch.tril(torch.ones(n, n, dtype=torch.bool, device=r.device), diagonal=-1)[:, :, None]
    S = torch.einsum("bhijd,bhjde->bhide", torch.exp(gap.masked_fill(~later, float("-inf"))), add)
    y = y + rd @ S
    return y.permute(0, 2, 3, 1, 4).reshape(B, T, H, D)


def _block(m: Dict[str, Any], prec: Precision, lp: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    B, T, d = x.shape
    hd = m["rwkv"]["head_dim"]
    H = d // hd

    def lerp(xn, mu):
        prev = F.pad(xn[:, :-1], (0, 0, 1, 0))
        return xn * mu + prev * (1 - mu)

    xn = rmsnorm(x, lp["ln_scale"])
    r = prec.mm(lerp(xn, lp["mu_r"]), lp["wr"]).view(B, T, H, hd)
    k = prec.mm(lerp(xn, lp["mu_k"]), lp["wk"]).view(B, T, H, hd)
    v = prec.mm(lerp(xn, lp["mu_v"]), lp["wv"]).view(B, T, H, hd)
    g = F.silu(prec.mm(lerp(xn, lp["mu_g"]), lp["wg"]))
    lora = torch.tanh(prec.mm(lerp(xn, lp["mu_w"]), lp["w_lora_a"]))
    logw = -torch.exp(lp["w0"] + prec.mm(lora, lp["w_lora_b"])).view(B, T, H, hd)
    y = wkv(r, k, v, logw, lp["u"]).reshape(B, T, d)
    x = x + prec.mm(y * g, lp["wo"])
    xk = lerp(rmsnorm(x, lp["ln_scale"]), lp["mu_ck"])
    return x + prec.mm(torch.relu(prec.mm(xk, lp["ck"])).square(), lp["cv"]) * torch.sigmoid(prec.mm(xk, lp["cr"]))


def loss(m: Dict[str, Any], prec: Precision, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy of tokens (B, T); each layer's
    activations recomputed in the backward."""
    x = params["embed"][tokens.long()]
    layers = params["layers"]
    for i in range(m["num_layers"]):
        lp = {key: w[i] for key, w in layers.items()}
        x = checkpointed(lambda p, h: _block(m, prec, p, h), lp, x)
    x = rmsnorm(x, params["final_norm"])
    B, T = tokens.shape
    return next_token_nll_sum(x, params["lm_head"], tokens, prec) / (B * (T - 1))
