"""The plan of the decode kernel's design, held on the CPU.

``csrc/decode_attention.cu`` cuts the ring into tiles of 64 slots, gives slice
s of ``split_plan`` the tiles s, s + nsplit, ... (round robin), marks each
tile's valid slots by the value of ``kv_pos`` and skips a tile with none, keeps
a running (m, l, acc) a slice with m starting at -inf, writes the marker
(-inf, 0, 0) for a slice that read nothing, and merges the slices, taking the
mean of V over the S slots for a row whose every slice wrote the marker.
``split_order`` below repeats that plan in plain torch; on inputs made with
numpy from a seed it must agree in f32 with the port's plain version, the JAX
reference and the Pallas kernel in interpret mode, so that a case that fails on
the card points to a fault in the kernel and not to its plan.

With ``lanes`` it also repeats the kernel's lane plan (``Layout``): a slot's
16-byte vectors of K and V on D / V lanes rounded up to a power of two (at
head size 80, 16 lanes in bf16 and 32 in f32), the lanes past D / V holding
zeros; a score summed over its lanes by xor shuffles; each warp's P V summed
on its own lanes, then over a warp's slots by xor shuffles and over the warps
in order.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels.decode_attention import (
    BLOCKS_PER_SM, MAX_TILES_PER_SPLIT, MIN_TILES_PER_SPLIT, NEG_INF, TILE, decode_attention_plain, split_plan)
from torch_helpers import F32_TOL, as_f32

SM_COUNT = 132  # an H100's SMs
NT, NW, SLOTS_W = 128, 4, 16  # csrc/decode_attention.cu: threads and warps a block, slots of a tile a warp owns


def lane_plan(D: int, elem_bytes: int) -> tuple:
    """(V, VPR, LPR, SPW) of ``Layout<T, D, GC>``: elements of a 16-byte vector,
    vectors a row, lanes a slot (VPR rounded up to a power of two), slots a
    warp step."""
    V = 16 // elem_bytes
    VPR = D // V
    LPR = 1 << (VPR - 1).bit_length()
    return V, VPR, LPR, 32 // LPR


def _lanes(x, plan):
    """(..., D) -> (..., LPR, V): lane c holds vector c, the lanes past VPR zeros."""
    V, _, LPR, _ = plan
    return F.pad(x, (0, LPR * V - x.shape[-1])).reshape(*x.shape[:-1], LPR, V)


def _xor_sum(x, lanes: int, offsets):
    """x (..., lanes, V) after the shuffles ``x += x[lane ^ off]``, off in ``offsets``."""
    lane = torch.arange(lanes)
    for off in offsets:
        x = x + x[..., lane ^ off, :]
    return x


def lane_scores(qg, k_tile, plan):
    """qg (G, D) scaled, k_tile (TILE, D) -> (G, TILE): each lane's vector product,
    then the sum over the slot's lanes by xor shuffles (LPR / 2 down to 1)."""
    _, _, LPR, _ = plan
    part = (_lanes(qg, plan)[:, None] * _lanes(k_tile, plan)[None]).sum(-1)[..., None]  # (G, TILE, LPR, 1)
    halving = [LPR >> i for i in range(1, LPR.bit_length())]  # LPR / 2, ..., 1
    return _xor_sum(part, LPR, halving)[..., 0, 0]


def lane_pv(accw, p, v_tile, plan):
    """accw (G, NW, 32, V): each warp's lanes' running P V; the warp's steps of
    SPW slots, lane (r, c) adding p of slot j times vector c of V's row j."""
    V, _, LPR, SPW = plan
    G = accw.shape[0]
    vl = _lanes(v_tile, plan)  # (TILE, LPR, V)
    for w in range(NW):
        for step in range(SLOTS_W // SPW):
            js = w * SLOTS_W + step * SPW + torch.arange(SPW)
            upd = (p[:, js, None, None] * vl[js][None]).reshape(G, SPW * LPR, V)
            accw[:, w] = accw[:, w] + upd
    return accw


def lane_acc(accw, plan, D):
    """The end of a slice: each warp's lanes summed over its slots (xor shuffles,
    off LPR up to 16), the lanes of slot 0 stored, the warps summed in order."""
    _, VPR, LPR, _ = plan
    doubling = [LPR << i for i in range((32 // LPR).bit_length() - 1)]  # LPR, 2 LPR, ..., 16
    red = _xor_sum(accw, 32, doubling)[:, :, :VPR].reshape(accw.shape[0], NW, -1)[..., :D]  # (G, NW, D)
    out = red[:, 0]
    for w in range(1, NW):
        out = out + red[:, w]
    return out


def split_order(q, k, v, q_pos, kv_pos, *, window=None, sm_count=SM_COUNT, skip=True, lanes=None):
    """q (B, 1, Hq, D), k and v (B, S, Hkv, D), q_pos (B, 1), kv_pos (B, S) ->
    (o (B, 1, Hq, D) f32, counts), in the kernel's order.  ``skip=False``
    reads every tile, as the design before tile skipping did; ``lanes`` (the
    element size in bytes, 2 or 4) follows the lane plan of that type."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nsplit, per = split_plan(B, Hkv, S, sm_count)
    ntiles = -(-S // TILE)
    pad = ntiles * TILE - S
    qf = q[:, 0].float() * D**-0.5  # scaled first, then multiplied
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))  # rows past S are zeros, as cp.async's zero fill
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    pos = F.pad(kv_pos, (0, pad), value=-1)
    past_s = torch.arange(ntiles * TILE) >= S
    part_m = torch.full((nsplit, B, Hq), -math.inf)
    part_l = torch.zeros((nsplit, B, Hq))
    part_acc = torch.zeros((nsplit, B, Hq, D))
    counts = {"tiles_read": 0, "tiles_skipped": 0, "markers": 0}
    for split in range(nsplit):
        tiles = range(split, ntiles, nsplit)  # round robin
        for b in range(B):
            qp = int(q_pos[b, 0])
            for kvh in range(Hkv):
                hs = slice(kvh * G, kvh * G + G)
                m = torch.full((G,), -math.inf)
                l = torch.zeros(G)
                acc = torch.zeros((G, D))
                plan = lane_plan(D, lanes) if lanes else None
                accw = torch.zeros((G, NW, 32, plan[0])) if lanes else None
                for t in tiles:
                    sl = slice(t * TILE, (t + 1) * TILE)
                    p_ = pos[b, sl]
                    valid = (p_ >= 0) & (p_ <= qp)
                    if window:
                        valid &= p_ > qp - window
                    if skip and not bool(valid.any()):
                        counts["tiles_skipped"] += 1
                        continue
                    counts["tiles_read"] += 1
                    s = lane_scores(qf[b, hs], kf[b, sl, kvh], plan) if lanes else qf[b, hs] @ kf[b, sl, kvh].T
                    masked = torch.where(past_s[sl], -math.inf, NEG_INF)
                    s = torch.where(valid, s, masked)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    if lanes:
                        accw = lane_pv(accw * alpha[:, None, None, None], p, vf[b, sl, kvh], plan)
                    else:
                        acc = acc * alpha[:, None] + p @ vf[b, sl, kvh]
                    m = m_new
                if lanes:
                    acc = lane_acc(accw, plan, D)
                counts["markers"] += int(bool(torch.isneginf(m).all()))
                part_m[split, b, hs], part_l[split, b, hs], part_acc[split, b, hs] = m, l, acc
    return merge(part_acc, part_m, part_l, v, G), counts


def merge(part_acc, part_m, part_l, v, G):
    """The merge kernel: a row whose every slice wrote the marker gets the mean
    of V over its S slots; the test for -inf comes before any weight."""
    m = part_m.amax(0)  # (B, Hq)
    none = torch.isneginf(m)
    w = torch.exp(part_m - torch.where(none, 0.0, m))
    l = (part_l * w).sum(0)
    acc = (part_acc * w[..., None]).sum(0)
    o = acc / torch.where(none, 1.0, l)[..., None]
    mean_v = v.float().mean(1).repeat_interleave(G, dim=1)  # head h reads kv head h // G
    return torch.where(none[..., None], mean_v, o)[:, None]


def positions(rng, B, S, kind):
    """kv_pos (B, S) and q_pos (B, 1), int32."""
    ar = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if kind == "tail-empty":  # a ring not yet full: 520 of 1024 slots, the tail empty
        filled = S * 65 // 128
        return np.where(ar < filled, ar, -1).astype(np.int32), np.full((B, 1), filled - 1, np.int32)
    if kind == "shuffled":  # a ring that has wrapped: positions in any slot order, some empty
        kv = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32) + 100
        kv[kv % 7 == 3] = -1
        return kv, np.full((B, 1), 100 + (2 * S) // 3, np.int32)
    if kind == "gaps":  # whole empty tiles between valid ones
        kv = ar.copy()
        tile = kv // TILE
        kv[((tile >= 2) & (tile < 6)) | ((tile >= 9) & (tile < 13))] = -1
        return kv, np.full((B, 1), S - 1, np.int32)
    if kind == "one-valid":  # one valid slot a row: slot 0, and a slot in the middle
        kv = np.full((B, S), -1, np.int32)
        kv[0, 0] = 0
        kv[1:, S // 2 + 3] = 7
        return kv, np.full((B, 1), 7, np.int32)
    if kind == "no-valid":  # row 0 all empty, row 1 all in the future, the rest ordinary
        kv = ar.copy()
        kv[0] = -1
        kv[1] += 10_000
        return kv, np.full((B, 1), S // 2, np.int32)
    if kind == "full":  # every slot filled, the query at the newest
        return ar, np.full((B, 1), S - 1, np.int32)
    raise ValueError(kind)


def multi_tile_s(B, Hkv, sm_count=SM_COUNT):
    """A ring long enough that the plan gives its slices two tiles or more."""
    nsplit = max(1, sm_count * BLOCKS_PER_SM // (B * Hkv))
    return TILE * 8 * -(-(2 * nsplit + 1) // 8)


CASES = {  # (B, S, Hq, Hkv, D, window, kind, sm_count, block_kv of the Pallas kernel)
    "tail-empty": (2, 1024, 4, 2, 32, None, "tail-empty", 7, 256),
    "shuffled": (2, 1024, 4, 2, 32, None, "shuffled", 7, 256),
    "empty-tiles-between": (2, 1024, 4, 2, 32, None, "gaps", 7, 256),
    "one-valid-slot": (2, 1024, 4, 2, 32, None, "one-valid", 7, 256),
    "no-valid-rows": (3, 1024, 4, 2, 32, None, "no-valid", 7, 256),
    "window-empties-leading-tiles": (2, 1024, 4, 2, 32, 300, "full", 7, 256),
    "gqa-group-4": (2, 1024, 8, 2, 64, None, "shuffled", 7, 256),
    "ragged-s": (2, 1000, 6, 3, 32, 300, "shuffled", 7, 200),
    "multi-tile-h100-plan": (2, multi_tile_s(2, 4), 16, 4, 32, None, "tail-empty", SM_COUNT, 512),
    # head size 80 (Zamba2-2.7B's shared block), the kinds above
    "head-80-tail-empty": (2, 1024, 4, 2, 80, None, "tail-empty", 7, 256),
    "head-80-shuffled-ragged-window": (2, 1000, 6, 3, 80, 300, "shuffled", 7, 200),
    "head-80-gaps": (2, 1024, 4, 2, 80, None, "gaps", 7, 256),
    "head-80-no-valid-rows": (3, 1024, 4, 2, 80, None, "no-valid", 7, 256),
    "head-80-group-4": (2, 1024, 8, 2, 80, None, "one-valid", 7, 256),
}


@pytest.mark.parametrize("name", list(CASES))
def test_split_order_matches_plain_reference_and_pallas(name):
    B, S, Hq, Hkv, D, window, kind, sm_count, block_kv = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    kv_pos, q_pos = positions(rng, B, S, kind)
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    nsplit, per = split_plan(B, Hkv, S, sm_count)
    assert nsplit > 1 and per > 1, (nsplit, per)  # several slices of several tiles each
    got, counts = split_order(*args, window=window, sm_count=sm_count)
    plain = decode_attention_plain(*args, window=window)
    jargs = [jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)]
    reference = ref_ref.decode_attention_ref(*jargs, window=window)
    pallas = ref_ops.decode_attention(*jargs, window=window, block_kv=block_kv)
    for want in (plain, reference, pallas):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **F32_TOL)
    # the plan read exactly the tiles with a valid slot, each once
    pos = np.pad(kv_pos, ((0, 0), (0, -S % TILE)), constant_values=-1).reshape(B, -1, TILE)
    ok = (pos >= 0) & (pos <= q_pos[:, :, None])
    if window:
        ok &= pos > q_pos[:, :, None] - window
    with_valid = int(ok.any(-1).sum()) * Hkv
    assert counts["tiles_read"] == with_valid
    assert counts["tiles_read"] + counts["tiles_skipped"] == B * Hkv * -(-S // TILE)


def test_split_order_without_a_valid_slot_writes_markers_and_takes_the_mean():
    B, S, Hq, Hkv, D, _, kind, sm_count, _ = CASES["no-valid-rows"]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kv_pos, q_pos = positions(rng, B, S, kind)
    got, counts = split_order(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), sm_count=sm_count)
    nsplit, _ = split_plan(B, Hkv, S, sm_count)
    assert counts["markers"] >= 2 * Hkv * nsplit  # rows 0 and 1: every slice, every kv head
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), Hq // Hkv, axis=2)
    np.testing.assert_allclose(as_f32(got)[:2], mean_v[:2], **F32_TOL)
    assert np.isfinite(as_f32(got)).all()


@pytest.mark.parametrize("name", ["tail-empty", "empty-tiles-between", "one-valid-slot",
                                  "window-empties-leading-tiles", "multi-tile-h100-plan"])
def test_skipping_empty_tiles_is_exact(name):
    """Where a row has a valid slot, skipping the tiles without one changes no
    bit: exp(NEG_INF - m) is exactly 0 once m is a real score."""
    B, S, Hq, Hkv, D, window, kind, sm_count, _ = CASES[name]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kv_pos, q_pos = positions(rng, B, S, kind)
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    skipped, c_skip = split_order(*args, window=window, sm_count=sm_count)
    read_all, c_all = split_order(*args, window=window, sm_count=sm_count, skip=False)
    assert c_skip["tiles_skipped"] > 0 and c_all["tiles_skipped"] == 0
    assert torch.equal(skipped, read_all)


@pytest.mark.parametrize("sm_count", [1, 3, 132])
@pytest.mark.parametrize("B,Hkv,S", [(4, 32, 1024), (1, 1, 1), (1, 8, 1000), (64, 32, 8192), (3, 2, 65),
                                     (4, 32, 4096), (2, 4, 4096), (1, 1, 65536), (64, 32, 65536)])
def test_plan_assigns_every_tile_to_exactly_one_slice(B, Hkv, S, sm_count):
    nsplit, per = split_plan(B, Hkv, S, sm_count)
    ntiles = -(-S // TILE)
    slices = [list(range(s, ntiles, nsplit)) for s in range(nsplit)]
    assert sorted(t for sl in slices for t in sl) == list(range(ntiles))
    assert all(1 <= len(sl) <= per <= MAX_TILES_PER_SPLIT for sl in slices)
    assert max(len(sl) for sl in slices) == per >= min(ntiles, MIN_TILES_PER_SPLIT)
    # a valid prefix of any length spreads evenly: no slice holds more than its share
    for filled in (1, ntiles // 3, ntiles // 2 + 1, ntiles):
        if filled:
            assert max(sum(t < filled for t in sl) for sl in slices) == -(-filled // nsplit)


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_lane_plan_covers_every_element_once(D, elem_bytes):
    """Layout's plan: the block's 16-byte copies cover a tile once, and the
    warps' lanes cover each (slot, vector) of a tile once, the lanes past the
    row's vectors reading nothing; a slot's lanes are an aligned power-of-two
    group, so the xor shuffles stay inside it."""
    V, VPR, LPR, SPW = lane_plan(D, elem_bytes)
    assert D % V == 0 and VPR <= LPR <= 32 and LPR & (LPR - 1) == 0 and SLOTS_W % SPW == 0
    assert (TILE * VPR) % NT == 0
    copies = [(idx // VPR, (idx % VPR) * V) for u in range(TILE * VPR // NT) for idx in range(u * NT, (u + 1) * NT)]
    assert sorted(copies) == [(row, col) for row in range(TILE) for col in range(0, D, V)]
    reads = []
    for w in range(NW):
        for step in range(SLOTS_W // SPW):
            for lane in range(32):
                r, c = lane // LPR, lane % LPR
                if c < VPR:
                    reads.append((w * SLOTS_W + step * SPW + r, c))
    assert sorted(reads) == [(j, c) for j in range(TILE) for c in range(VPR)]
    if D == 80:  # the new plans: bf16 two slots of 16 lanes (6 idle), f32 one slot of 32 (12 idle)
        assert (LPR, SPW) == ((16, 2) if elem_bytes == 2 else (32, 1))


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("head-80")] + ["tail-empty"])
def test_lane_order_matches_plain_reference_and_pallas(name, elem_bytes):
    """The split plan with the kernel's lanes at head size 80 (and 32), in f32
    arithmetic on the plan of each element size, against the port's plain
    version, the JAX reference and the Pallas kernel in interpret mode."""
    B, S, Hq, Hkv, D, window, kind, sm_count, block_kv = CASES[name]
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    kv_pos, q_pos = positions(rng, B, S, kind)
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    got, _ = split_order(*args, window=window, sm_count=sm_count, lanes=elem_bytes)
    plain = decode_attention_plain(*args, window=window)
    jargs = [jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)]
    reference = ref_ref.decode_attention_ref(*jargs, window=window)
    pallas = ref_ops.decode_attention(*jargs, window=window, block_kv=block_kv)
    for want in (plain, reference, pallas):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **F32_TOL)
