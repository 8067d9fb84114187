"""The dry-run: deliverable (e) of the reference (``repro/launch/dryrun.py``)
for the port.

For every (architecture x input shape x production mesh) combination it runs
one rank's share of the program the port itself would run on that mesh, on
``torch.device("meta")``, under three counters, and writes what a device
holds, what it computes, what crosses the pod boundary and which roofline term
binds.  Nothing is allocated and nothing is computed: a ``meta`` tensor has a
shape, a dtype and a storage identity, and no data.  The reference lowers and
compiles an XLA program on 512 emulated devices instead; its numbers are TPU
v5e constants and are not carried over.

The programs (``ARCHS[:10]`` x ``SHAPES`` x single (16, 16) / multi (2, 16, 16)):
  * multi x train: ``PipelineLoss`` (n_micro 4, ``--boundary``) and the
    port's AdamW update (``make_train_step``) on a rank of each distinct
    ``pod`` coordinate (stage 0 and stage 1), through a ``MetaTransport``;
    ``model`` ranks are replicas, as the port runs them.  Each figure is the
    larger of the two stages'; each stage's figures are under ``stages``.
  * single x train: the port's plain data-parallel step (``DataParallelLoss``
    and the AdamW update) on one rank of the (16, 16) mesh: its ``data``
    share of the global batch, the whole model's f32 state (the ``model``
    ranks are replicas), and the gradients' all-reduce over ``data`` through a
    ``MetaTransport``.
  * prefill / decode: the port has no tensor-parallel serving, so each rank
    serves a whole replica (the weights in ``cfg.dtype``, as the serving
    engine holds them) on its share of the global batch, ceil(B / ranks) rows
    (a rank with none is idle): ``"program": "replica"``.  The audio encoder's
    prefill runs ``Model.loss``; a decode is one ``decode_step`` on the cache
    of ``cache_shape(B_rank, S)``.

The counters (``count``):
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` for the aten ops
    (matrix products and convolutions) plus the operations the kernels'
    ``meta`` wrappers record (``kernels/cost.py``; the formulas of
    ``chip_smoke.py``'s bounds).  In place of ``cost_analysis()["flops"]``.
  * Bytes accessed: over aten ops, the bytes of each tensor input read and
    each output written (views and allocations 0), plus the kernels' recorded
    bytes: the eager port's HBM traffic, in place of XLA's "bytes accessed".
  * Live bytes: a ``TorchDispatchMode`` that tracks live storages by storage
    identity (so that views, in-place ops and tensors saved for backward count
    once, and a storage counts until its last reference goes), each rounded up
    to the CUDA caching allocator's 512 bytes.  ``argument_bytes`` is the
    unrounded bytes of the rank's parameters, optimizer moments, batch and
    cache; ``peak_bytes`` the most live at any op's end.  In place of
    ``memory_analysis()``.  cuBLAS's workspace is not a tensor of the program
    and is not counted here.

The JSON keeps the reference's keys, so that the roofline and the report read
both packages' files.  ``collectives.by_axis`` is the transport's own count
(the bytes of the tensor a rank hands to a call, ``Transport._count``);
``collectives.{ici, dcn, by_op}`` count an all-reduce twice (a ring's
reduce-scatter and all-gather, as the reference's HLO count does) and sends as
``collective-permute``; ``dcn`` is the ``pod`` axis.  ``plan_bytes_per_device``
is beside them: the f32 parameters a device would hold under the placement plan
(``make_param_shardings``: fsdp by default for train shapes, ``--no-fsdp``,
``--relayout``'s head-aligned (256 / tp, tp) mesh), which the port does not yet
execute (ROADMAP 7b); ``--no-fsdp`` and ``--relayout`` change only that number.

The roofline's seconds are at one H100 SXM's published peaks at 700 W
(``kernels/cost.py``: 989e12 FLOP/s bf16, 3.35e12 B/s HBM); a collective is
priced per axis (``axis_bandwidth``).  ``compute_s`` is the reference's
analytic MODEL_FLOPS a device over the peak, ``compute_s_hlo`` the counted
FLOPs over it.  None of these seconds is measured.

Two of the reference's float literals, 6.0 (MODEL_FLOPS) and 2e8
(``wan_projection``), are written here as ints made floats, with the same
value and arithmetic.  Hypothesis biases its draws with every float literal of
the loaded modules, and a test worker that has loaded this module must draw in
``tests/test_torch_sim_simulator.py`` what it drew before the module existed;
``tests/test_torch_dryrun_hygiene.py`` holds the port's modules to that.

  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k --mesh multi --boundary striped
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, canon
from repro_torch.convert import flatten
from repro_torch.kernels import cost as kcost
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.parallel.data_parallel import DataParallelLoss
from repro_torch.parallel.pipeline import PipelineLoss, stage_params
from repro_torch.parallel.sharding import make_param_shardings
from repro_torch.parallel.transport import MetaTransport
from repro_torch.serving.engine import zeros_cache

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "local", "torch_dryrun")

# one H100 SXM at its 700 W limit, NVIDIA's published dense peaks (kernels/cost.py)
PEAK_FLOPS = kcost.BF16_FLOPS  # 989e12 FLOP/s bf16 on the tensor cores
HBM_BW = kcost.HBM_BYTES_PER_S  # 3.35e12 B/s
# NVLink 4 on an H100 SXM: 900 GB/s in all, 450e9 B/s each way (NVIDIA H100 data sheet)
NVLINK_BW = 450e9
# one 400 Gb/s ConnectX-7 NIC a GPU, as in a DGX H100 (NVIDIA DGX H100 user guide): 50e9 B/s
NIC_BW = 50e9
NODE_GPUS = 8  # GPUs of one node joined by NVLink (DGX H100 / HGX H100 8-GPU)
DEVICE_BYTES = 80 * 2**30  # an H100 80GB's HBM3
ALLOC_ROUND = 512  # the CUDA caching allocator rounds every block up to a multiple of 512 bytes
N_MICRO = 4
# aten ops that allocate and write nothing: no traffic
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
# aten ops that make a tensor of zeros (the start of an indexing op's backward)
_ZEROS = {"zeros", "zeros_like", "new_zeros"}


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------


def _moves_bytes(func) -> bool:
    """Whether an aten op reads and writes memory: not a view (an output
    aliasing an input without writing it) and not a bare allocation."""
    view = any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
    return not view and func.overloadpacket.__name__ not in _NO_TRAFFIC


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def argument_bytes(tree, rounded: bool = False) -> int:
    """The bytes of the distinct storages that the tensors of ``tree`` hold
    (a storage shared by two leaves once), each rounded up to ALLOC_ROUND
    with ``rounded``: on ``meta`` by storage identity, elsewhere by address,
    so that a tree of card tensors and its ``meta`` counterpart give the same
    number."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        key = st._cdata if t.device.type == "meta" else st.data_ptr()
        if key not in seen:
            seen.add(key)
            total += _rounded(st.nbytes()) if rounded else st.nbytes()
    return total


class LiveBytes(TorchDispatchMode):
    """Counts every aten op's traffic and tracks live storages.

    ``bytes_accessed``: each non-view op's tensor inputs' and outputs' bytes.
    ``current`` / ``peak``: the live storages' bytes, each rounded up to
    ALLOC_ROUND, a storage counted from the op that made it until its last
    reference goes (a weak reference's finalizer), at each op's end.
    ``track`` adds storages made before the mode (the arguments).

    Any dispatch mode makes autograd take the functional form of an
    indexing op's backward (``index_put`` into fresh zeros, and so a copy of
    them), where a run without one, the card's, writes into the zeros in
    place (``_index_put_impl_``): an embedding table's gradient twice over.
    So an accumulating ``index_put`` whose target is the zeros the op before
    made runs in place here, as it does on the card."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.ops = 0
        self._moves: Dict[Any, bool] = {}  # op -> _moves_bytes(op)
        self._zeros = None  # the storage of the zeros the last op made, if it made zeros

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = _rounded(st.nbytes())
        self.live[key] = n
        self.current += n
        weakref.finalize(st, self._free, key)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._add(t)
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten.index_put.default and (args[3] if len(args) > 3 else kwargs.get("accumulate"))
                and args[0].untyped_storage()._cdata == self._zeros):
            func = torch.ops.aten.index_put_.default
        out = func(*args, **kwargs)
        self.ops += 1
        outs = list(_tensors(out))
        self._zeros = outs[0].untyped_storage()._cdata if func.overloadpacket.__name__ in _ZEROS else None
        for t in outs:
            self._add(t)
        self.peak = max(self.peak, self.current)
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = _moves_bytes(func)
        if moves:
            ins = list(_tensors((args, kwargs)))
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def count(fn: Callable[[], Any], arguments) -> Dict[str, Any]:
    """Runs ``fn`` (on ``meta`` tensors) under the three counters, with
    ``arguments`` (a tree of the rank's tensors) tracked as live from the
    start.  Returns {"flops", "aten_flops", "kernel_flops", "bytes_accessed",
    "kernel_bytes", "argument_bytes", "peak_bytes", "launches", "aten_ops",
    "host_s"}."""
    t0 = time.perf_counter()
    live = LiveBytes()
    with kcost.recording() as rec, FlopCounterMode(display=False) as flops, live:
        live.track(arguments)
        out = fn()
    del out
    aten_flops = int(flops.get_total_flops())
    return {"flops": aten_flops + rec.flops, "aten_flops": aten_flops, "kernel_flops": rec.flops,
            "bytes_accessed": live.bytes_accessed + rec.bytes, "kernel_bytes": rec.bytes,
            "argument_bytes": argument_bytes(arguments), "peak_bytes": live.peak, "launches": dict(rec.launches),
            "aten_ops": live.ops, "host_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the rank's tensors on meta
# ---------------------------------------------------------------------------


class _OnMeta(TorchFunctionMode):
    """Every factory call with a ``device`` makes its tensor on ``meta``, and
    draws nothing (the ``generator`` is dropped)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def meta_params(model, dtype: Optional[torch.dtype] = None):
    """``model.init(gen, dtype)`` on ``meta``: the tree, shapes and dtypes the
    card's init makes, with nothing drawn."""
    with _OnMeta():
        return model.init(torch.Generator(), dtype=dtype)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def train_batch(cfg, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """The global batch the port's trainer hands every rank (``make_batches``'
    keys, shapes and dtypes: embeds in f32, where ``shapes.batch_specs`` has
    the reference's bf16), as ``meta`` tensors."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "audio":
        return {"embeds": meta((batch, seq, cfg.d_model), torch.float32), "labels": meta((batch, seq), torch.int32),
                "mask": meta((batch, seq), torch.float32)}
    if cfg.family == "vlm":
        return {"embeds": meta((batch, seq, cfg.d_model), torch.float32),
                "positions": meta((3, batch, seq), torch.int32), "labels": meta((batch, seq), torch.int32),
                "mask": meta((batch, seq), torch.float32)}
    return {"tokens": meta((batch, seq), torch.int32)}


def train_program(cfg, mesh: Mesh, batch: Dict[str, torch.Tensor], *, boundary: str = "striped"
                  ) -> Tuple[Callable[[], Any], Any, MetaTransport]:
    """(step, its arguments, the transport) of ``mesh.rank``'s pipelined train
    step on ``meta``: its stage of the whole model's f32 parameters
    (``stage_params``), zero moments, and ``make_train_step`` over a
    ``PipelineLoss`` with a ``MetaTransport``, on the global ``batch``."""
    params = stage_params(meta_params(build_model(cfg)), cfg, mesh)
    opt = init_opt_state(params)
    transport = MetaTransport(mesh)
    loss_fn = PipelineLoss(cfg, mesh, N_MICRO, boundary, transport=transport)
    step = make_train_step(loss_fn, OptimizerConfig())
    return (lambda: step(params, opt, batch)), (params, opt, batch), transport


def dp_train_program(cfg, mesh: Mesh, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[Callable[[], Any], Any, MetaTransport]:
    """(step, its arguments, the transport) of ``mesh.rank``'s plain
    data-parallel train step on ``meta``: the whole model's f32 parameters,
    zero moments, and ``make_train_step`` over a ``DataParallelLoss`` with a
    ``MetaTransport``, on the global ``batch``."""
    model = build_model(cfg)
    params = meta_params(model)
    opt = init_opt_state(params)
    transport = MetaTransport(mesh)
    step = make_train_step(DataParallelLoss(model.loss, mesh, transport=transport), OptimizerConfig())
    return (lambda: step(params, opt, batch)), (params, opt, batch), transport


def serve_program(cfg, kind: str, rows: int, seq: int) -> Tuple[Callable[[], Any], Any]:
    """(call, its arguments) of one replica serving ``rows`` rows on ``meta``,
    under ``torch.no_grad()``, its weights in ``cfg.dtype``: the encoder's
    forward (``Model.loss`` on ``train_batch``'s frames) for the audio
    family, else ``prefill`` of ``rows`` x ``seq`` tokens into an empty cache
    of ``cache_shape(rows, seq)``, or one ``decode_step`` on it."""
    model = build_model(cfg)
    params = meta_params(model, dtype=cfg.dtype)
    meta = torch.device("meta")
    if cfg.family == "audio":
        batch = train_batch(cfg, rows, seq)
        return _no_grad(lambda: model.loss(params, batch)), (params, batch)
    cache = zeros_cache(model, rows, seq, meta)
    if kind == "prefill":
        batch = {"tokens": torch.empty((rows, seq), dtype=torch.int32, device=meta)}
        return _no_grad(lambda: model.prefill(params, batch, cache)), (params, batch, cache)
    tokens = torch.empty((rows,), dtype=torch.int32, device=meta)
    pos = torch.empty((rows,), dtype=torch.int32, device=meta)
    return _no_grad(lambda: model.decode_step(params, cache, tokens, pos)), (params, cache, tokens, pos)


def _no_grad(fn: Callable[[], Any]) -> Callable[[], Any]:
    def run():
        with torch.no_grad():
            return fn()
    return run


# ---------------------------------------------------------------------------
# collectives, the plan, the roofline
# ---------------------------------------------------------------------------


def axis_bandwidth(mesh: Mesh, axis: str) -> float:
    """NVLink's rate where the group of ``axis`` through rank 0 stays inside
    one node of NODE_GPUS consecutive ranks, else the NIC's."""
    ranks = [Mesh(tuple(mesh.shape.values()), mesh.axis_names, 0).rank_at(**{axis: i})
             for i in range(mesh.shape[axis])]
    return NVLINK_BW if min(ranks) // NODE_GPUS == max(ranks) // NODE_GPUS else NIC_BW


def wire_bytes(ops: Dict[str, int]) -> int:
    """An axis's bytes as the reference counts them: an all-reduce twice."""
    return ops.get("send", 0) + ops.get("all_gather", 0) + 2 * ops.get("all_reduce", 0)


def collectives(by_axis: Dict[str, Dict[str, int]], mesh: Mesh) -> Dict[str, Any]:
    """The reference's ``{ici, dcn, by_op}`` (all-reduce doubled, sends as
    collective-permute, ``dcn`` the pod axis), the transport's own
    ``by_axis``, and ``seconds``: each axis's bytes at its ``axis_bandwidth``."""
    names = {"send": "collective-permute", "all_reduce": "all-reduce", "all_gather": "all-gather"}
    by_op: Dict[str, float] = {}
    for ops in by_axis.values():
        for op, n in ops.items():
            if n:
                by_op[names[op]] = by_op.get(names[op], 0.0) + float(n * (2 if op == "all_reduce" else 1))
    dcn = float(wire_bytes(by_axis.get("pod", {})))
    ici = float(sum(wire_bytes(ops) for a, ops in by_axis.items() if a != "pod"))
    seconds = sum(wire_bytes(ops) / axis_bandwidth(mesh, a) for a, ops in by_axis.items() if a in mesh.shape)
    return {"ici": ici, "dcn": dcn, "by_op": by_op, "by_axis": by_axis, "seconds": seconds}


def head_aligned_tp(cfg, max_tp: int = 16) -> int:
    """Largest TP degree <= max_tp that lands on attention-head boundaries."""
    tp = max_tp
    while tp > 1:
        if cfg.num_heads % tp == 0 and (cfg.num_kv_heads % tp == 0 or cfg.num_kv_heads == 1):
            return tp
        tp //= 2
    return 1


def plan_mesh(cfg, multi_pod: bool, relayout: bool = False) -> Mesh:
    """The production mesh, or with ``relayout`` (single pod only) the same
    256 devices as (256 / tp, tp) with a head-aligned tp."""
    if relayout and not multi_pod:
        tp = head_aligned_tp(cfg)
        return Mesh((256 // tp, tp), ("data", "model"))
    return Mesh(*production_mesh_shape(multi_pod))


def plan_bytes(cfg, mesh: Mesh, *, fsdp: bool) -> int:
    """The bytes of the f32 parameters one device holds under the placement
    plan (``make_param_shardings`` on ``mesh``): each leaf's local shape."""
    params = meta_params(build_model(cfg))
    plan = flatten(make_param_shardings(params, mesh, fsdp=fsdp))
    return sum(math.prod(shp.local_shape(tuple(t.shape), plan[p], mesh)) * t.element_size()
               for p, t in flatten(params).items())


def model_flops_per_device(cfg, shape: str, multi_pod: bool) -> float:
    """The reference's analytic MODEL_FLOPS a device: 6 (train) or 2 x active
    parameters x tokens, over 512 or 256 chips."""
    chips = 512 if multi_pod else 256
    s = shp.SHAPES[shape]
    tokens = s["global_batch"] * (s["seq_len"] if s["kind"] != "decode" else 1)
    # an int made a float, not the reference's float literal (the module docstring)
    return float(6 if s["kind"] == "train" else 2) * cfg.active_param_count() * tokens / chips


def _figures(counted: Dict[str, Any], coll: Dict[str, Any]) -> Dict[str, Any]:
    return {"memory": {"argument_bytes": counted["argument_bytes"], "peak_bytes": counted["peak_bytes"],
                       "temp_bytes": counted["peak_bytes"] - _rounded(counted["argument_bytes"]),
                       "fits_device": counted["peak_bytes"] <= DEVICE_BYTES},
            "cost": {"flops": float(counted["flops"]), "bytes accessed": float(counted["bytes_accessed"]),
                     "aten_flops": float(counted["aten_flops"]), "kernel_flops": float(counted["kernel_flops"]),
                     "kernel_bytes": float(counted["kernel_bytes"]), "aten_ops": counted["aten_ops"]},
            "launches": counted["launches"], "collectives": coll, "host_s": counted["host_s"]}


def _larger(figs: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Each number the larger of the stages' (the fit of the larger peak)."""
    def merge(vals):
        if isinstance(vals[0], dict):
            keys = {k for v in vals for k in v}
            return {k: merge([v.get(k, 0) for v in vals]) for k in keys}
        if isinstance(vals[0], bool):
            return all(vals)
        return max(vals)
    return merge(list(figs.values()))


def run_one(arch: str, shape: str, mesh_name: str, boundary: str = "striped",
            fsdp: Optional[bool] = None, relayout: bool = False,
            wan_preset: Optional[str] = None,
            wan_drift: Optional[str] = None,
            wan_fleet: int = 0,
            wan_fail: Optional[str] = None,
            tracer=None, trace_label: Optional[str] = None) -> Dict[str, Any]:
    multi_pod = mesh_name == "multi"
    ok, why = shp.shape_supported(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "skipped", "reason": why}
    s = shp.SHAPES[shape]
    kind = s["kind"]
    t0 = time.time()
    cfg = shp.config_for(arch, shape)
    if fsdp is None:
        fsdp = kind == "train"
    mesh_shape, names = production_mesh_shape(multi_pod)
    mesh = Mesh(mesh_shape, names)
    ranks = mesh.size
    result: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name, "boundary": boundary, "status": "ok"}
    if kind == "train" and not multi_pod:
        batch = train_batch(cfg, s["global_batch"], s["seq_len"])
        fn, args, transport = dp_train_program(cfg, mesh, batch)
        counted = count(fn, args)
        del fn, args
        top = _figures(counted, collectives(transport.counts(), mesh))
        result.update(program="data_parallel", rows_per_rank=s["global_batch"] // mesh.shape["data"],
                      ranks_busy=ranks)
    elif kind == "train":
        batch = train_batch(cfg, s["global_batch"], s["seq_len"])
        figs = {}
        for stage in range(mesh.shape["pod"]):
            rank_mesh = Mesh(mesh_shape, names, mesh.rank_at(pod=stage))
            fn, args, transport = train_program(cfg, rank_mesh, batch, boundary=boundary)
            counted = count(fn, args)
            figs[str(stage)] = _figures(counted, collectives(transport.counts(), rank_mesh))
            del fn, args
        top = _larger(figs)
        result.update(program="pipeline", n_micro=N_MICRO, ranks_busy=ranks, stages=figs)
    else:
        rows = -(-s["global_batch"] // ranks)
        fn, args = serve_program(cfg, kind, rows, s["seq_len"])
        counted = count(fn, args)
        del fn, args
        top = _figures(counted, collectives({}, mesh))
        result.update(program="replica", rows_per_rank=rows, ranks_busy=min(s["global_batch"], ranks))
    mfd = model_flops_per_device(cfg, shape, multi_pod)
    flops_dev = top["cost"]["flops"]
    coll = top["collectives"]
    result.update({
        "host_s": round(time.time() - t0, 2), "lower_s": 0.0, "compile_s": round(time.time() - t0, 2),
        "memory": top["memory"], "cost": top["cost"], "launches": top["launches"], "collectives": coll,
        "roofline": {
            "compute_s": mfd / PEAK_FLOPS,
            "compute_s_hlo": flops_dev / PEAK_FLOPS,
            "memory_s": top["cost"]["bytes accessed"] / HBM_BW,
            "collective_s": coll["seconds"],
            "dcn_bytes": coll["dcn"],
            "model_flops_per_device": mfd,
            "useful_flops_ratio": mfd / flops_dev if flops_dev else None,
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "plan_bytes_per_device": plan_bytes(cfg, plan_mesh(cfg, multi_pod, relayout), fsdp=fsdp),
        "plan": {"fsdp": fsdp, "relayout": bool(relayout and not multi_pod),
                 "mesh": dict(plan_mesh(cfg, multi_pod, relayout).shape)},
        "hardware": "one H100 SXM at its published 700 W peaks: 989e12 FLOP/s bf16, 3.35e12 B/s HBM; "
                    f"NVLink {NVLINK_BW:.0f} B/s inside {NODE_GPUS} ranks, else a NIC's {NIC_BW:.0f} B/s",
    })
    if wan_preset:
        result["wan"] = wan_projection(coll["dcn"], wan_preset, drift=wan_drift, fleet_jobs=wan_fleet, fail=wan_fail,
                                       tracer=tracer, trace_label=trace_label)
    return result


# ---------------------------------------------------------------------------
# the WAN projection: the reference's, over the port's core/ and obs/
# ---------------------------------------------------------------------------


def wan_projection(dcn_bytes: float, topo,
                   drift: Optional[str] = None,
                   fleet_jobs: int = 0,
                   fail: Optional[str] = None,
                   tracer=None,
                   trace_label: Optional[str] = None) -> Dict[str, Any]:
    """Project the measured inter-pod DCN bytes onto a WAN topology: the
    per-iteration transfer time if the pod boundary ran over the given
    (possibly heterogeneous) WAN instead of the datacenter DCN.  Uses the
    bottleneck pair — the paper's placement rule puts the cut on the best
    pair, but capacity planning must survive the worst.

    ``drift="outage"`` adds the reactive-control-plane projection: the
    boundary transfer priced through a sustained 10x degradation of the
    pair it rides (what a static plan keeps paying) vs. re-routed onto
    the best alternative pair (what ``repro_torch.core.control`` migrates to
    once the drift detector fires).

    ``fleet_jobs=N`` (N ≥ 2) adds the multi-job sharing projection
    (``repro_torch.core.fleet``): N jobs' boundary transfers contending for
    the same pair.  Contention-aware temporal sharing serializes them —
    job k's transfer completes at k·S, mean (N+1)/2·S — while the naive
    always-fair-share model runs every transfer at 1/N rate so *all* of
    them complete at N·S.

    ``fail="dc@t"`` (e.g. ``"us-west@600"``, seconds) adds the failure &
    elasticity projection (``repro_torch.core.failures``): that DC suffers an
    unplanned outage at t, its pairs drop to residual bandwidth, and the
    boundary transfer is priced three ways — keep riding the dead DC at
    residual rate (static), haul the live state off it over the same
    residual links (ship), or pull the last async checkpoint between
    healthy DCs at full rate (checkpoint-aware restore).

    ``tracer`` (``repro_torch.obs.Tracer``) additionally *simulates* one
    iteration of a pipeline whose boundary transfers carry the measured
    DCN bytes over this WAN, recording GPU and channel spans under the
    ``trace_label`` lane group — the closed-form projections above as an
    inspectable Perfetto timeline (exported by ``--trace``)."""
    from repro_torch.core import wan as _wan

    if isinstance(topo, str):
        from repro_torch.core.topology import preset

        topo = preset(topo)
    worst = topo.bottleneck()
    best = topo.best_link()
    out = {
        "topology": topo.name,
        "worst_pair_s": worst.transfer_ms(dcn_bytes) / 1e3,
        "best_pair_s": best.transfer_ms(dcn_bytes) / 1e3,
        "worst_pair_gbps": worst.bw_gbps,
        "best_pair_gbps": best.bw_gbps,
    }
    if drift == "outage":
        deg = _wan.BandwidthSchedule.outage(
            best.bw_gbps, 1e-3, 1e15, best.bw_gbps / 10.0)
        static_s = (deg.transfer_ms(dcn_bytes, 1.0)
                    + best.latency_ms) / 1e3
        # the re-plan routes the cut onto the best *alternative* pair —
        # a different physical pair, not the reverse direction of the
        # degraded one (wan_pairs() yields both directions)
        by_pair = {}
        for a, b in topo.wan_pairs():
            by_pair.setdefault(frozenset((a, b)), []).append(topo.link(a, b))
        ranked = sorted(
            ((max(ls, key=lambda l: (l.bw_gbps, -l.latency_ms)), key)  # noqa: E741
             for key, ls in by_pair.items()),
            key=lambda kl: (-kl[0].bw_gbps, kl[0].latency_ms))
        if len(ranked) > 1:
            reactive_s = ranked[1][0].transfer_ms(dcn_bytes) / 1e3
        else:
            reactive_s = static_s  # single-pair WAN: nowhere to migrate
        out["drift"] = {
            "scenario": "10x outage on the boundary pair",
            "static_s": static_s,  # the plan keeps riding the degraded pair
            "reactive_s": reactive_s,  # re-planned onto the best alternative
            "reactive_speedup": static_s / reactive_s if reactive_s else None,
        }
    if fleet_jobs >= 2:
        n = fleet_jobs
        per_job_s = best.transfer_ms(dcn_bytes) / 1e3
        out["fleet"] = {
            "scenario": f"{n} jobs sharing the boundary pair",
            "per_job_s": per_job_s,  # one transfer alone at full rate
            # temporal sharing: transfers serialize — the k-th completes
            # at k·S; mean job waits (N+1)/2·S, the last N·S
            "temporal_mean_s": (n + 1) / 2.0 * per_job_s,
            "temporal_worst_s": n * per_job_s,
            # naive always-fair-share: every transfer at 1/N rate, all
            # complete together at N·S — no job ever finishes early
            "fair_share_mean_s": n * per_job_s,
            "temporal_mean_speedup": 2.0 * n / (n + 1),
        }
    if fail:
        from repro_torch.core.failures import FailureEvent, FailureTrace

        if "@" not in fail:
            raise ValueError(f"--fail wants dc@t_seconds, got {fail!r}")
        dc, t_str = fail.rsplit("@", 1)
        if dc not in topo.dc_names:
            raise ValueError(f"--fail DC {dc!r} not in {topo.dc_names}")
        at_ms = float(t_str) * 1e3
        residual = 0.05
        trace = FailureTrace(events=(
            FailureEvent(at_ms=at_ms, kind="dc_outage", dc=dc,
                         residual_frac=residual),))
        degraded = trace.apply_to_topology(topo)
        idx = topo.index_of(dc)
        dead_pairs = [(a, b) for a, b in topo.wan_pairs() if idx in (a, b)]
        alive = [topo.link(a, b) for a, b in topo.wan_pairs()
                 if idx not in (a, b)]
        # the boundary transfer through the dead DC, at residual rate
        residual_s = max(
            degraded.bandwidth_schedule(a, b).transfer_ms(
                dcn_bytes, at_ms + 1.0) / 1e3 + topo.link(a, b).latency_ms / 1e3
            for a, b in dead_pairs)
        # restore: the checkpoint lives on healthy DCs — full-rate pull
        restore_s = (min(l.transfer_ms(dcn_bytes) for l in alive) / 1e3  # noqa: E741
                     if alive else residual_s)
        out["failure"] = {
            "scenario": f"{dc} dies at t={at_ms/1e3:.0f}s "
                        f"(residual {residual:.0%})",
            "dead_dc": dc,
            "at_s": at_ms / 1e3,
            # a static plan keeps paying the residual rate every iteration
            "static_s": residual_s,
            # shipping live state off the corpse rides the same residual
            # links once — then runs free of the dead DC
            "ship_once_s": residual_s,
            # checkpoint-aware restore never touches the dead DC
            "restore_s": restore_s,
            "restore_speedup": residual_s / restore_s if restore_s else None,
        }
    if tracer is not None and getattr(tracer, "enabled", False):
        import dataclasses as _dc

        from repro_torch.core.control import plan_spec
        from repro_torch.core.dc_selection import JobModel, algorithm1, best_plan
        from repro_torch.core.simulator import simulate as _simulate

        sim_topo = topo
        if not sim_topo.dc_names:
            sim_topo = _dc.replace(
                topo, dc_names=tuple(f"dc{i}" for i in range(topo.n_dcs)))
        # one microbatch's boundary activation carries an even share of
        # the measured per-step DCN bytes; a nominal 10 ms compute keeps
        # the bubbles visible next to the WAN transfers
        m = 8
        # partition_param_bytes: the reference's 2e8, written as the module docstring says
        proj_job = JobModel(
            t_fwd_ms=10.0, act_bytes=max(dcn_bytes, 1.0) / m,
            partition_param_bytes=float(2 * 10**8), microbatches=m, topology=sim_topo)
        plan = best_plan(algorithm1(
            proj_job, {d: 8 for d in sim_topo.dc_names}, P=8, C=1))
        res = _simulate(plan_spec(proj_job, plan, sim_topo), sim_topo,
                        validate=True, tracer=tracer,
                        trace_label=trace_label or "wanproj")
        out["trace"] = {
            "label": trace_label or "wanproj",
            "iteration_ms": res.iteration_ms,
            "dc_order": [d for d in plan.dc_order
                         if plan.partitions.get(d, 0)],
        }
    return out


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES) + [None])
    ap.add_argument("--mesh", default=None, choices=["single", "multi", None])
    ap.add_argument("--boundary", default="striped", choices=["striped", "direct"])
    ap.add_argument("--no-fsdp", action="store_true",
                    help="paper-faithful model-axis-only param sharding (plan_bytes_per_device only)")
    ap.add_argument("--relayout", action="store_true",
                    help="head-aligned single-pod mesh re-layout (plan_bytes_per_device only)")
    ap.add_argument("--wan-preset", default=None, choices=["azure", "skewed", "star", "chain"],
                    help="also project the inter-pod DCN bytes onto this WAN topology "
                         "(repro_torch.core.topology presets)")
    ap.add_argument("--wan-drift", default=None, choices=["outage"],
                    help="with --wan-preset: add the reactive control-plane projection (static plan riding a "
                         "10x-degraded boundary pair vs re-planned onto the best alternative — "
                         "repro_torch.core.control)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="with --wan-preset: add the multi-job sharing projection — N jobs' boundary transfers "
                         "on one pair, contention-aware temporal sharing vs naive always-fair-share "
                         "(repro_torch.core.fleet)")
    ap.add_argument("--fail", default=None, metavar="DC@T",
                    help="with --wan-preset: add the failure & elasticity projection — that DC dies at T seconds, "
                         "boundary transfer priced static vs ship-live vs checkpoint-aware restore "
                         "(repro_torch.core.failures); e.g. --fail us-west@600")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="with --wan-preset: record the WAN-projection simulations of every combo this run "
                         "executes and export one Perfetto-loadable Chrome trace (repro_torch.obs)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    tracer = None
    if args.trace:
        if not args.wan_preset:
            ap.error("--trace requires --wan-preset (it records the WAN-projection simulation)")
        from repro_torch import obs
        tracer = obs.RecordingTracer()

    os.makedirs(args.out, exist_ok=True)
    archs = [canon(args.arch)] if args.arch else ARCHS[:10]  # assigned 10
    shapes = [args.shape] if args.shape else list(shp.SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    t_sweep = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{arch}_{shape}_{mesh_name}_{args.boundary}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = run_one(arch, shape, mesh_name, args.boundary, fsdp=False if args.no_fsdp else None,
                                  relayout=args.relayout, wan_preset=args.wan_preset, wan_drift=args.wan_drift,
                                  wan_fleet=args.fleet, wan_fail=args.fail, tracer=tracer, trace_label=tag)
                except Exception as e:
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name, "boundary": args.boundary,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if res["status"] == "ok":
                    r, m = res["roofline"], res["memory"]
                    extra = (f" compute={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s "
                             f"coll={r['collective_s']:.4f}s dcn={r['dcn_bytes'] / 1e6:.1f}MB "
                             f"peak={m['peak_bytes'] / 1e9:.2f}GB host={res['host_s']}s")
                print(f"[{res['status']}] {tag}{extra}", flush=True)
    print(f"[sweep] {time.perf_counter() - t_sweep:.1f} s", flush=True)

    if tracer is not None:
        if tracer.n_events:
            from repro_torch import obs
            from repro_torch.core.validate import check_trace

            n_windows = check_trace(tracer)  # second witness before export
            obs.write_chrome_trace(tracer, args.trace, label="dryrun-wan")
            print(f"[trace] {tracer.n_events} events ({n_windows} windows crosschecked) -> {args.trace}")
        else:
            print("[trace] nothing recorded (all combos cached? use --force)")


if __name__ == "__main__":
    main()
