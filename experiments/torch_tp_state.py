#!/usr/bin/env python3
"""The f32 train state a tensor-parallel rank holds, beside its replica's.

    PYTHONPATH=src python3 experiments/torch_tp_state.py [--layers 6] [--model 2]

Needs no card: shapes only, on ``meta``.  For the pure Mamba2 stack at
Zamba2-2.7B's widths (``family="ssm"``), Zamba2-2.7B and RWKV-6 7B with
``--layers`` layers each (RWKV-6: 2, as ``chip_smoke.py``'s
``train_tp_recurrent`` runs it), prints one JSON line a model: the f32
parameters of the whole model and of one rank's shards on (data, model) =
(1, ``--model``) under the reference's placement plan
(``launch.dryrun.plan_bytes``, fsdp off), and the f32 train state of each
(parameters, gradients and AdamW's two moments: 16 bytes a parameter), and
the rank's share of the replica's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.dryrun import plan_bytes  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--model", type=int, default=2)
    args = ap.parse_args(argv)
    zamba = get_config("zamba2_2p7b")
    models = [("mamba2-pure (zamba2-2.7b widths)", dataclasses.replace(zamba, family="ssm", num_layers=args.layers)),
              ("zamba2-2.7b", dataclasses.replace(zamba, num_layers=args.layers)),
              ("rwkv6-7b", dataclasses.replace(get_config("rwkv6_7b"), num_layers=2))]
    for name, cfg in models:
        whole = plan_bytes(cfg, Mesh((1, 1), ("data", "model")), fsdp=False)
        rank = plan_bytes(cfg, Mesh((1, args.model), ("data", "model")), fsdp=False)
        print(json.dumps({"model": name, "layers": cfg.num_layers, "mesh": {"data": 1, "model": args.model},
                          "whole_f32_param_bytes": whole, "rank_f32_param_bytes": rank,
                          "whole_f32_state_bytes": 4 * whole, "rank_f32_state_bytes": 4 * rank,
                          "rank_share": rank / whole}))


if __name__ == "__main__":
    main()
