"""Production training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --shape train_4k --steps 200 --ckpt-dir CKPT [--scaled] [--device cpu]
    torchrun --nnodes 32 --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch gemma-2b [--multi-pod]

Every registered arch trains (a frontend config on seeded stand-in
prefix embeddings). ``--scaled`` trains the reduced config (seq 128,
batch 8 unless given) on one device, as ``repro``'s (1, 1) mesh; without
it the arch's full config at the shape's sequence length and global
batch: in one process on one card, and under ``torchrun`` (a world of 256
ranks, one per card, 512 with ``--multi-pod``) on the production mesh
(``launch/mesh.make_production_mesh``), each rank on its card and its
share of the batch through ``trainer.train(..., mesh=)``. Any other world
size raises. It runs on CUDA unless ``--device cpu`` is given. The loop
is fault-tolerant: auto-resume, checkpoints, deterministic data,
straggler monitor (runtime/trainer.py).
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.configs import (ALL_ARCHS, TrainConfig, get_config,
                                 get_shape, scaled_down)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import trainer


def launch_mesh(multi_pod: bool):
    """The mesh a full-size run trains on: None (one card) in a single
    process without ``--multi-pod``; else the production mesh over the
    process group ``torchrun`` set up (opened here from its environment
    if it is not open yet), which raises unless the world holds 256 /
    512 ranks."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        dist.init_process_group("nccl")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and not multi_pod:
        return None
    if not dist.is_initialized():
        raise ValueError("--multi-pod trains on a (2, 16, 16) mesh of 512 "
                         "ranks; this is a single process (world of 1)")
    return make_production_mesh(multi_pod=multi_pod)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--scaled", action="store_true",
                    help="reduced config for CPU runs")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    shape = get_shape(args.shape)
    mesh = None
    if args.scaled:
        cfg = scaled_down(get_config(args.arch))
        seq_len = args.seq_len or 128
        global_batch = args.global_batch or 8
    else:
        cfg = get_config(args.arch)
        mesh = launch_mesh(args.multi_pod)
        seq_len = args.seq_len or shape.seq_len
        global_batch = args.global_batch or shape.global_batch

    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=min(20, args.steps // 10 + 1))
    rep = trainer.train(cfg, tc, seq_len=seq_len, global_batch=global_batch,
                        device=dev, mesh=mesh, ckpt_dir=args.ckpt_dir)
    print(f"final loss {rep.final_loss:.4f} over {rep.steps_done} steps "
          f"(resumed_from={rep.resumed_from})")
    return rep


if __name__ == "__main__":
    main()
