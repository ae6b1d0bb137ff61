"""Training launcher on one card (port of ``repro.launch.train``, without
a mesh).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --shape train_4k --steps 200 --ckpt-dir CKPT [--scaled] [--device cpu]

``--scaled`` trains the reduced config (seq 128, batch 8 unless given);
without it the arch's full config at the shape's sequence length and
global batch. It runs on CUDA unless ``--device cpu`` is given. The loop
is fault-tolerant: auto-resume, checkpoints, deterministic data, straggler
monitor (runtime/trainer.py). ``--multi-pod`` and the production mesh are
launch tooling not ported yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import argparse

from repro_torch import device as device_mod
from repro_torch.configs import (ALL_ARCHS, TrainConfig, get_config,
                                 get_shape, scaled_down)
from repro_torch.runtime import trainer


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
    if args.multi_pod:
        ap.error("--multi-pod needs the production mesh, which is launch "
                 "tooling not ported yet (ROADMAP queue 1 item 12)")

    dev = device_mod.resolve(args.device)
    shape = get_shape(args.shape)
    if args.scaled:
        cfg = scaled_down(get_config(args.arch))
        seq_len = args.seq_len or 128
        global_batch = args.global_batch or 8
    else:
        cfg = get_config(args.arch)
        seq_len = args.seq_len or shape.seq_len
        global_batch = args.global_batch or shape.global_batch

    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=min(20, args.steps // 10 + 1))
    rep = trainer.train(cfg, tc, seq_len=seq_len, global_batch=global_batch,
                        device=dev, ckpt_dir=args.ckpt_dir)
    print(f"final loss {rep.final_loss:.4f} over {rep.steps_done} steps "
          f"(resumed_from={rep.resumed_from})")
    return rep


if __name__ == "__main__":
    main()
