"""Serving launcher: batched decode with kNN-LM retrieval on one card
(port of ``repro.launch.serve``, without a mesh).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        [--scaled] [--device cpu] --requests 8 --max-new 16

Weights come from a seeded generator and the datastore is synthetic, as in
``repro``'s launcher; it runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core import retrieval
from repro_torch.models import lm
from repro_torch.runtime import server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--scaled", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.scaled:
        cfg = scaled_down(cfg)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = lm.init_params(gen, cfg, device=dev)
    store = None
    if cfg.retrieval.enabled:
        n = 4096 if args.scaled else cfg.retrieval.datastore_size
        store = retrieval.synthetic_datastore(
            cfg, n=n, generator=torch.Generator(dev).manual_seed(args.seed + 3),
            device=dev)

    srv = server.Server(cfg, model, max_batch=args.max_batch,
                        max_len=args.max_len, store=store, device=dev)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
        srv.submit(server.Request(uid=uid, prompt=prompt,
                                  max_new_tokens=args.max_new))
    ticks = srv.run()
    print(f"served {len(srv.done)}/{args.requests} requests in {ticks} ticks; "
          f"throughput {len(srv.done) * args.max_new / max(ticks, 1):.2f} "
          f"tok/tick")
    return srv


if __name__ == "__main__":
    main()
