"""The global FLOPs of every runnable (arch x shape) cell at full width,
as the port's ``launch/op_analysis`` counts one rank running the whole
batch and as ``repro``'s ``launch/jaxpr_analysis`` counts its jitted
step's jaxpr (tracing only, a (1, 1) mesh). Both run on the CPU with no
card; the port's trace takes minutes for the 32K-token cells.

    PYTHONPATH=src python tests/_torch_launch_table.py [--out FILE]

Prints one markdown row per cell (and writes them all as JSON to
``--out``): the two counts and their ratio. Not a test: the parity tests
(``tests/test_torch_launch_ops.py``) hold the same analysis at
``scaled_down`` widths.
"""
from __future__ import annotations

import argparse
import json
import time

from repro import compat
from repro import configs as rconfigs
from repro.dist import steps as rsteps
from repro.launch import jaxpr_analysis
from repro.launch import specs as rspecs
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, op_analysis


def repro_flops(arch: str, shape_name: str) -> float:
    cfg, shape = rconfigs.get_config(arch), rconfigs.get_shape(shape_name)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    tc = rconfigs.TrainConfig()
    args = rspecs.input_specs(cfg, shape, tc)
    with mesh:
        if shape.step == rconfigs.StepKind.TRAIN:
            fn = rsteps.make_train_step(cfg, mesh, tc, donate=False)[0]
        elif shape.step == rconfigs.StepKind.PREFILL:
            fn = rsteps.make_prefill_step(cfg, mesh, shape.seq_len)[0]
        else:
            fn = rsteps.make_serve_step(cfg, mesh, shape.seq_len,
                                        global_batch=shape.global_batch)[0]
        return jaxpr_analysis.analyze_step(fn, args, 1)["flops"]


def port_flops(arch: str, shape_name: str) -> float:
    cfg, shape = tconfigs.get_config(arch), tconfigs.get_shape(shape_name)
    dev = dryrun.trace_device()
    with dryrun.stand_ins(dev):
        fn, args, _, _ = dryrun.build_step(cfg, shape, None, device=dev)
        return op_analysis.trace_step(fn, args)[1].flops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cells, _ = rconfigs.runnable_cells(
        [rconfigs.get_config(a) for a in rconfigs.ALL_ARCHS])
    rows = []
    print("| cell | port (one rank, global batch) | repro jaxpr | port / "
          "repro |\n|---|---|---|---|", flush=True)
    for arch, shape in cells:
        t0 = time.time()
        got, want = port_flops(arch, shape), repro_flops(arch, shape)
        rows.append({"arch": arch, "shape": shape, "port_flops": got,
                     "repro_flops": want, "s": time.time() - t0})
        print(f"| {arch} × {shape} | {got:.6e} | {want:.6e} | "
              f"{got / want:.6f} |", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
