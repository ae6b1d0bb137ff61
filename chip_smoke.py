#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from the sources in the checkout (one
nvcc per source, all at once) and drives these paths, each with the
kernel launch counts set to 0 just before it and read just after:

* exact Hamming kNN — ``KNNEngine(...).with_layout().search(q, k=16)`` at
  Q=4096, N=2^20, d=256 on seeded clustered codes, through K1 (pass-1
  histogram) and K2 (pass-2 emit), checked against an on-card brute force;
  the same store then runs through ``select="fused"`` on insertion order.
  K1 (with its per-run histograms) and K2 (split over the main run count
  and as one run) are held bit-for-bit against their plain PyTorch
  versions on edge cases and at the main path's full shape, and K2's own
  count of the tiles it pruned (its counter, on while a profiler records)
  against ``hamming_topk``'s ``return_stats`` mirror there; the committed
  d = 256 kernels (single-bit tensor-core products) and the CUDA-core ones
  (the same source built with its tensor-core dispatch taken out) are
  timed in turns, the latter held to the former. The same full-shape
  check runs at kNN-SIFT's d = 128, k = 4 and at kNN-WordEmbed's d = 64,
  k = 2, over 2^20 clustered codes each; the tiles the launches count as
  taking the CUDA-core kernels must be 0 % at d = 256, 128 and 64. At
  d = 64 the two routes are timed in turns too, the CUDA-core one held
  to the tensor-core one bit for bit. At d = 1024, k = 40 (binary-
  quantised text embeddings, 2^20 clustered codes) both routes are held to
  the plain versions and timed, the committed tile's tiles 0 % on the
  CUDA cores and the CUDA-core build's 100 %, then timed in turns twice,
  the second time reversed; the main path's search there is checked
  against the on-card brute force and timed.
* the board scan — the same store through ``KNNEngine.search(...,
  method="pallas")`` under the counting (the paper's temporal sort over
  board-sized chunks of 65,536 rows), composite and bisect selects: K3
  materializes each chunk's (4096, chunk) distances, 16, 17 and 16 launches
  per search; each result equals the fused one bit-for-bit. K3 is held
  bit-for-bit against its plain version on edge cases and at 4096 x 65,536.
* index-probed search — a seeded float store of 2^20 x 256 (1024 Gaussian
  centres) with 256-bit ITQ codes, under IVF (``kmeans_build``, 1024
  clusters; nprobe 1, 8, 32 masked and 8 gathered), LSH (4 tables of 12
  bits, masked and gathered) and a kd-tree forest (4 trees, leaves of 512,
  gathered), and hamming-prefix probing of the first path's layout at
  nprobe 8 (the serving ladder's degraded rung). Each masked search is one
  K1 and one K2 launch; on sampled queries its mask row enables exactly
  the blocks that the probed buckets' row ranges (rounded out to blocks)
  and the candidates' positions cover, worked out on the host, and its
  result equals a brute force over those rows; masked k-th distances never
  exceed the gathered ones; the kd-tree equals a brute force over its candidate lists.
* kNN-LM serving of gemma-2b at its registered width (18 layers, d_model
  2048, MQA with hd 256, vocab 256000, bf16), weights from a seeded
  generator: a flash prefill of 8 x 2048 tokens through K4 (flash
  attention, 18 launches per prefill), checked against the plain blockwise
  path; a datastore of 512 x 2047 = 1,048,064 entries built from the
  model's own hidden states with 256-bit ITQ codes; the continuous-batching
  server answering 16 requests with retrieval in every decode step; and
  one decode batch's retrieval through the fused select (K1 + K2), equal
  to the composite path the config's plan picks. K4 is held against its
  plain version on edge cases (ragged S, GQA, S=1, S on either side of
  the bf16 kernel's 64-key and 128-row tiles at hd 256 and 80) and at the
  main shape, and timed there on both routes: bf16 on the tensor cores
  (wgmma), f32 on the CUDA cores. The same model and store then serve under a
  ``DegradationPolicy`` with snapshots: a burst walks the ladder (exact,
  approx_rt95, approx_rt90, approx_rt80, retrieval_off) down and calm
  ticks walk it back, every rung visited and nothing lost; a fault
  injector fails retrieval until the server restores its store from the
  last snapshot; the server's shard layer (a ``FaultTolerantSearch`` of
  the store's codes) loses a unit mid-run, the server serves the degraded
  view of the covered rows, and the revived unit brings the full store
  back. Each approx rung's retrieval is timed at batch 8. Then
  the server serves a ``MutableStore`` of the same datastore (audited
  every 4 ticks) with a two-tenant arena attached, takes online appends
  and deletes between ticks, and answers a ``tenant_search`` equal to each
  tenant's own store.
* the recurrent families — zamba2-2.7b (54 Mamba2 blocks in 9 groups
  around one shared attention block of hd 80, d_model 2560, vocab 32000)
  and rwkv6-1.6b (24 RWKV6 layers, d_model 2048, vocab 65536), each at its
  registered width and depth in bf16 with seeded random weights: a flash
  prefill of 8 x 2048 (9 K4 launches for zamba2, none for rwkv6), zamba2's
  flash against its blockwise path, the chunked forward against prefill +
  one decode step at S = 300 (the scans' padded tails against the step
  recurrences), rwkv6's decode state equal in bytes at max_len 1024 and
  4096, a datastore of 128 x 2047 = 262,016 entries from the model's own
  hidden states, and the server answering 16 requests on 8 slots (every
  slot reused once): K-kernel launches per decode step as the plan says,
  requests on reused slots equal to each served alone on a fresh server,
  one decode batch's retrieval equal through the plan, fused (K1 + K2)
  and the board-scan composite (K3). K4 is also held against its plain
  version at hd 80 and 112 (S = 1, ragged 300 and 333, both dtypes) and
  at zamba2's prefill shape, and timed there.
* the dense, frontend and MoE families — internlm2-20b (48 layers,
  d_model 6144, GQA 48 / 8 heads of hd 128, vocab 92544, bf16, nothing
  cut) served as the recurrent archs are: a flash prefill of 8 x 2048 (48
  K4 launches, K4 timed at that shape beside SDPA and its bound), flash
  against the blockwise path (full depth in bf16 within 3x the run's own
  noise, a 2-layer f32 copy within 1e-4), a store CUT to 128 x 2047 =
  262,016 entries, 16 requests on 8 slots with the fused-vs-composite
  check; llava-next-mistral-7b and musicgen-medium whole, each a flash
  prefill of 8 x 2048 tokens after its prefix of synthetic embeddings
  (576 and 64 positions), and prefill + one decode step against forward
  at S + 1 (bf16 at full depth; 2-layer f32 copies); arctic-480b and
  kimi-k2 at full width DEPTH CUT to one layer each (one arch at a time):
  a flash prefill (hd 128 in groups of 7; hd 112 in groups of 8), the
  layer's MoE output on 256 sampled tokens against an independent f32
  recomputation (the route and the MLPs written out here, the expert ids
  equal to the program's route, only each token's K experts run), the
  aux loss >= 1,
  the expert loop's share of the layer's time, prefill + one decode step
  against forward; and ``moe.moe_forward`` over 2 gloo ranks on the card
  (arctic's width, experts CUT to 8 at capacity factor 8: nothing drops,
  f32): a2a and allgather against the reference within 1e-4 of its
  largest output, a2a_int8 within 0.05, with the transport each took.
  K4 is held against its plain version at every new (H, KV, hd): 48/8/128,
  48/1/128, 64/8/128, 56/8/128, 64/8/112 and 24/24/64, at S = 1 and 300,
  both dtypes.
* the approximate tier — ``approx_topk`` on the first path's store, in
  insertion order and (through the planner) in layout order, at recall
  targets 0.8, 0.9, 0.95, 0.99 and 1.0: ms, block rows, per-block L, the
  bound's predicted recall and the measured recall@16 against fused; at
  1.0 both equal fused bit-for-bit. The ``torch._int_mm`` score tile of
  one chunk is timed alone. On the index store: the masked approx probe
  of the IVF layout at nprobe 8 (rt 1.0) equals a brute force over the
  rows of its probed blocks on sampled queries, and ``asymmetric_topk``
  of the ITQ projections is timed with its recall against the exact
  Hamming search and the exact float neighbours.
* sharded search — the first path's store over 4 gloo ranks, each a
  process on the one card holding its 262,144-row slice
  (``engine.shard_datastore``), through ``engine.search_sharded``:
  hist_merge, hist_tree (fanout 2), concat_sort (k' = k and k' = 4),
  reorder_local, uneven shards (300,000 / 262,144 / 250,000 / 236,432 rows
  padded to a common slice), a dead shard, and the approx tier at recall
  targets 1.0 and 0.9. Every exact case equals the single-device fused
  search over the same rows (the surviving rows; the ranks' local_sort
  layouts side by side for reorder_local) on all 4096 queries, with one K1
  and one K2 launch per rank; per rank, the search and its phases (K1,
  histogram all_reduce, counts all-gather, K2, output all_reduce) are
  timed. Four ranks time-slice one card: this checks the merge and
  measures its cost, not scaling. Then ``FaultTolerantSearch`` over the
  same store (4 units at factor 2): healthy, units killed, injected
  shard_hist / shard_emit / merge_psum faults, maintain() back to full
  coverage and a cold revive, each answer equal to
  ``reference_over_covered`` and an on-card brute force.
* the mutable store — ``MutableStore.create`` over the first path's codes
  in a temporary root, 16 rounds of 4096 appends and 4096 deletes, flush,
  and one search (one K1 and one K2 launch) equal to a from-scratch
  engine over the live rows and to a brute force; then a crash without
  close, ``recover`` and ``audit``, and the same search again.
* the tenant arena — 8 tenants of uneven sizes (~2^20 rows in all, with
  pad rows, one tenant smaller than k) packed in one arena; a mixed batch
  of 4096 queries through one K1 and one K2 launch, each tenant equal to
  its own store's search, the run-split emit equal to the single-run one.
* training — gemma-2b at its registered width and depth (2,506,172,416
  bf16 parameters, f32 AdamW moments, remat on) through
  ``trainer.train`` for 4 steps of 8 x 2048 tokens in 4 microbatches
  (train_4k's 256 x 4096 cut for one card's memory and the time limit):
  per step loss, grad norm, lr and ms; tokens/s, train_mfu and peak
  memory; one more step under ``torch.profiler``. Every loss and grad
  norm finite, every parameter changed, params and moments on the card,
  no K1-K4 launch (training takes the blockwise attention path). Then a
  ``scaled_down`` f32 gemma: 3 ``make_train_step`` steps on the card and
  on the CPU from the same weights and batches, the losses and params
  within stated tolerances; and ``trainer.train`` preempted at step 3 and
  resumed from its checkpoint, equal to an uninterrupted run.
* training the other families — zamba2-2.7b (2,396,172,448 params) and
  rwkv6-1.6b (1,583,941,632) at registered width and depth through
  ``trainer.train`` as gemma-2b is (4 steps of 8 x 2048, here in 2
  microbatches; one microbatch profiled); the hybrid, RWKV6 and MoE
  (``scaled_down`` f32) on the card against the CPU for two seeds, each
  family with its limits and a TF32 control above them; kimi-k2's layer
  at full width (d_model 7168, expert d_ff 2048, vocab 163840), DEPTH
  CUT to one layer and its experts CUT to what fits ~60 GB with bf16
  weights and grads and f32 moments, 2 steps through ``moe_reference``,
  and an f32 copy cut further whose loss gradients on the card equal
  the CPU's; and ``make_train_step`` over 2 gloo ranks on the card
  (arctic's width, experts CUT to 8, f32, 2 x 512 tokens, 2 steps) under
  a2a, allgather and the int8 dispatch, each rank's parameters held
  against a one-device step on the same global batch. No K1-K4 launch.
* the launch tooling — ``launch/dryrun.py`` in a child process after the
  training phases (its fake worlds are process groups of their own), with
  nothing else running: gemma-2b x train_4k and
  internlm2-20b x prefill_32k (flash attention, 48 K4 calls counted) on
  the (16, 16) mesh and zamba2-2.7b x long_500k on (2, 16, 16), at full
  width, each cell's dominant roofline term, bound, per-device bytes and
  whether it fits; then gemma-2b's prefill of 8 x 2048 through K4, one
  decode step at the serving batch and a train step of 8 x 2048 in 4
  microbatches, each predicted there on fake CUDA tensors and run here:
  the FLOPs, bytes and kernel calls of the two runs equal (18 K4 calls,
  and launches, a prefill), the predicted train peak within 10 % of
  ``torch.cuda.max_memory_allocated``, and every roofline bound at most
  the measured median; measured/bound and useful_ratio printed.

Output: progress lines; ``main_path``, ``board_scan``, ``index_path``,
``sharded_path``, ``shard_faults``, ``serving_path``, ``recurrent_path``,
``dense_path``, ``frontend_path``, ``moe_path``, ``moe_ep``,
``approx_path``,
``mutable_path``, ``tenant_path``, ``train_path``, ``train_families``
and ``launch_tooling`` JSON lines;
a ``kernels`` JSON line (launches on the paths, error against the plain
version, kernel / plain / library ms, and the bound: the least time for
the operations or the HBM bytes, whichever is larger); the card's name and
power limit as nvidia-smi reports them; and, last, ``{"ok": true,
"device": {...}}``. Any failing phase exits non-zero and prints no result.
Without a CUDA device, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import datetime
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import carry, device, spans  # noqa: E402
from repro_torch.configs import (ShapeConfig, StepKind,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.configs import scaled_down  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.core import binary, index, layout, plan  # noqa: E402
from repro_torch.core import quantize, retrieval, topk  # noqa: E402
from repro_torch.core import engine, hierarchy, mutable, tenant  # noqa: E402
from repro_torch.dist import search as dsearch, steps  # noqa: E402
from repro_torch.kernels import _build, ops, tuning  # noqa: E402
from repro_torch.kernels import approx_select  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hamming as tham  # noqa: E402
from repro_torch.kernels import topk_select as tsel  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import frontends, layers, lm  # noqa: E402
from repro_torch.models import mamba2, moe, rwkv6  # noqa: E402
from repro_torch.optim import optimizer  # noqa: E402
from repro_torch.runtime import faults, server, trainer  # noqa: E402

N_ROWS = 1 << 20         # 1M codes: SIFT1M/GIST1M-class store
D_BITS = 256             # kNN-TagSpace: d = 256, k = 16, 4096 queries
K = 16
N_QUERIES = 4096
SIFT_BITS, SIFT_K = 128, 4   # kNN-SIFT: d = 128, k = 4 (K1/K2's W = 4 tile)
WORDEMBED_BITS, WORDEMBED_K = 64, 2   # kNN-WordEmbed: d = 64, k = 2 (W = 2)
# binary-quantised text embeddings: d = 1024, k = 40 (W = 32, bq = 16)
BINEMBED_BITS, BINEMBED_K = 1024, 40
N_CLUSTERS = 1024
FLIP_LOG2 = 4            # each code bit flips from its cluster centre w.p. 1/16
N_CHECK = 64             # queries held against the on-card brute force
N_TIMED = 5
# peak rates of one H100 SXM for the bound: CUDA-core popcounts (compute
# capability 9.0), shared-memory accesses (one per bank per clock); dense
# int8 and bf16 tensor-core operations and HBM bytes are the data sheet's
# (700 W), kept in launch/mesh.py
POPC_PER_CLK_SM = 16
INT8_OPS_PER_S = launch_mesh.PEAK_OPS_INT8
SMEM_OPS_PER_CLK_SM = 32
HBM_BYTES_PER_S = launch_mesh.HBM_BW
BF16_FLOPS_PER_S = launch_mesh.PEAK_FLOPS_BF16
DEV = "cuda"

# K3's main shape: the query batch against one board-sized chunk. The
# counting and bisect board scans take chunks of K3_CHUNK rows; composite
# takes COMPOSITE_CHUNK, the largest multiple of 1024 whose f32 keys
# dist * chunk + idx stay exact ((D_BITS + 1) * chunk < 2^24). So at
# N_ROWS = 2^20 they launch K3 16, 17 and 16 times.
K3_CHUNK = 1 << 16
COMPOSITE_CHUNK = 64512
BOARD_SELECTS = ("counting", "composite", "bisect")
N_BOARD_TIMED = 3
# the index path: a float store of N_ROWS x IDX_DIM, unit Gaussian spread
# around IDX_CENTRES centres drawn with spread IDX_CENTRE_STD
IDX_DIM = 256
IDX_CENTRES = 1024
IDX_CENTRE_STD = 1.0
IDX_ITQ_ITERS = 10
IVF_CLUSTERS, IVF_ITERS = 1024, 10
IVF_NPROBES, IVF_GATHER_NPROBE = (1, 8, 32), 8
LSH_TABLES, LSH_BITS = 4, 12
KD_TREES, KD_LEAF = 4, 512
PREFIX_NPROBE = 8
N_GATE = 16              # sampled queries held against each brute force

# the serving path: gemma-2b at its registered config, nothing cut
ARCH = "gemma-2b"
PREFILL_BATCH, PREFILL_LEN = 8, 2048
CORPUS_SEQS, CORPUS_BATCH = 512, 4     # 512 x 2047 = 1,048,064 entries
ITQ_ITERS = 8
N_REQUESTS, PROMPT_LEN, MAX_NEW = 16, 16, 32
SERVE_BATCH, SERVE_LEN = 8, 256
# flash vs the plain blockwise path. bf16, 18 layers: relative L2 of the
# final hidden state. 18 random-init layers amplify any rounding
# difference: on one H100 with seed 0, the blockwise path against itself
# at chunk 256 instead of 1024 (printed beside it) differs by 1.6e-2,
# flash by 2.0e-2, so the limit is 3e-2. f32, 2 layers: max |diff| of the final hidden state,
# where rounding no longer hides a wrong kernel.
FLASH_XLA_REL_L2_BF16 = 3e-2
FLASH_XLA_ATOL_F32 = 1e-4
# K4 vs its plain version: f32 atol; bf16 within 2 bf16 ulps of the plain
# output plus the f32 atol (both round one f32 value that differs only in
# summation order)
K4_ATOL_F32 = 1e-5
K4_BF16_ULPS = 2
# K4 at zamba2-2.7b's prefill: (B, H, KV, hd) of its shared attention
K4_ZAMBA2 = (PREFILL_BATCH, 32, 32, 80)

# the recurrent path: zamba2-2.7b (Mamba2 hybrid) and rwkv6-1.6b at their
# registered configs, nothing cut in width or depth. The store is cut from
# gemma's 512 sequences to 128 (128 x 2047 = 262,016 entries) for the run's
# time limit: its hidden states take one full-width forward per 4
# sequences through the eager chunk loops.
REC_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
REC_CORPUS_SEQS = 128
REC_TIMED = 3
# Random-init recurrent stacks amplify bf16 rounding far more than
# gemma's 18 layers: on one H100 with seed 0, zamba2's blockwise path
# against itself at attention chunk 256 instead of 1024 differs by
# 7.66e-2 in the final hidden state, flash by 9.63e-2, over serving_path's
# 3e-2. So each full-depth bf16 comparison here is gated at REC_NOISE_X
# times its own run's noise (the same function at another chunk size,
# printed beside it), never below the fixed floor; the kernels' and the
# scans' arithmetic is held tightly on short float32 copies at full width
# (REC_F32_LAYERS layers, TF32 off).
REC_NOISE_X = 3.0
# forward's logits at position S - 1 against prefill over S - 1 tokens and
# one decode step, S = 300 (a padded tail at both scan chunks, 128 and 64):
# relative L2 over the batch's (8, vocab) logits; the noise: the same
# forward at half the scan chunk (Mamba2 64, RWKV6 32)
REC_CHECK_LEN = 300
REC_REL_L2_BF16 = 3e-2
REC_F32_LAYERS = {"zamba2-2.7b": 6, "rwkv6-1.6b": 2}
REC_REL_L2_F32 = 1e-4
# requests on a reused slot served again alone on a fresh Server
REC_FRESH_CHECKS = 2

# the dense, frontend and MoE families. internlm2-20b is served at its
# registered width and depth, its store cut as the recurrent path's
# (128 x 2047 = 262,016 entries) for the run's time limit; K4 is timed at
# its prefill, (B, H, KV, hd)
DENSE_ARCH = "internlm2-20b"
DENSE_CORPUS_SEQS = 128
K4_DENSE = (PREFILL_BATCH, 48, 8, 128)
# llava-next-mistral-7b (576 prefix positions) and musicgen-medium (64),
# whole. prefill + one decode step against forward at S + 1: relative L2
# of the last logits, bf16 at full depth gated at REC_NOISE_X times the
# same forward through the blockwise path (the run's own noise), never
# below REC_REL_L2_BF16; float32 copies of DECODE_F32_LAYERS layers at
# DECODE_F32_LEN tokens (plus the prefix) within REC_REL_L2_F32
FRONTEND_ARCHS = ("llava-next-mistral-7b", "musicgen-medium")
DECODE_F32_LAYERS, DECODE_F32_LEN = 2, 300
# arctic-480b and kimi-k2 at full width, DEPTH CUT to MOE_LAYERS layer:
# neither fits one card whole (953.7 GB and 2.09 TB in bf16). The layer's
# bf16 MoE output on MOE_SAMPLE sampled tokens against an independent f32
# recomputation: the expert ids equal to the program's route, relative
# L2 within MOE_REL_L2 (bf16 rounds each product and the gate to 8
# significand bits: ~2e-3 a rounding). The aux loss is
# >= 1 (Cauchy-Schwarz; tests/test_models_parts.py)
MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
MOE_LAYERS, MOE_SAMPLE, MOE_REL_L2 = 1, 256, 2e-2
MOE_F32_EXPERTS = 16
MOE_AUX_MIN = 1 - 1e-3
# expert parallelism on EP_RANKS gloo ranks on the one card: arctic's
# d_model and expert_d_ff with the experts CUT to EP_EXPERTS at capacity
# factor EP_CF (nothing drops), f32 with TF32 off, EP_B x EP_S tokens of
# EP_X_SCALE x N(0, 1) (the scale of repro's int8 test,
# tests/test_perf_paths.py). a2a and allgather within EP_REL_MAX of the
# reference's largest |y|; a2a_int8 within repro's EP_INT8_ATOL absolute
EP_RANKS, EP_EXPERTS, EP_CF = 2, 8, 8.0
EP_B, EP_S, EP_X_SCALE = 2, 512, 0.1
EP_REL_MAX, EP_INT8_ATOL, EP_TIMED = 1e-4, 0.05, 3
EP_STRATEGIES = (("a2a", "a2a", False), ("allgather", "allgather", False),
                 ("a2a_int8", "a2a", True))
# S on either side of the bf16 kernel's tiles (64 keys, 64 rows a
# warpgroup, 128 a CTA)
K4_TILE_EDGES = (63, 64, 65, 127, 128, 129, 191, 257)
# the (H, KV, hd) the new families bring to K4: internlm2, granite (MQA),
# deepseek, arctic (groups of 7), kimi-k2 (hd 112), musicgen (MHA, hd 64)
K4_NEW_SHAPES = ((48, 8, 128), (48, 1, 128), (64, 8, 128), (56, 8, 128),
                 (64, 8, 112), (24, 24, 64))

# the approximate tier on the kNN cell: recall targets timed (1.0 is gated
# equal to fused), the masked approx probe of the IVF store, and the
# sampled queries given an exact float (L2) ground truth on the index store
APPROX_TARGETS = (0.8, 0.9, 0.95, 0.99, 1.0)
N_APPROX_TIMED = 3
APPROX_NPROBE = 8
L2_SAMPLE = 256
# the serving ladder: a burst of requests beyond the slots walks the
# DegradationPolicy's ladder down, calm ticks walk it back up
LADDER_REQUESTS, LADDER_NEW, LADDER_PROMPT = 24, 4, 4
LADDER_POLICY = dict(queue_high=2, queue_low=0, cooldown_ticks=2)
SNAPSHOT_EVERY = 8
# the server over a MutableStore of the serving datastore and a two-tenant
# arena: appends a round, rounds (the requests' new tokens), audit period,
# the tenants' rows
STORE_APPENDS, STORE_ROUNDS, STORE_AUDIT_EVERY = 64, 6, 4
STORE_TENANT_ROWS = 100_000
# the mutable store: rounds of appends and deletes over the kNN cell's codes
MUT_ROUNDS, MUT_BATCH = 16, 4096
# the tenant arena: 8 tenants' shares of ~N_ROWS rows (uneven, none a
# multiple of the arena's tile, the last smaller than k), tile rows
TENANT_SIZES = (314_573, 209_715, 157_287, 125_830, 104_857, 73_401,
                62_906, 7)
TENANT_BN = 1024
# the sharded path: the main store over SHARD_RANKS gloo ranks, all on the
# one card (NCCL puts one rank on one card; gloo takes CUDA tensors for
# all_reduce, which every collective of the merge is built from). Uneven
# shards hold these many rows of the store each, padded to the largest;
# SHARD_DEAD is the dead shard of the participation case
SHARD_RANKS, SHARD_AXES = 4, ("data",)
SHARD_UNEVEN = (300_000, 262_144, 250_000, 236_432)
SHARD_DEAD, SHARD_FANOUT, SHARD_KLOCAL = 2, 2, 4
SHARD_APPROX_RT = (1.0, 0.9)
SHARD_TIMED = 5
SHARD_TIMEOUT_S = 300          # a rank's collectives, and the whole phase
SHARD_PHASES = ("k1", "hist_reduce", "counts", "k2", "out_reduce")
# the shard-fault-tolerance layer over the main store: units, replication
FTS_UNITS, FTS_FACTOR = 4, 2
# training: gemma-2b at full width and depth through trainer.train, cut from
# train_4k (256 x 4096 tokens a step) to 8 x 2048 in 4 microbatches of 2 for
# one card's memory and the run's time limit; then a scaled_down f32 gemma
# (card against CPU, preemption and resume)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 2048, 8, 4, 4
TRAIN_SMALL_SEQ, TRAIN_SMALL_BATCH = 128, 8
TRAIN_CHECK_STEPS = 3
TRAIN_PREEMPT_AT, TRAIN_RESUME_STEPS, TRAIN_CKPT_EVERY = 3, 6, 2
# card against CPU, f32 with TF32 off, for two seeds: the first loss is
# taken before any update (summation order only); later losses and the
# final params after 3 AdamW steps at lr 3e-4. Adam's first step moves an
# entry by lr * g / (|g| + 1e-8), so an entry whose gradient is rounding
# noise near zero moves apart by up to 2 lr where its sign flips, and by
# a part of that where |g| is near 1e-8. A control (the first seed with
# TF32 on: 10-bit products) must read above every limit, so a limit that
# a lower precision passes fails the run. Each limit lies between the
# largest reading of seeds 0 and 1 and the control's, with a factor of 4
# or more to each (H100 80GB HBM3, 700 W; PERF.md §6): the losses read
# 4.77e-7 (one f32 ulp at 6.25) against 1.76e-5 at step 0 and 1.91e-5 at
# most; the params 3.02e-5 (seed 1, a part-flipped entry) against 7.16e-4
# (a flipped one)
TRAIN_CHECK_SEEDS = 2
TRAIN_LOSS0_ATOL, TRAIN_LOSS_ATOL, TRAIN_PARAM_ATOL = 2e-6, 4e-6, 1.5e-4
TRAIN_PROFILE_TOP = 12
# preempted and resumed against uninterrupted, both on the card: the same
# kernels on the same inputs; atomics in CUDA's index backward may reorder
# f32 sums, so the params are held within this bound (0 means bit-equal)
TRAIN_RESUME_ATOL = 1e-6


# training the other families: zamba2-2.7b and rwkv6-1.6b at registered
# width and depth through trainer.train, cut from train_4k as gemma is
# (TRAIN_SEQ x TRAIN_BATCH, TRAIN_STEPS steps), in TRAIN_REC_MICRO
# microbatches: their chunk loops are host-bound, so a microbatch's time
# hardly grows with its rows (zamba2 at 4 microbatches 14.6 s a step, at
# 2 9.2 s, peak 59.47 GB; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
TRAIN_REC_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
TRAIN_REC_MICRO = 2
# card against CPU for each new family (scaled_down, f32, TF32 off, seeds
# 0 and 1, the first seed with TF32 on as the control, which must read
# above every limit): each limit lies between the seeds' largest reading
# and the control's (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
# Readings (seeds / control): zamba2 loss0 4.77e-7 / 4.77e-7, loss
# 4.77e-7 / 8.30e-5, params 1.17e-4 / 1.06e-3; rwkv6
# 4.77e-7 / 4.77e-6, 4.77e-7 / 1.06e-4, 3.10e-5 / 1.02e-3; kimi-k2
# 4.77e-7 / 1.91e-6, 4.77e-7 / 2.08e-4, 7.47e-6 / 1.09e-3 (4.77e-7 is
# one f32 ulp at 6.25). The hybrid's first loss reads one ulp under TF32
# too, so no limit on it separates the two and it has none: its later
# losses and params carry the gate
TRAIN_FAMILY_LIMITS = {
    "zamba2-2.7b": {"loss_max_abs_err": 6e-6, "param_max_abs_err": 3.5e-4},
    "rwkv6-1.6b": {"loss0_abs_err": 1.5e-6, "loss_max_abs_err": 5e-6,
                   "param_max_abs_err": 1.5e-4},
    "kimi-k2-1t-a32b": {"loss0_abs_err": 1.2e-6, "loss_max_abs_err": 5e-6,
                        "param_max_abs_err": 1e-4},
}
# one MoE layer trained at full width: kimi-k2 (d_model 7168, expert d_ff
# 2048, vocab 163840), DEPTH CUT to 1 layer and the experts CUT to the
# count whose bf16 weights and grads and f32 moments (12 bytes a
# parameter; 16 for the f32 router's column), beside the rest of the
# layer and the embeddings, leave MOE_TRAIN_ACT_GB of MOE_TRAIN_BUDGET_GB
# for activations (40 experts peaked at 70.10 GB, 51.2 GB of them
# states: 19 GB of activations and workspace at 4 x 512 tokens; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6); MOE_TRAIN_STEPS steps
# of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ through moe_reference. Then an f32
# copy cut further (MOE_F32_TRAIN_EXPERTS experts, vocab
# MOE_F32_TRAIN_VOCAB) takes the loss gradients of one batch on the card
# and on the CPU: the loss within MOE_F32_LOSS_RTOL of itself, each
# gradient within MOE_F32_GRAD_RTOL of its leaf's largest entry; the same
# on the card with TF32 on is the control, above both limits
MOE_TRAIN_ARCH = "kimi-k2-1t-a32b"
MOE_TRAIN_BUDGET_GB, MOE_TRAIN_ACT_GB = 60.0, 19.0
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 512, 2
MOE_F32_TRAIN_EXPERTS, MOE_F32_TRAIN_VOCAB = 8, 16384
MOE_F32_TRAIN_B, MOE_F32_TRAIN_S = 2, 64
# read (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): loss 8.63e-8, gradients
# 2.00e-6; the control 1.12e-6 and 1.23e-3
MOE_F32_LOSS_RTOL, MOE_F32_GRAD_RTOL = 3e-7, 5e-5
# expert-parallel training on EP_RANKS gloo ranks on the one card, mesh
# (1, EP_RANKS) ("data", "model"): arctic's width, one layer, the experts
# CUT to EP_EXPERTS, f32 with TF32 off, EPT_STEPS steps of EPT_B x S
# tokens through make_train_step's "auto" strategy (EPT_CASES): a2a and
# a2a_int8 at S = EPT_S, allgather at the odd EPT_S_ODD, as ``repro``
# picks them; capacity factor EPT_CF, at which no entry can drop
# (checked); the aux loss's weight CUT to 0 (``_ept_cfg`` says why).
# Each rank's parameters after the steps against a one-device step on the
# same global batch (moe_reference, ``pure_dp``'s path): a2a and
# allgather within EPT_PARAM_RTOL of the largest |param|. a2a_int8 trains
# on ``repro``'s gradient of the int8 dispatch, which reaches the tokens
# and the experts' outputs through the per-slot scales alone (held
# against jax.vjp on the CPU), another gradient than the f32 step's: its
# first loss (before any update) within EPT_INT8_LOSS_RTOL of the
# one-device step's and the parameters the int8 codes do not reach
# (EPT_INT8_HELD) within EPT_INT8_MAX, the reach of two Adam steps each
# way at lr 3e-4, a coarse check. Then the card against the CPU, with the
# aux loss weighted: each case at scaled_down arctic (f32) on the same
# ranks, once on the card and once on CPU tensors with the card's
# all_reduce transport forced, for TRAIN_CHECK_SEEDS seeds, the first
# seed again on the card with TF32 on as the control, above every limit.
# a2a and allgather: TRAIN_CHECK_STEPS steps of EPT_SMALL_B x S
# (EPT_SMALL_S, or EPT_SMALL_S_ODD for allgather), each rank's
# parameters and the losses within EPT_CPU_LIMITS; the first loss reads
# within 2 f32 ulps under TF32 too, so it has no limit. a2a_int8: an int8
# code at a rounding tie flips between the card and the CPU, and the
# gradient's route through each slot's argmax then moves (and a flip
# upstream of a second layer moves its routes), so it is held on one
# layer, by the loss gradients of one batch: the loss within
# EPT_INT8_CPU_LIMITS, and in each leaf at most that share of the
# entries beyond EPT_INT8_GRAD_CUT of the leaf's largest
# Readings (seeds / control; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
# a2a losses 9.54e-7 / 5.47e-4, params 1.33e-5 / 1.02e-3; allgather
# 4.77e-7 / 4.24e-5, 1.19e-5 / 1.02e-3; first losses 4.77e-7 / 9.54e-7;
# a2a_int8's loss 1.91e-6 / 1.13e-4, share 1.53e-5 / 0.307
EPT_B, EPT_S, EPT_S_ODD, EPT_STEPS, EPT_CF = 2, 512, 511, 2, 4.0
EPT_CASES = (("a2a", EPT_S, False), ("allgather", EPT_S_ODD, False),
             ("a2a_int8", EPT_S, True))
EPT_PARAM_RTOL = 1e-4
EPT_INT8_HELD = ("blocks.0.moe.router", "blocks.0.moe.dense.",
                 "final_norm.", "embed.", "unembed.")
EPT_INT8_MAX, EPT_INT8_LOSS_RTOL = 1.2e-3, 1e-3
EPT_SMALL_B, EPT_SMALL_S, EPT_SMALL_S_ODD = 4, 64, 63
EPT_CPU_LIMITS = {"loss_max_abs_err": 6e-6, "param_max_abs_err": 1.2e-4}
EPT_INT8_GRAD_CUT = 1e-3
EPT_INT8_CPU_LIMITS = {"loss_abs_err": 1.5e-5, "grad_share": 2e-3}

# launch tooling: launch/dryrun.py in a child process (its fake worlds are
# process groups of their own) for three cells at full width on the
# production meshes, (arch, shape, multi_pod, attn_impl); then gemma-2b's
# prefill through K4, train step and decode step at this script's shapes,
# predicted on fake CUDA tensors there and run on the card here: the op
# counts of the two runs equal, the predicted train peak within
# LT_MEM_RTOL of max_memory_allocated, every roofline bound at most the
# measured median of LT_TIMED runs; the child gets LT_CHILD_TIMEOUT_S
LT_CELLS = (("gemma-2b", "train_4k", False, "xla"),
            ("internlm2-20b", "prefill_32k", False, "flash"),
            ("zamba2-2.7b", "long_500k", True, "xla"))
LT_TIMED = 3
LT_MEM_RTOL = 0.10
LT_CHILD_TIMEOUT_S = 900


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clustered_codes(rng, n: int, centers):
    """n codes, each a random centre with every bit flipped w.p. 2^-FLIP_LOG2
    (AND of FLIP_LOG2 random words) -> (n, W) uint32."""
    owner = rng.integers(0, centers.shape[0], size=n)
    noise = rng.integers(0, 1 << 32, size=(n, centers.shape[1]),
                         dtype=np.uint32)
    for _ in range(FLIP_LOG2 - 1):
        noise &= rng.integers(0, 1 << 32, size=noise.shape, dtype=np.uint32)
    return centers[owner] ^ noise


def clustered_store(rng, d: int, n_rows: int, n_queries: int):
    """Seeded clustered d-bit codes as the main path's: (queries, the
    store's codes in ``KNNEngine.with_layout()`` order), both on DEV."""
    centers = rng.integers(0, 1 << 32, size=(N_CLUSTERS, d // 32),
                           dtype=np.uint32)
    codes_np = clustered_codes(rng, n_rows, centers)
    q = carry.codes(clustered_codes(rng, n_queries, centers), DEV)
    return q, carry.engine(codes_np, d, device=DEV).with_layout().layout.codes


def cuda_ms(fn, reps: int):
    """(median ms of ``fn()`` over ``reps`` runs, each timed with CUDA
    events after one warm-up run; the last run's output)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def max_abs_diff(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 3: K1 and K2 against their plain versions
# ---------------------------------------------------------------------------

def kernel_case(name, q, x, bins, k, *, n_valid=None, mask_p=None,
                shard=None, geometry=(None, None), seed=0):
    """Run K1 then K2 on one case, kernel and plain on the same card inputs;
    returns (k1_err, k2_err). K1 runs split into the runs the main path
    would use and returns the per-run histograms too; K2 runs at that run
    count (bases from ``ops._run_bases``) and as one run, and both are held
    against the plain single-run emit. ``shard=(lo, hi)`` runs pass 2 on
    rows [lo, hi) of x with the slot and id bases the distributed select
    gives that shard (nonzero slot_base/id_base)."""
    Q, W = q.shape
    N = x.shape[0]
    lanes = max(bins, min(k, N))
    qp, xp, bq, bn = ops._topk_blocked(q, x, lanes, *geometry)
    nv = N if n_valid is None else n_valid
    tiles = (qp.shape[0] // bq, xp.shape[0] // bn)
    runs = tsel.default_runs(*tiles)
    en = torch.ones(tiles, dtype=torch.int32, device=DEV)
    mask = None
    if mask_p is not None:
        g = torch.Generator(device=DEV).manual_seed(seed)
        mask = (torch.rand(tiles, generator=g, device=DEV)
                < mask_p).to(torch.int32)
        en = mask
    hist_k, bmin_k, rh_k = tsel.hamming_hist_kernel(
        qp, xp, bins, nv, mask, bq=bq, bn=bn, runs=runs)
    hist_p, bmin_p, rh_p = tsel.hamming_hist_plain(qp, xp, bins, nv, en, bq,
                                                   bn, runs)
    torch.cuda.synchronize()
    k1 = max_abs_diff([(hist_k, hist_p), (bmin_k, bmin_p), (rh_k, rh_p)])

    cum = torch.cumsum(hist_k[:Q], dim=-1, dtype=torch.int32)
    _, r_star, n_lt, _ = ops._radius_from_cum(cum, min(k, N))
    pad = qp.shape[0] - Q
    r_p = torch.nn.functional.pad(r_star, (0, pad), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, pad))
    sb = torch.zeros_like(r_p)
    ib, xs, nvs, bms, ens, ms, rhs = 0, xp, nv, bmin_k, en, mask, rh_k
    if shard is not None:
        lo, hi = shard          # lo a multiple of bn: shard tiles are whole
        h0, _ = tsel.hamming_hist_kernel(qp, xp[:lo], bins, lo, None,
                                         bq=bq, bn=bn)
        c0 = torch.cumsum(h0[:Q], dim=-1, dtype=torch.int32)
        at = lambda c, i: torch.gather(c, 1, i[:, None].long())[:, 0]
        lt0 = torch.where(r_star > 0, at(c0, torch.clamp(r_star - 1, min=0)),
                          0)
        tie0 = at(h0[:Q], r_star)
        sb = torch.nn.functional.pad(lt0.to(torch.int32), (0, pad))
        nlt_p = torch.nn.functional.pad((n_lt + tie0).to(torch.int32),
                                        (0, pad))
        ib, xs, nvs = lo, xp[lo:hi], min(nv, hi) - lo
        j0, j1 = lo // bn, hi // bn
        bms, ens = bmin_k[:, j0:j1], en[:, j0:j1]
        ms = None if mask is None else mask[:, j0:j1]
        runs = tsel.default_runs(tiles[0], j1 - j0)
        _, _, rhs = tsel.hamming_hist_kernel(qp, xs, bins, nvs, ms, bq=bq,
                                             bn=bn, runs=runs)
    bases = ops._run_bases(rhs, r_p, nlt_p, sb)
    emit = lambda rb: tsel.hamming_emit_kernel(
        qp, xs, r_p, nlt_p, bins, k, nvs, block_min=bms, block_mask=ms,
        slot_base=sb, id_base=ib, bq=bq, bn=bn, run_bases=rb)
    d_r, i_r = emit(bases)
    d_1, i_1 = emit(None)
    d_p, i_p = tsel.hamming_emit_plain(qp, xs, r_p, nlt_p, bins, k, nvs,
                                       bms.contiguous(), ens.contiguous(),
                                       sb, ib, bq, bn)
    torch.cuda.synchronize()
    k2 = max_abs_diff([(d_r, d_p), (i_r, i_p), (d_1, d_p), (i_1, i_p)])
    print(f"  case {name}: Q={Q} N={N} W={W} bins={bins} k={k} "
          f"bq={bq} bn={bn} runs={runs} K1 err={k1} K2 err={k2} "
          f"(at {runs} runs and at 1)", flush=True)
    return k1, k2


def run_cases(main_q, main_x, sift_q, sift_x, we_q, we_x):
    """K1/K2 against their plain versions on the edge cases, the first
    256 queries of each main-shape store (d=256 ``main_*``, d=128
    ``sift_*``, d=64 ``we_*``) over all of its rows, and the whole select
    on the card against the CPU. -> (K1 err, K2 err), the largest of any
    case."""
    rng = np.random.default_rng(1)

    def rand_codes(n, d):
        return carry.codes(rng.integers(0, 1 << 32, size=(n, -(-d // 32)),
                                        dtype=np.uint32), DEV)

    k1 = k2 = 0
    cases = [
        ("main-shape 256 queries x all rows", main_q[:256], main_x, 257, K,
         {}),
        ("ragged N", rand_codes(40, 96), rand_codes(5000, 96), 97, 10, {}),
        ("n_valid < N", rand_codes(64, 256), rand_codes(5000, 256), 257, 16,
         {"n_valid": 3000}),
        ("block_mask with zeros", rand_codes(96, 256), rand_codes(9000, 256),
         257, 16, {"mask_p": 0.5, "geometry": (32, 504)}),
        ("slot_base/id_base (shard 2 of 2)", rand_codes(64, 256),
         rand_codes(8000, 256), 257, 16,
         {"shard": (4032, 8064), "geometry": (32, 504)}),
        ("heavy ties d=8 k=3", rand_codes(4, 8) & 0xFF,
         rand_codes(4096, 8) & 0xFF, 9, 3, {}),
        ("heavy ties d=8 k=512", rand_codes(4, 8) & 0xFF,
         rand_codes(4096, 8) & 0xFF, 9, 512, {}),
        ("k > N", rand_codes(3, 64), rand_codes(37, 64), 65, 50, {}),
        ("wide codes d=384 (generic width)", rand_codes(48, 384),
         rand_codes(3000, 384), 385, 16, {}),
        ("bq=64 (65.8 KB shared histogram, two queries per warp)",
         rand_codes(100, 256), rand_codes(3000, 256), 257, 16,
         {"geometry": (64, 512)}),
        ("a decode batch: 8 queries, bq=8 (half of one m16 fragment)",
         rand_codes(8, 256), rand_codes(5000, 256), 257, 16, {}),
        ("24 queries, bq=24 (one and a half m16 fragments)",
         rand_codes(24, 256), rand_codes(5000, 256), 257, 16, {}),
    ]
    # d = 128 (W = 4) on its tensor-core tile, the same edges
    cases += [
        ("d=128 main-shape 256 queries x all rows", sift_q[:256], sift_x,
         129, SIFT_K, {}),
        ("d=128 ragged N", rand_codes(40, 128), rand_codes(5001, 128), 129,
         SIFT_K, {}),
        ("d=128 n_valid < N", rand_codes(64, 128), rand_codes(5000, 128),
         129, 16, {"n_valid": 3000}),
        ("d=128 block_mask with zeros", rand_codes(96, 128),
         rand_codes(9000, 128), 129, 16,
         {"mask_p": 0.5, "geometry": (32, 504)}),
        ("d=128 slot_base/id_base (shard 2 of 2)", rand_codes(64, 128),
         rand_codes(8000, 128), 129, 16,
         {"shard": (4032, 8064), "geometry": (32, 504)}),
        ("d=128 bq=64 (four m16 fragments)", rand_codes(100, 128),
         rand_codes(3000, 128), 129, 16, {"geometry": (64, 512)}),
        ("d=128 bq=24 (one and a half m16 fragments)", rand_codes(24, 128),
         rand_codes(5000, 128), 129, 16, {}),
        ("d=128 bq=8 (half of one m16 fragment)", rand_codes(8, 128),
         rand_codes(5000, 128), 129, 16, {}),
    ]
    # d = 64 (W = 2) on its m16n8k128 tile, the same edges, and ties at r*
    # in groups of ~600 equal rows with 2 slots
    few = rand_codes(8, 64)
    cases += [
        ("d=64 main-shape 256 queries x all rows", we_q[:256], we_x, 65,
         WORDEMBED_K, {}),
        ("d=64 ragged N", rand_codes(40, 64), rand_codes(5001, 64), 65,
         WORDEMBED_K, {}),
        ("d=64 n_valid < N", rand_codes(64, 64), rand_codes(5000, 64), 65,
         16, {"n_valid": 3000}),
        ("d=64 block_mask with zeros", rand_codes(96, 64),
         rand_codes(9000, 64), 65, 16,
         {"mask_p": 0.5, "geometry": (32, 504)}),
        ("d=64 slot_base/id_base (shard 2 of 2)", rand_codes(64, 64),
         rand_codes(8000, 64), 65, 16,
         {"shard": (4032, 8064), "geometry": (32, 504)}),
        ("d=64 bq=64 (four m16 fragments)", rand_codes(100, 64),
         rand_codes(3000, 64), 65, 16, {"geometry": (64, 512)}),
        ("d=64 bq=24 (one and a half m16 fragments)", rand_codes(24, 64),
         rand_codes(5000, 64), 65, 16, {}),
        ("d=64 bq=8 (half of one m16 fragment)", rand_codes(8, 64),
         rand_codes(5000, 64), 65, 16, {}),
        ("d=64 heavy ties k=2 (8 distinct rows)",
         torch.cat([few[:4], rand_codes(28, 64)]),
         few[torch.from_numpy(rng.integers(0, 8, 5000)).to(DEV)], 65,
         WORDEMBED_K, {}),
    ]
    for name, q, x, bins, k, kw in cases:
        a, b = kernel_case(name, q, x, bins, k, **kw)
        k1, k2 = max(k1, a), max(k2, b)

    # the whole select on the card against the same select on the CPU
    for Q, N, d, k in ((33, 4097, 160, 24), (33, 4097, 128, SIFT_K),
                       (33, 4097, 64, WORDEMBED_K)):
        q, x = rand_codes(Q, d), rand_codes(N, d)
        gd, gi, _ = ops.hamming_topk(q, x, k, d + 1, return_stats=True)
        cd, ci, _ = ops.hamming_topk(q.cpu(), x.cpu(), k, d + 1, bq=32,
                                     bn=1032, return_stats=True)
        if not (torch.equal(gd.cpu(), cd) and torch.equal(gi.cpu(), ci)):
            raise AssertionError(f"hamming_topk on the card != on the CPU "
                                 f"(d={d})")
        print(f"  hamming_topk card == cpu ({Q} x {N}, d={d}, k={k}): ok",
              flush=True)
    return k1, k2


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def brute_force_check(eng, q, dd, ii, sample, k=K):
    """Distances of the sampled queries == the on-card brute force; every
    returned id is a distinct row at exactly its reported distance."""
    qs = q[sample]
    full = binary.hamming_xor(qs, eng.codes)                 # (S, N)
    ref_d, _ = topk.topk_ref(full, k)
    if not torch.equal(ref_d, dd[sample]):
        raise AssertionError("distances differ from the brute force")
    ids = ii[sample].long()
    if int(ids.min()) < 0 or int(ids.max()) >= eng.n:
        raise AssertionError("ids out of range")
    if not torch.equal(torch.gather(full, 1, ids), dd[sample]):
        raise AssertionError("an id's distance differs from its reported one")
    srt = torch.sort(ids, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError("duplicate ids in a row")


def drive(label, eng, q, sample, **kw):
    """One search with the launch counts zeroed just before and read just
    after; checks, then the median of N_TIMED timed searches."""
    tsel.reset_launch_counts()
    dd, ii = eng.search(q, K, **kw)
    torch.cuda.synchronize()
    launches = {"K1": tsel.hamming_hist_kernel.launches,
                "K2": tsel.hamming_emit_kernel.launches}
    if launches != {"K1": 1, "K2": 1}:
        raise AssertionError(f"{label}: launches {launches}, expected one "
                             f"each per search")
    if tuple(dd.shape) != (N_QUERIES, K) or tuple(ii.shape) != (N_QUERIES, K):
        raise AssertionError(f"{label}: result shape {tuple(dd.shape)}")
    brute_force_check(eng, q, dd, ii, sample)
    ms, _ = cuda_ms(lambda: eng.search(q, K, **kw), N_TIMED)
    print(f"  {label}: launches {launches}, brute-force check ok, "
          f"median search {ms:.3f} ms, {N_QUERIES / ms * 1e3:.0f} queries/s",
          flush=True)
    return launches, ms, (dd, ii)


def binembed_path(seed: int, routes: dict):
    """1024-bit codes, k = 40, at 4096 x 2^20 seeded clustered codes, in
    16-row query blocks (K1's 65.6 KB shared histogram). K1/K2 from each
    of ``routes`` ({name: library}, the committed one first; names from
    ``ROUTE_SHARE``): bit for bit against their plain versions with their
    times (``kernel_timings``), the share of tiles counted on the CUDA
    cores held to the route's, then timed in turns twice, the second time
    in the reverse order; then ``KNNEngine(codes, 1024).with_layout()
    .search(q, 40)`` on the committed library with one K1 and one K2
    launch, its sampled rows held to the on-card brute force, and its
    median time. -> the committed route's kernel_timings dict with the
    search's, the two turns (``route_comparison``'s), the queries and the
    layout-ordered codes."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 1 << 32, size=(N_CLUSTERS, BINEMBED_BITS // 32),
                           dtype=np.uint32)
    codes_np = clustered_codes(rng, N_ROWS, centers)
    q = carry.codes(clustered_codes(rng, N_QUERIES, centers), DEV)
    t0 = time.perf_counter()
    eng = carry.engine(codes_np, BINEMBED_BITS, device=DEV).with_layout()
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    dk = dict(d=BINEMBED_BITS, k=BINEMBED_K)
    timings = {}
    for name, lib in routes.items():
        with topk_library(lib):
            timings[name] = kernel_timings(
                q, eng.layout.codes,
                f"d={BINEMBED_BITS} k={BINEMBED_K} layout order {name}", **dk)
        t = timings[name]
        if t["k1_err"] or t["k2_err"]:
            raise AssertionError(f"d={BINEMBED_BITS} route {name}: kernel != "
                                 f"plain (K1 {t['k1_err']} K2 {t['k2_err']})")
        if t["cudacore_share"] != ROUTE_SHARE[name]:
            raise AssertionError(f"d={BINEMBED_BITS} route {name}: "
                                 f"{t['cudacore_share']} % of tiles counted "
                                 f"on the CUDA cores")
    turns = [route_comparison(q, eng.layout.codes, libs, **dk)
             for libs in (routes, dict(reversed(routes.items())))]
    kt = timings[next(iter(routes))]
    sample = torch.from_numpy(rng.choice(N_QUERIES, N_CHECK,
                                         replace=False)).to(DEV)
    tsel.reset_launch_counts()
    dd, ii = eng.search(q, BINEMBED_K)
    torch.cuda.synchronize()
    launches = (tsel.hamming_hist_kernel.launches,
                tsel.hamming_emit_kernel.launches)
    if launches != (1, 1):
        raise AssertionError(f"d={BINEMBED_BITS}: launches {launches}, "
                             f"expected one K1 and one K2 per search")
    brute_force_check(eng, q, dd, ii, sample, BINEMBED_K)
    ms, _ = cuda_ms(lambda: eng.search(q, BINEMBED_K), N_TIMED)
    print(f"  d={BINEMBED_BITS} k={BINEMBED_K} with_layout().search: layout "
          f"built in {layout_s:.2f} s, launches {launches}, brute-force "
          f"check ok, median search {ms:.3f} ms, "
          f"{N_QUERIES / ms * 1e3:.0f} queries/s", flush=True)
    return {**kt, "search_ms": ms, "layout_s": layout_s, "turns": turns,
            "q": q, "codes": eng.layout.codes}


def k2_pruned_check(q, x, d=D_BITS, k=K):
    """One ``hamming_topk(return_stats=True)`` at k and d + 1 bins (the
    main path's by default) under a CPU-only profiler, which turns K2's
    counter on: K2's own count of the tiles its guard skipped, and the
    tiles of its pass, held to the stats' host-side mirror; K1's tiles
    equal to K2's. -> (pruned, tiles, the share of K1's and K2's tiles
    that their launches counted as taking the CUDA-core kernels, %)."""
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, _, st = ops.hamming_topk(q, x, k, d + 1, return_stats=True)
    counters = spans.snapshot()["counters"]
    spans.reset()
    own = (counters[spans.K2_TILES_PRUNED], counters[spans.K2_TILES])
    mirror = (int(st["blocks_skipped"]), st["blocks_total"])
    if own != mirror:
        raise AssertionError(f"K2's own (pruned, tiles) {own} != "
                             f"return_stats' {mirror}")
    if counters[spans.K1_TILES] != own[1]:
        raise AssertionError(f"K1's tiles {counters[spans.K1_TILES]} != "
                             f"K2's {own[1]}")
    cudacore = (counters[spans.K1_TILES_CUDACORE]
                + counters[spans.K2_TILES_CUDACORE])
    return (*own, 100.0 * cudacore / (2 * own[1]))


def kernel_timings(q, x, stats_label, with_plain=True, d=D_BITS, k=K):
    """K1/K2 at the main path's inputs (d-bit codes, k, d + 1 bins), run as
    the main path runs them (K1 with its per-run histograms, K2 from the
    run bases): their times; K2 also as one run. with_plain also the plain
    versions' times, and the kernels' outputs (hist, block_min, per-run
    histograms; dists, ids at the main run count and at one run) held
    bit-for-bit against theirs; the pass-2 skip share, K2's own count of it
    held to ``return_stats``' and the share of the tiles counted as taking
    the CUDA-core kernels (``k2_pruned_check``); and the work both passes
    must do."""
    Q, W = q.shape
    N = x.shape[0]
    bins = d + 1
    qp, xp, bq, bn = ops._topk_blocked(q, x, bins, None, None)
    tiles = (qp.shape[0] // bq, xp.shape[0] // bn)
    runs = tsel.default_runs(*tiles)
    ones = torch.ones(tiles, dtype=torch.int32, device=DEV)
    hist, bmin, run_hist = tsel.hamming_hist_kernel(
        qp, xp, bins, N, bq=bq, bn=bn, runs=runs)
    cum = torch.cumsum(hist[:Q], dim=-1, dtype=torch.int32)
    _, r_star, n_lt, _ = ops._radius_from_cum(cum, k)
    r_p = torch.nn.functional.pad(r_star, (0, qp.shape[0] - Q), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, qp.shape[0] - Q))
    zeros = torch.zeros_like(r_p)
    bases = ops._run_bases(run_hist, r_p, nlt_p)

    k1_ms, k1_out = cuda_ms(lambda: tsel.hamming_hist_kernel(
        qp, xp, bins, N, bq=bq, bn=bn, runs=runs), N_TIMED)
    emit = lambda rb: tsel.hamming_emit_kernel(
        qp, xp, r_p, nlt_p, bins, k, N, block_min=bmin, bq=bq, bn=bn,
        run_bases=rb)
    k2_ms, k2_out = cuda_ms(lambda: emit(bases), N_TIMED)
    k2_one_ms, k2_one = cuda_ms(lambda: emit(None), N_TIMED)
    k1_plain = k2_plain = k1_err = k2_err = None
    if with_plain:
        k1_plain, p1 = cuda_ms(lambda: tsel.hamming_hist_plain(
            qp, xp, bins, N, ones, bq, bn, runs), 1)
        k2_plain, p2 = cuda_ms(lambda: tsel.hamming_emit_plain(
            qp, xp, r_p, nlt_p, bins, k, N, bmin, ones, zeros, 0, bq, bn), 1)
        k1_err = max_abs_diff(zip(k1_out, p1))
        k2_err = max_abs_diff([*zip(k2_out, p2), *zip(k2_one, p2)])

    # the work: K1 every (query, row) pair; K2 the pairs of the tiles it
    # does not skip. Bytes: each input read once, each output written once.
    max_r = r_p.reshape(-1, bq).amax(dim=1)
    live = bmin <= max_r[:, None]
    skipped = 1.0 - float(live.float().mean())
    k2_pruned, k2_tiles, cudacore = k2_pruned_check(q, x, d, k)
    q_real = torch.clamp(Q - torch.arange(tiles[0], device=DEV) * bq,
                         0, bq)
    n_real = torch.clamp(N - torch.arange(tiles[1], device=DEV) * bn,
                         0, bn)
    k2_pairs = int((live * q_real[:, None] * n_real[None, :]).sum())
    rows_read = int((live.any(dim=0) * n_real).sum())
    k1_bytes = 4 * (Q * W + N * W + Q * bins + bmin.numel())
    k2_bytes = 4 * (Q * W + rows_read * W + 2 * bmin.numel() + 3 * Q
                    + 2 * Q * k)
    print(f"  {stats_label}: geometry bq={bq} bn={bn} "
          f"tiles={tiles} runs={runs}; K1 {k1_ms:.3f} ms (plain {k1_plain} "
          f"ms), K2 {k2_ms:.3f} ms at {runs} runs, {k2_one_ms:.3f} ms at 1 "
          f"(plain {k2_plain} ms), pass-2 blocks_skipped {skipped:.4f}, "
          f"K2's own count {k2_pruned} of {k2_tiles} == return_stats'; "
          f"tiles on the CUDA cores {cudacore:.1f} %; "
          f"full-shape kernel vs plain: K1 err={k1_err} K2 err={k2_err}",
          flush=True)
    return {"k1_ms": k1_ms, "k2_ms": k2_ms, "k2_one_run_ms": k2_one_ms,
            "k1_plain": k1_plain, "k2_plain": k2_plain, "k1_err": k1_err,
            "k2_err": k2_err, "skipped": skipped, "k2_pruned": k2_pruned,
            "cudacore_share": cudacore,
            "runs": runs, "W": W,
            "k1_pairs": Q * N, "k2_pairs": k2_pairs, "k1_bytes": k1_bytes,
            "k2_bytes": k2_bytes}


# K1/K2 at d = 1024, 256, 128 and 64 on each route: the committed
# tensor-core kernels, and the CUDA-core ones (the design they had before,
# still the route of other widths and of query blocks wider than the
# tile's) built from the same source with the tensor-core dispatch taken
# out; and the share of tiles each route's launches count as taking the
# CUDA-core kernels
W8_ROUTE = "b1 (mma.sync AND-popc)"
POPC_ROUTE = "popc (CUDA cores)"
POPC_VARIANT = [("return tc_width(nw) && bq <= tc_max_bq(nw);", "return 0;")]
ROUTE_SHARE = {W8_ROUTE: 0.0, POPC_ROUTE: 100.0}


def start_variants(source: str, variants: dict):
    """Start one nvcc for each {name: [(old, new), ...]} text substitution
    of ``source`` (every occurrence replaced; each old text must occur);
    ``finish_variants`` waits for them."""
    text = (_build.CSRC / source).read_text()
    _build.BUILD.mkdir(exist_ok=True)
    started = {}
    for i, (name, subs) in enumerate(variants.items()):
        body = text
        for old, new in subs:
            if old not in body:
                raise RuntimeError(f"{old!r} not in {source}")
            body = body.replace(old, new)
        cu = _build.BUILD / f"variant{i}-{Path(source).stem}.cu"
        cu.write_text(body)
        so = cu.with_suffix(".so")
        started[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return started


def finish_variants(started) -> dict:
    """{name: loaded library with topk_select's argument types}; each
    library keeps nvcc's output as ``nvcc_log``."""
    libs = {}
    for name, (proc, so) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in tsel.ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib._argtypes_set = True
        lib.nvcc_log = log
        libs[name] = lib
    return libs


@contextlib.contextmanager
def topk_library(lib):
    """K1/K2's wrappers launch from ``lib`` inside the block."""
    committed = tsel._lib()
    _build._LIBS[tsel._SOURCE] = lib
    try:
        yield
    finally:
        _build._LIBS[tsel._SOURCE] = committed


def route_comparison(q, x, libs, reps=N_TIMED, check=True, quiet=False,
                     d=D_BITS, k=K):
    """K1 and K2 at the main path's inputs (d-bit codes, k, d + 1 bins)
    from each {name: library} in turn (each one's median of ``reps``; K2 at
    the main run count and as one run), their outputs held bit-for-bit
    against the committed library's (which ``kernel_timings`` holds against
    the plain versions). Returns {name: {"k1_ms", "k2_ms",
    "k2_one_run_ms"}}. ``check=False`` only times (for builds whose outputs
    are wrong by design); ``quiet`` prints nothing."""
    Q, N = q.shape[0], x.shape[0]
    bins = d + 1
    qp, xp, bq, bn = ops._topk_blocked(q, x, bins, None, None)
    runs = tsel.default_runs(qp.shape[0] // bq, xp.shape[0] // bn)
    hist, bmin, run_hist = tsel.hamming_hist_kernel(
        qp, xp, bins, N, bq=bq, bn=bn, runs=runs)
    _, r_star, n_lt, _ = ops._radius_from_cum(
        torch.cumsum(hist[:Q], dim=-1, dtype=torch.int32), k)
    r_p = torch.nn.functional.pad(r_star, (0, qp.shape[0] - Q), value=-1)
    nlt_p = torch.nn.functional.pad(n_lt, (0, qp.shape[0] - Q))
    bases = ops._run_bases(run_hist, r_p, nlt_p)
    emit = lambda rb=bases: tsel.hamming_emit_kernel(
        qp, xp, r_p, nlt_p, bins, k, N, block_min=bmin, bq=bq, bn=bn,
        run_bases=rb)
    ref1, ref2 = (hist, bmin, run_hist), emit()
    out = {}
    for name, lib in libs.items():
        with topk_library(lib):
            k1_ms, o1 = cuda_ms(lambda: tsel.hamming_hist_kernel(
                qp, xp, bins, N, bq=bq, bn=bn, runs=runs), reps)
            k2_ms, o2 = cuda_ms(emit, reps)
            k2_one_ms, o3 = cuda_ms(lambda: emit(None), reps)
        err = max_abs_diff([*zip(o1, ref1), *zip(o2, ref2), *zip(o3, ref2)])
        if err and check:
            raise AssertionError(f"{name} differs from the committed "
                                 f"kernels: err {err}")
        out[name] = {"k1_ms": k1_ms, "k2_ms": k2_ms,
                     "k2_one_run_ms": k2_one_ms}
    if quiet:
        return out
    print(f"route comparison (K1, K2 at {Q} x {N}, d={d}, k={k}; committed "
          f"{W8_ROUTE}): " + "; ".join(
              f"{name} K1 {v['k1_ms']:.3f} ms K2 {v['k2_ms']:.3f} ms "
              f"({v['k2_one_run_ms']:.3f} as one run)"
              for name, v in out.items()), flush=True)
    return out


def bound_ms(pairs: int, words: int, hist_adds: int, nbytes: int,
             sms: int, clk_hz: float):
    """Least time the card could take to score ``pairs`` (query, row)
    pairs of ``words``-word codes, add ``hist_adds`` histogram counts and
    move ``nbytes``. The distances take the faster of two routes: ``words``
    popcounts per pair on the CUDA cores, or a +-1 int8 plane product
    (2 * 32 * words operations per pair) on the tensor cores. Histogram
    counts take at least one shared-memory access each.
    Returns (ms, "operations" or "bytes", what sets the time)."""
    t_popc = pairs * words / (POPC_PER_CLK_SM * sms * clk_hz)
    t_int8 = 2 * pairs * 32 * words / INT8_OPS_PER_S
    t = min((t_popc, "popcounts on the CUDA cores"),
            (t_int8, "int8 plane product on the tensor cores"))
    t = max(t, (hist_adds / (SMEM_OPS_PER_CLK_SM * sms * clk_hz),
                "shared-memory histogram counts"),
            (nbytes / HBM_BYTES_PER_S, "HBM bytes"))
    return t[0] * 1e3, ("bytes" if t[1] == "HBM bytes" else "operations"), t[1]


# ---------------------------------------------------------------------------
# phase 3b: K3 against its plain version; phase 5b: the board scan
# ---------------------------------------------------------------------------

def run_k3_cases(main_q, main_x):
    """K3 through ``ops.hamming_distance`` (padding, slicing) against the
    plain version on the same card inputs; returns the max |err|."""
    rng = np.random.default_rng(2)

    def words(n, w):
        return carry.codes(rng.integers(0, 1 << 32, size=(n, w),
                                        dtype=np.uint32), DEV)

    ones = torch.full((33, 8), -1, dtype=torch.int32, device=DEV)
    cases = [(f"33 x 4097, W={w}", words(33, w), words(4097, w), {})
             for w in (1, 5, 8)]
    cases += [
        ("all-ones query words (top bit set), W=8", ones, words(4097, 8), {}),
        ("Q, N off the tile (100 x 1000, bq=64, bn=256), W=4",
         words(100, 4), words(1000, 4), {"bq": 64, "bn": 256}),
        ("generic width W=12", words(40, 12), words(3000, 12), {}),
        (f"main shape {main_q.shape[0]} x {main_x.shape[0]}, W=8", main_q,
         main_x, {}),
    ]
    err = 0
    for name, q, x, kw in cases:
        out = ops.hamming_distance(q, x, **kw)
        ref = tham.hamming_distance_plain(q, x)
        torch.cuda.synchronize()
        e = max_abs_diff([(out, ref)])
        print(f"  K3 case {name}: err={e}", flush=True)
        err = max(err, e)
    return err


def int_mm_distances(qb: torch.Tensor, xbt: torch.Tensor, d: int):
    """The library route to K3's output: the +-1 int8 plane product
    (``torch._int_mm``, int32 sums) and its affine (d - dot) / 2."""
    dot = torch._int_mm(qb, xbt)
    return dot.neg_().add_(d).bitwise_right_shift_(1)


def k3_timings(q, x, sms, clk_hz):
    """K3, its plain version and the ``torch._int_mm`` route at the main
    shape (the library route is checked equal and timed only; the port
    never calls it), and the bound: the (Q, N) int32 output plus the codes
    once through HBM, or the distances' operations, whichever is larger."""
    Q, W = q.shape
    N = x.shape[0]
    bq, bn = tuning.distance_blocks(Q, N, W, backend="gpu")
    ms, out = cuda_ms(lambda: tham.hamming_distance_kernel(q, x, bq=bq,
                                                           bn=bn), N_TIMED)
    plain_ms, ref = cuda_ms(lambda: tham.hamming_distance_plain(q, x), 1)
    err = max_abs_diff([(out, ref)])
    del ref
    pm = lambda c: (binary.unpack_bits(c, 32 * W).to(torch.int8) * 2 - 1)
    # x's planes enter as the column-major (d, N) view of the row-major
    # (N, d) planes: the TN layout of cuBLASLt's int8 GEMM
    qb, xbt = pm(q), pm(x).t()
    lib_ms, lib = cuda_ms(lambda: int_mm_distances(qb, xbt, 32 * W), N_TIMED)
    if not torch.equal(lib, out):
        raise AssertionError("the _int_mm route's distances != K3's")
    del lib, out, qb, xbt
    nbytes = 4 * (Q * W + N * W + Q * N)
    b, by, route = bound_ms(Q * N, W, 0, nbytes, sms, clk_hz)
    print(f"  K3 at the main shape (Q={Q} N={N} W={W}, bq={bq} bn={bn}): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, _int_mm (x planes "
          f"column-major) + affine {lib_ms:.3f} ms; bound {b:.4f} ms set by {route} "
          f"({nbytes / 2**30:.3f} GiB); kernel vs plain err={err}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b, "bound_by": by, "bound_route": route, "err": err}


def board_scan(flat, q, fused):
    """The paper-faithful board scan: ``KNNEngine.search(method="pallas")``
    under each materializing select, K3 once per chunk; each must equal
    the fused result bit-for-bit. Launch counts are read from a run with
    the counts zeroed just before it."""
    out = {}
    for select in BOARD_SELECTS:
        geo = flat.query_plan(q, K, method="pallas",
                              select=select).geometry()
        chunk = min(COMPOSITE_CHUNK if select == "composite" else K3_CHUNK,
                    flat.n)
        want = -(-flat.n // chunk)
        if (geo["chunk"], geo["n_chunks"]) != (chunk, want):
            raise AssertionError(f"board scan {select}: the plan takes "
                                 f"{geo['n_chunks']} chunks of "
                                 f"{geo['chunk']} rows, not {want} of "
                                 f"{chunk}")
        tham.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            dd, ii = flat.search(q, K, method="pallas", select=select)
            torch.cuda.synchronize()
            launches = tham.hamming_distance_kernel.launches
            if launches != want:
                raise AssertionError(f"board scan {select}: K3 launched "
                                     f"{launches} times for {want} chunks")
            if not (torch.equal(dd, fused[0]) and torch.equal(ii, fused[1])):
                raise AssertionError(f"board scan {select} != fused")
            ms, _ = cuda_ms(lambda: flat.search(q, K, method="pallas",
                                                select=select), N_BOARD_TIMED)
        print(f"  board scan, select={select}: {geo['n_chunks']} chunks of "
              f"{geo['chunk']} rows, K3 launches {launches}, == fused on all "
              f"{q.shape[0]} queries; median search {ms:.3f} ms, "
              f"{q.shape[0] / ms * 1e3:.0f} queries/s", flush=True)
        out[select] = {"chunk": geo["chunk"], "k3_launches": launches,
                       "search_ms": ms,
                       "queries_per_s": q.shape[0] / ms * 1e3}
    return out


# ---------------------------------------------------------------------------
# phase 5c: index-probed search
# ---------------------------------------------------------------------------

def recall_at(ids, exact):
    """Mean share of each query's exact top-k ids among its returned ids."""
    hit = (ids[:, :, None] == exact[:, None, :]).any(dim=1)
    return float(hit.float().mean())


def check_masked(label, lay, q, dd, ii, probe, cand_ids, sample):
    """For each sampled query, the blocks its query block may scan are
    worked out here on the host, apart from the program's mask code: each
    probed bucket's [start, next start) rounded outward to bn, plus the
    blocks that hold the candidate ids' positions, over every query of the
    block. The program's mask row must enable exactly those blocks, and
    the result must equal a brute force over their rows (ties by layout
    position)."""
    mask, bq, bn = layout._enable_mask(
        lay, q.shape[0], q.shape[1], K, D_BITS, probe, cand_ids,
        backend=device.backend_of(q))
    starts = lay.starts.cpu().numpy().astype(np.int64)
    inv = np.empty(lay.n, np.int64)
    inv[lay.perm.cpu().numpy()] = np.arange(lay.n)
    n_nblocks = mask.shape[1]
    for i in sample.tolist():
        rows = slice(i // bq * bq, min(i // bq * bq + bq, q.shape[0]))
        want = np.zeros(n_nblocks, bool)
        if probe is not None:
            for b in np.unique(probe[rows].cpu().numpy()):
                lo, hi = starts[b], starts[b + 1]
                if hi > lo:
                    want[lo // bn:(hi - 1) // bn + 1] = True
        if cand_ids is not None:
            c = cand_ids[rows].cpu().numpy().ravel()
            want[inv[c[c >= 0]] // bn] = True
        got = mask[i // bq].cpu().numpy() != 0
        if not np.array_equal(got, want):
            raise AssertionError(
                f"{label}: the mask row of query {i}'s block enables "
                f"{int(got.sum())} blocks, its probes {int(want.sum())} "
                f"({int((got != want).sum())} differ)")
        pos = torch.cat([torch.arange(j * bn, min(j * bn + bn, lay.n))
                         for j in np.flatnonzero(want).tolist()]
                        or [torch.zeros(0, dtype=torch.long)]).to(DEV)
        dist = binary.hamming_xor(q[i:i + 1], lay.codes[pos])[0]
        order = torch.argsort(dist, stable=True)[:K]
        m = order.shape[0]
        if not (torch.equal(dd[i, :m], dist[order])
                and torch.equal(ii[i, :m], lay.perm[pos[order]])
                and bool((dd[i, m:] == D_BITS + 1).all())
                and bool((ii[i, m:] == -1).all())):
            raise AssertionError(f"{label}: query {i} != the brute force "
                                 f"over its enabled rows")


def masked_search(label, fn, lay, q, exact, sample, probe, cand_ids):
    """One masked search with the counts zeroed just before it: one K1 and
    one K2 launch, the brute-force gate, the pass-1 skip share, recall@K
    against the exact search, then its median time."""
    tsel.reset_launch_counts()
    dd, ii, st = fn()
    torch.cuda.synchronize()
    launches = (tsel.hamming_hist_kernel.launches,
                tsel.hamming_emit_kernel.launches)
    if launches != (1, 1):
        raise AssertionError(f"{label}: K1, K2 launched {launches}")
    check_masked(label, lay, q, dd, ii, probe, cand_ids, sample)
    ms, _ = cuda_ms(fn, N_TIMED)
    p1 = int(st["p1_blocks_skipped"]) / max(st["blocks_total"], 1)
    p2 = int(st["blocks_skipped"]) / max(st["blocks_total"], 1)
    rec = recall_at(ii, exact)
    print(f"  {label}: K1, K2 launches {launches}, mask rows == the "
          f"probes' blocks and brute force over them ok; {ms:.3f} ms, pass-1 tiles skipped {p1:.4f}, "
          f"pass-2 {p2:.4f}, recall@{K} {rec:.4f}", flush=True)
    return dd, {"ms": ms, "p1_skipped_frac": p1, "p2_skipped_frac": p2,
                "recall": rec, "k1_launches": launches[0],
                "k2_launches": launches[1]}


def gathered_search(label, fn, exact, masked_dd=None):
    """A gather-path search: its time and recall; the masked search of the
    same probes may only do better (k-th distance never larger)."""
    dd, ii = fn()
    torch.cuda.synchronize()
    if masked_dd is not None and not bool(
            (masked_dd[:, -1] <= dd[:, -1]).all()):
        raise AssertionError(f"{label}: a masked k-th distance exceeds the "
                             f"gathered one")
    ms, _ = cuda_ms(fn, N_TIMED)
    rec = recall_at(ii, exact)
    print(f"  {label}: {ms:.3f} ms, recall@{K} {rec:.4f}"
          + ("; masked k-th <= gathered k-th on every query"
             if masked_dd is not None else ""), flush=True)
    return dd, ii, {"ms": ms, "recall": rec}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def index_path(seed, eng, q_main, exact_main):
    g = torch.Generator(device=DEV).manual_seed(seed + 20)
    n = eng.n
    centres = torch.randn((IDX_CENTRES, IDX_DIM), generator=g,
                          device=DEV) * IDX_CENTRE_STD
    own = torch.randint(0, IDX_CENTRES, (n + N_QUERIES,), generator=g,
                        device=DEV)
    pts = centres[own]
    pts += torch.randn(pts.shape, generator=g, device=DEV)
    data, qx = pts[:n], pts[n:].clone()
    del pts
    (itq, t_itq) = timed(lambda: quantize.itq_train(
        data, D_BITS, iters=IDX_ITQ_ITERS,
        generator=torch.Generator(device=DEV).manual_seed(seed + 21)))
    codes = binary.pack_bits(quantize.itq_encode(data, itq))
    qc = binary.pack_bits(quantize.itq_encode(qx, itq))
    exact = plan.execute(plan.plan_local(plan.stats_of(codes, qc, D_BITS), K,
                                         select="fused"), qc, codes=codes)
    sample = torch.from_numpy(np.random.default_rng(seed + 22).choice(
        N_QUERIES, N_GATE, replace=False))
    l2_rows = torch.from_numpy(np.random.default_rng(seed + 25).choice(
        N_QUERIES, L2_SAMPLE, replace=False)).to(DEV)
    l2_ids = l2_truth(data, qx[l2_rows])
    print(f"  store: {n} x {IDX_DIM} f32 from {IDX_CENTRES} centres "
          f"({n * IDX_DIM * 4 / 2**30:.2f} GiB), {D_BITS}-bit ITQ codes "
          f"trained in {t_itq:.2f} s", flush=True)

    kmi, t_km = timed(lambda: index.kmeans_build(
        data, codes, D_BITS, IVF_CLUSTERS, iters=IVF_ITERS,
        generator=torch.Generator(device=DEV).manual_seed(seed + 23)))
    lshi, t_lsh = timed(lambda: index.lsh_build(
        codes, D_BITS, n_tables=LSH_TABLES, bits_per_table=LSH_BITS,
        generator=torch.Generator(device=DEV).manual_seed(seed + 24)))
    data_np = data.cpu().numpy()
    kdi, t_kd = timed(lambda: index.KDTreeIndex(
        data_np, codes, D_BITS, n_trees=KD_TREES, leaf_size=KD_LEAF,
        seed=seed))
    del data
    print(f"  builds: IVF {IVF_CLUSTERS} clusters x {IVF_ITERS} iters "
          f"{t_km:.2f} s; LSH {LSH_TABLES} x {LSH_BITS} bits {t_lsh:.2f} s; "
          f"kd-tree {KD_TREES} trees, leaves <= {KD_LEAF}, {t_kd:.2f} s",
          flush=True)

    ex_ids = exact[1]
    searches = {}
    masked = {}
    for npr in IVF_NPROBES:
        probe = index._kmeans_probe(kmi, qx, npr)
        masked[npr], searches[f"ivf_masked_nprobe{npr}"] = masked_search(
            f"IVF masked, nprobe {npr}",
            lambda npr=npr: index.kmeans_search(kmi, qx, qc, K, nprobe=npr,
                                                return_stats=True),
            kmi.layout, qc, ex_ids, sample, probe, None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        *_, searches[f"ivf_gather_nprobe{IVF_GATHER_NPROBE}"] = \
            gathered_search(
                f"IVF gather, nprobe {IVF_GATHER_NPROBE}",
                lambda: index.kmeans_search(kmi, qx, qc, K,
                                            nprobe=IVF_GATHER_NPROBE,
                                            use_layout=False),
                ex_ids, masked[IVF_GATHER_NPROBE])
        keys = index._hash_codes(binary.unpack_bits(qc, D_BITS),
                                 lshi.bit_ids).long()
        others = torch.cat([lshi.buckets[t][keys[t]]
                            for t in range(1, LSH_TABLES)], dim=-1)
        lsh_dd, searches["lsh_masked"] = masked_search(
            f"LSH masked, {LSH_TABLES} tables",
            lambda: index.lsh_search(lshi, qc, K, return_stats=True),
            lshi.layout, qc, ex_ids, sample, keys[0][:, None], others)
        *_, searches["lsh_gather"] = gathered_search(
            "LSH gather", lambda: index.lsh_search(lshi, qc, K,
                                                   use_layout=False),
            ex_ids, lsh_dd)

    qx_np = qx.cpu().numpy()
    kd_dd, kd_ii, searches["kdtree_gather"] = gathered_search(
        "kd-tree gather (host traversal + card scan)",
        lambda: kdi.search(qx_np, qc, K), ex_ids)
    cand = torch.from_numpy(kdi._candidates(qx_np[sample.numpy()])).to(DEV)
    for j, i in enumerate(sample.tolist()):
        c = cand[j][cand[j] >= 0].long()
        dist = binary.hamming_xor(qc[i:i + 1], codes[c])[0]
        order = torch.argsort(dist, stable=True)[:K]
        if not (torch.equal(kd_dd[i, :order.shape[0]], dist[order])
                and torch.equal(kd_ii[i, :order.shape[0]],
                                c[order].to(torch.int32))):
            raise AssertionError(f"kd-tree: query {i} != the brute force "
                                 f"over its candidate list")
    print(f"  kd-tree: == the brute force over the candidate lists of "
          f"{N_GATE} sampled queries", flush=True)

    # the serving ladder's degraded rung on the first path's store
    lay = eng.layout
    bits = lay.n_buckets.bit_length() - 1
    _, positions = layout.hamming_prefix_assign(eng.codes, D_BITS, bits)
    pplan = plan.plan_index(plan.stats_of(eng.codes, q_main, D_BITS,
                                          layout=lay), K,
                            kind="hamming_prefix", nprobe=PREFIX_NPROBE)
    probe = index.hamming_prefix_probe(q_main, positions, lay.n_buckets,
                                       PREFIX_NPROBE, D_BITS)
    _, searches[f"hamming_prefix_nprobe{PREFIX_NPROBE}"] = masked_search(
        f"hamming-prefix probe ({pplan.compact()}), first path's store",
        lambda: plan.execute(pplan, q_main, layout=lay,
                             probe=index.hamming_prefix_probe(
                                 q_main, positions, lay.n_buckets,
                                 PREFIX_NPROBE, D_BITS),
                             return_stats=True),
        lay, q_main, exact_main, sample, probe, None)
    print("approx tier on the index store", flush=True)
    ax = approx_index(kmi, itq, codes, qx, qc, ex_ids, sample, l2_rows,
                      l2_ids)
    del kmi, lshi, kdi, codes
    torch.cuda.empty_cache()
    return {"n": n, "dim": IDX_DIM, "centres": IDX_CENTRES,
            "itq_train_s": t_itq, "ivf_build_s": t_km, "lsh_build_s": t_lsh,
            "kdtree_build_s": t_kd, "searches": searches, "approx": ax}


# ---------------------------------------------------------------------------
# phase 6: K4 against its plain version
# ---------------------------------------------------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=1e-30)))
    return torch.exp2(e - 7)


def k4_case(name, B, S, H, KV, hd, dtype, bq=512, bk=512, seed=0):
    """K4 through ``ops.flash_attention`` (padding, strided views) against
    the plain version on the same padded inputs; returns (max |err|, max
    err in bf16 ulps or None)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=DEV).to(dtype)
               for n in (H, KV, KV))
    out = ops.flash_attention(q, k, v, bq=bq, bk=bk)
    s_pad = -(-S // max(bq, bk)) * max(bq, bk)
    pad = lambda a: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, s_pad - S)).transpose(1, 2)
    ref = fa.flash_attention_plain(pad(q), pad(k), pad(v), min(bq, s_pad),
                                   min(bk, s_pad)).transpose(1, 2)[:, :S]
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"K4 {name}: {tuple(out.shape)} {out.dtype} != "
                             f"{tuple(ref.shape)} {ref.dtype}")
    diff = (out.float() - ref.float()).abs()
    err, ulps = float(diff.max()), None
    if dtype == torch.bfloat16:
        ulp = bf16_ulp(ref.float())
        ulps = float((diff / ulp).max())
        ok = bool((diff <= K4_BF16_ULPS * ulp + K4_ATOL_F32).all())
    else:
        ok = err <= K4_ATOL_F32
    print(f"  K4 case {name}: B={B} S={S} H={H} KV={KV} hd={hd} "
          f"{str(dtype).split('.')[-1]} bq={bq} bk={bk} max_abs_err={err:.3e}"
          + (f" ({ulps:.2f} ulps)" if ulps is not None else ""), flush=True)
    if not ok:
        raise AssertionError(f"K4 {name} disagrees with its plain version")
    return err


def run_k4_cases():
    cases = [(f"{s}", *s, dt) for s in
             [(2, 256, 4, 2, 64, 64, 64), (2, 256, 4, 2, 64, 128, 64),
              (1, 192, 4, 4, 64, 64, 128), (2, 200, 2, 1, 32, 64, 64)]
             for dt in (torch.float32, torch.bfloat16)]
    err = 0.0
    for name, B, S, H, KV, hd, bq, bk, dt in cases:
        err = max(err, k4_case("tests/test_kernels.py " + name, B, S, H, KV,
                               hd, dt, bq, bk))
    for name, shape, dt, *tiles in [
            ("S=1", (2, 1, 8, 1, 256), torch.bfloat16),
            ("S=1", (2, 1, 8, 1, 256), torch.float32),
            ("GQA G=2, hd=128, ragged", (2, 300, 4, 2, 128), torch.float32),
            ("GQA G=2, hd=128, ragged", (2, 300, 4, 2, 128), torch.bfloat16),
            # S a multiple of neither the query (64) nor the key (32)
            # tile of the bf16 kernel; bq = bk = 1, so ops adds no padding
            ("ragged tiles, no padding", (1, 333, 8, 1, 256), torch.bfloat16,
             1, 1),
            ("main shape", (PREFILL_BATCH, PREFILL_LEN, 8, 1, 256),
             torch.bfloat16),
            ("main shape", (PREFILL_BATCH, PREFILL_LEN, 8, 1, 256),
             torch.float32),
            # zamba2-2.7b's prefill: hd 80, 32 heads, no grouping
            ("zamba2 prefill", (PREFILL_BATCH, PREFILL_LEN) + K4_ZAMBA2[1:],
             torch.bfloat16)]:
        err = max(err, k4_case(name, *shape, dt, *tiles))
    # hd 80 (zamba2-2.7b) and 112 (kimi-k2): 5 and 7 k16 slices on the
    # tensor cores, a partial last column per lane on the CUDA cores
    for hd in (80, 112):
        for dt in (torch.float32, torch.bfloat16):
            err = max(err, k4_case(f"hd={hd}, S=1", 2, 1, 4, 2, hd, dt))
            err = max(err, k4_case(f"hd={hd}, ragged", 2, 300, 4, 2, hd, dt))
            err = max(err, k4_case(f"hd={hd}, ragged tiles, no padding", 1,
                                   333, 4, 1, hd, dt, 1, 1))
    for H, KV, hd in K4_NEW_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for S in (1, 300):
                err = max(err, k4_case(f"H={H} KV={KV} hd={hd}, S={S}", 2,
                                       S, H, KV, hd, dt))
    # the bf16 kernel's tile edges (warpgroups of 64 query rows, 128 a CTA;
    # key tiles of 64): S on either side of them, bq = bk = 1 so ops adds
    # no padding; gemma-2b's and zamba2-2.7b's heads, internlm2-20b's GQA
    for H, KV, hd in ((8, 1, 256), (4, 4, 80)):
        for S in K4_TILE_EDGES:
            err = max(err, k4_case(f"tile edge, hd={hd}, S={S}", 1, S, H,
                                   KV, hd, torch.bfloat16, 1, 1))
    err = max(err, k4_case("tile edge, H=48 KV=8 hd=128, S=129", 2, 129,
                           48, 8, 128, torch.bfloat16, 1, 1))
    return err


def k4_timings(B=PREFILL_BATCH, H=8, KV=1, S=PREFILL_LEN, hd=256):
    """K4 at one prefill's shape (the kernel layout; gemma-2b's by
    default): the bf16 route (tensor cores), its plain version and SDPA,
    then the f32 route (CUDA cores) on the same inputs in f32; the bound:
    2 * B * H * S^2 * hd FLOPs (QK^T and PV over the causal half) on the
    bf16 tensor cores, or q, k, v and o once through HBM, whichever takes
    longer. TFLOP/s count those FLOPs."""
    g = torch.Generator(device=DEV).manual_seed(7)
    q = torch.randn((B, H, S, hd), generator=g, device=DEV).bfloat16()
    k, v = (torch.randn((B, KV, S, hd), generator=g, device=DEV).bfloat16()
            for _ in range(2))
    ms, _ = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v), N_TIMED)
    plain_ms, _ = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=hd ** -0.5)
    lib_ms, _ = cuda_ms(sdpa, N_TIMED)
    q, k, v = q.float(), k.float(), v.float()
    ms_f32, _ = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v), N_TIMED)
    del q, k, v
    flops = 2 * B * H * S * S * hd
    nbytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    t = max((flops / BF16_FLOPS_PER_S, "operations"),
            (nbytes / HBM_BYTES_PER_S, "bytes"))
    tf = lambda t_ms: flops / t_ms / 1e9
    print(f"  K4 at B={B} H={H} KV={KV} S={S} hd={hd}: bf16 "
          f"(tensor cores) {ms:.3f} ms = {tf(ms):.1f} TFLOP/s, plain "
          f"{plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms = {tf(lib_ms):.1f} "
          f"TFLOP/s; f32 (CUDA cores) {ms_f32:.3f} ms = {tf(ms_f32):.1f} "
          f"TFLOP/s; bound {t[0] * 1e3:.4f} ms by {t[1]} ({flops / 1e9:.1f} "
          f"GFLOP, {nbytes / 2**20:.0f} MiB in bf16)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "ms_f32": ms_f32, "bound_ms": t[0] * 1e3, "bound_by": t[1],
            "tflops": tf(ms)}


# ---------------------------------------------------------------------------
# phase 7: kNN-LM serving of gemma-2b
# ---------------------------------------------------------------------------

def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def final_hidden(model, cfg, tokens, impl, chunk=1024):
    with torch.inference_mode():
        _, _, h = lm.forward(model, cfg, tokens, return_hidden=True,
                             ctx=lm.RunCtx(attn_impl=impl, attn_chunk=chunk))
    return h


def flash_vs_xla_f32(cfg, seed, layers=2):
    """A ``layers``-layer, full-width float32 copy of the model: flash (K4)
    and the plain blockwise path agree to FLASH_XLA_ATOL_F32."""
    small = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    model = lm.init_params(torch.Generator(device=DEV).manual_seed(seed + 1),
                           small, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed + 2)
    tok = torch.randint(0, cfg.vocab_size, (2, PREFILL_LEN), generator=g,
                        device=DEV)
    a = final_hidden(model, small, tok, "flash")
    b = final_hidden(model, small, tok, "xla")
    err = float((a - b).abs().max())
    print(f"  {layers}-layer f32 copy: flash vs xla max_abs_err {err:.3e} "
          f"(limit {FLASH_XLA_ATOL_F32})", flush=True)
    if err > FLASH_XLA_ATOL_F32:
        raise AssertionError("flash and xla prefill disagree in f32")
    return err


def build_corpus_store(model, cfg, corpus):
    """Hidden states of every corpus sequence (flash forward, batches of
    CORPUS_BATCH) -> (hidden[:, :-1], tokens[:, 1:]) pairs -> the store."""
    n_seq, S = corpus.shape
    hid = torch.empty((n_seq, S - 1, cfg.d_model), dtype=torch.bfloat16,
                      device=DEV)
    t0 = time.perf_counter()
    for i in range(0, n_seq, CORPUS_BATCH):
        hid[i:i + CORPUS_BATCH] = final_hidden(
            model, cfg, corpus[i:i + CORPUS_BATCH], "flash")[:, :-1]
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    with torch.inference_mode():
        store = retrieval.build_datastore(
            hid.reshape(-1, cfg.d_model), corpus[:, 1:].reshape(-1),
            cfg.retrieval.code_bits, itq_iters=ITQ_ITERS,
            generator=torch.Generator(device=DEV).manual_seed(11))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    del hid
    n = store.codes.shape[0]
    print(f"  datastore: N={n} entries ({n_seq} x {S - 1}), "
          f"{cfg.retrieval.code_bits}-bit codes, "
          f"{store.codes.numel() * 4 / 2**20:.1f} MiB of codes; hidden "
          f"states {t_fwd:.1f} s, ITQ + encode {t_all - t_fwd:.1f} s, "
          f"build {t_all:.1f} s", flush=True)
    return store, t_fwd, t_all


def decode_breakdown(model, cfg, store, srv):
    """Where a decode step's time goes, at the server's batch: the decode
    step alone, the retrieval on the config's plan and on fused, and the
    whole serve step (CUDA events, median of N_TIMED)."""
    rcfg = cfg.retrieval
    tok = torch.from_numpy(srv.last_token).to(DEV)
    active = torch.ones(SERVE_BATCH, dtype=torch.bool, device=DEV)
    with torch.inference_mode():
        _, _, h = lm.decode_step(model, cfg, tok, srv.state,
                                 return_hidden=True)
        h = h[:, 0, :]
        out = {
            "decode_step_ms": cuda_ms(lambda: lm.decode_step(
                model, cfg, tok, srv.state, active=active)[0], N_TIMED)[0],
            "knn_logits_ms": cuda_ms(lambda: retrieval.knn_logits(
                store, h, rcfg, cfg.vocab_size), N_TIMED)[0],
            "knn_logits_fused_ms": cuda_ms(lambda: retrieval.knn_logits(
                store, h, rcfg, cfg.vocab_size, select="fused"),
                N_TIMED)[0],
        }
    serve = steps.make_serve_step(cfg, SERVE_LEN)
    out["serve_step_ms"] = cuda_ms(lambda: serve(model, tok, srv.state,
                                                 active, store)[0],
                                   N_TIMED)[0]
    print("  decode step at batch {}: {}".format(SERVE_BATCH, ", ".join(
        f"{k} {v:.2f}" for k, v in out.items())), flush=True)
    return out


def serving_path(seed: int):
    cfg = get_config(ARCH)
    rcfg = cfg.retrieval
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                           cfg, device=DEV)
    torch.cuda.synchronize()
    n_params = lm.param_count(cfg)
    if sum(p.numel() for p in model.parameters()) != n_params:
        raise AssertionError("the model's parameters != param_count")
    print(f"model: {ARCH} {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV head, hd "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"param_count {n_params:,}; {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB in use; init {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    corpus = torch.randint(0, cfg.vocab_size, (CORPUS_SEQS, PREFILL_LEN),
                           generator=g, device=DEV)
    prompts = corpus[:PREFILL_BATCH]

    # the prefill, through K4: the launch count over one call
    prefill = steps.make_prefill_step(cfg, seq_len=PREFILL_LEN,
                                      attn_impl="flash", device=DEV)
    batch = {"tokens": prompts}
    fa.reset_launch_counts()
    logits, state = prefill(model, batch)
    torch.cuda.synchronize()
    k4_launches = fa.flash_attention_kernel.launches
    if k4_launches != cfg.num_layers:
        raise AssertionError(f"K4 launched {k4_launches} times in one "
                             f"prefill, expected {cfg.num_layers}")
    if (tuple(logits.shape) != (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or state["cache"].k.shape[:3] != (cfg.num_layers, PREFILL_BATCH,
                                              PREFILL_LEN)):
        raise AssertionError("prefill output shape or values wrong")
    del logits, state
    pre_ms, _ = cuda_ms(lambda: prefill(model, batch)[1]["pos"], N_TIMED)
    tok_s = PREFILL_BATCH * PREFILL_LEN / pre_ms * 1e3
    print(f"  prefill (flash, {PREFILL_BATCH} x {PREFILL_LEN}): K4 launches "
          f"{k4_launches}, median {pre_ms:.1f} ms, {tok_s:.0f} tokens/s",
          flush=True)
    h_xla = final_hidden(model, cfg, prompts, "xla")
    err_bf16 = rel_l2(final_hidden(model, cfg, prompts, "flash"), h_xla)
    noise = rel_l2(final_hidden(model, cfg, prompts, "xla", chunk=256), h_xla)
    del h_xla
    print(f"  flash vs xla final hidden state, {cfg.num_layers} bf16 layers: "
          f"relative L2 {err_bf16:.3e} (limit {FLASH_XLA_REL_L2_BF16}); xla "
          f"chunk 256 vs 1024: {noise:.3e}", flush=True)
    if not err_bf16 <= FLASH_XLA_REL_L2_BF16:
        raise AssertionError("flash and xla prefill disagree in bf16")
    err_f32 = flash_vs_xla_f32(cfg, seed)

    store, t_hidden, t_build = build_corpus_store(model, cfg, corpus)

    srv = server.Server(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                        store=store, device=DEV)
    print(f"  server plan: {srv.retrieval_plan.compact()} "
          f"({srv.retrieval_plan.reason})", flush=True)
    reqs = [server.Request(uid=i, prompt=corpus[i, :PROMPT_LEN].cpu().numpy()
                           .astype(np.int32), max_new_tokens=MAX_NEW)
            for i in range(N_REQUESTS)]
    for r in reqs:
        if not srv.submit(r):
            raise AssertionError(f"request {r.uid} shed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = srv.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = srv.stats()
    if (st["lost"] != 0 or st["done"] != N_REQUESTS
            or any(r.status != "done" or len(r.out_tokens) != MAX_NEW
                   for r in reqs)
            or any(not 0 <= t < cfg.vocab_size
                   for r in reqs for t in r.out_tokens)):
        raise AssertionError(f"serving failed: {st}")
    new_tok = N_REQUESTS * MAX_NEW
    print(f"  served {st['done']}/{N_REQUESTS} requests ({PROMPT_LEN}-token "
          f"prompts, {MAX_NEW} new tokens each) in {ticks} ticks, "
          f"{wall:.2f} s: p50 token {st['p50_token_s'] * 1e3:.2f} ms, p99 "
          f"token {st['p99_token_s'] * 1e3:.2f} ms, {new_tok / wall:.1f} new "
          f"tokens/s; lost {st['lost']}, rung {st['rung']}", flush=True)

    # one decode batch's hidden states through the config's plan and fused
    with torch.inference_mode():
        tok = torch.from_numpy(srv.last_token).to(DEV)
        _, _, h = lm.decode_step(model, cfg, tok, srv.state,
                                 return_hidden=True)
        h = h[:, 0, :]
        q_codes = binary.pack_bits(quantize.itq_encode(h, store.itq))
        p_cfg = retrieval.plan_for_store(store, rcfg, SERVE_BATCH)
        p_fused = retrieval.plan_for_store(store, rcfg, SERVE_BATCH,
                                           select="fused")
        d0, i0 = plan.execute(p_cfg, q_codes, codes=store.codes)
        d1, i1 = plan.execute(p_fused, q_codes, codes=store.codes)
        lp0 = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size)
        tsel.reset_launch_counts()
        lp1 = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size,
                                   select="fused")
        torch.cuda.synchronize()
    fused_launches = (tsel.hamming_hist_kernel.launches,
                      tsel.hamming_emit_kernel.launches)
    if not (torch.equal(d0, d1) and torch.equal(i0, i1)
            and torch.equal(lp0, lp1)) or fused_launches != (1, 1):
        raise AssertionError(f"fused retrieval != {p_cfg.select.path} "
                             f"(launches K1, K2 = {fused_launches})")
    print(f"  decode batch retrieval: {p_cfg.select.path} == fused "
          f"(dists, ids, log-probs identical; K1, K2 launched "
          f"{fused_launches})", flush=True)
    steps_ms = decode_breakdown(model, cfg, store, srv)
    del srv
    print("serving ladder: DegradationPolicy, snapshots", flush=True)
    ladder = serving_ladder(model, cfg, store, corpus)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"arch": ARCH, "param_count": n_params,
           "prefill_batch": PREFILL_BATCH, "prefill_len": PREFILL_LEN,
           "prefill_ms": pre_ms, "prefill_tokens_per_s": tok_s,
           "k4_launches_per_prefill": k4_launches,
           "flash_vs_xla_rel_l2_bf16": err_bf16,
           "xla_chunk_rel_l2_bf16": noise,
           "flash_vs_xla_max_abs_err_f32_2layer": err_f32,
           "store_entries": int(store.codes.shape[0]),
           "store_code_bytes": store.codes.numel() * 4,
           "store_hidden_s": t_hidden, "store_build_s": t_build,
           "serve_plan": p_cfg.compact(), "serve_ticks": ticks,
           "serve_wall_s": wall, "p50_token_ms": st["p50_token_s"] * 1e3,
           "p99_token_ms": st["p99_token_s"] * 1e3,
           "new_tokens_per_s": new_tok / wall, "lost": st["lost"],
           "peak_gb": peak, **steps_ms, "ladder": ladder}
    del store, model, corpus
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# phase 7c: the recurrent families, zamba2-2.7b and rwkv6-1.6b
# ---------------------------------------------------------------------------

def _attention_layers(cfg) -> int:
    """K4 launches in one prefill: the hybrid's shared block once per
    group; an attention-free stack none."""
    if cfg.shared_attn_every:
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers if cfg.block_pattern[0].value == "attention" else 0


def _leaves_of(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves_of(t[k])]
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves_of(v)]
    return [t]


def _state_bytes(state) -> int:
    return sum(a.numel() * a.element_size()
               for a in _leaves_of(state["cache"]))


def _last(logits) -> torch.Tensor:
    return logits[:, -1].to(torch.float32, copy=True)


def _last_logits(model, cfg, tokens, chunked: bool, prefix=None,
                 impl="flash"):
    """Logits at the last position: ``forward`` over the prefix (if any)
    and all of ``tokens`` (the chunked scans), or ``prefill`` over all but
    the last token and one ``decode_step`` (the step recurrences)."""
    ctx = lm.RunCtx(attn_impl=impl)
    with torch.inference_mode():
        if chunked:
            return _last(lm.forward(model, cfg, tokens, prefix, ctx=ctx)[0])
        _, st = lm.prefill(model, cfg, tokens[:, :-1], prefix, ctx=ctx)
        st = lm.pad_decode_state(cfg, st, int(st["pos"][0]) + 1)
        return _last(lm.decode_step(model, cfg, tokens[:, -1:], st)[0])


def half_chunk_forward(model, cfg, tokens, prefix):
    """The recurrent families' noise: forward at half the scan chunk
    (Mamba2 64, RWKV6 32)."""
    if cfg.ssm is not None:
        half = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=cfg.ssm.chunk_size // 2))
        return _last_logits(model, half, tokens, True, prefix)
    old = rwkv6.WKV_CHUNK
    rwkv6.WKV_CHUNK = old // 2
    try:
        return _last_logits(model, cfg, tokens, True, prefix)
    finally:
        rwkv6.WKV_CHUNK = old


def xla_forward(model, cfg, tokens, prefix):
    """The attention families' noise: forward through the blockwise
    attention instead of K4."""
    return _last_logits(model, cfg, tokens, True, prefix, impl="xla")


def forward_vs_decode(model, cfg, tokens, noise, prefix=None):
    """Forward's logits at the last position against prefill over all but
    the last token and one decode step, relative L2 over the batch's
    (B, vocab) logits; ``noise`` gives the same logits by another route.
    bf16 is gated at max(REC_REL_L2_BF16, REC_NOISE_X x noise), float32 at
    REC_REL_L2_F32."""
    full = _last_logits(model, cfg, tokens, True, prefix)
    err = rel_l2(_last_logits(model, cfg, tokens, False, prefix), full)
    noise_err = rel_l2(noise(model, cfg, tokens, prefix), full)
    limit = (REC_REL_L2_F32 if cfg.dtype == "float32"
             else max(REC_REL_L2_BF16, REC_NOISE_X * noise_err))
    print(f"  forward vs prefill + decode, {cfg.num_layers} layers, "
          f"{tokens.shape[1]} tokens"
          + (f" + {prefix.shape[1]} prefix" if prefix is not None else "")
          + f", {cfg.dtype}: last logits relative L2 {err:.3e} (limit "
          f"{limit:.3e}); noise ({noise.__name__}) {noise_err:.3e}",
          flush=True)
    if not err <= limit:
        raise AssertionError(f"{cfg.name}: prefill + decode disagrees with "
                             f"forward")
    return err, noise_err


def forward_vs_decode_f32(cfg, seed, layers, tokens, noise):
    """The same check on a float32 copy of the model at full width and
    ``layers`` layers, after a prefix drawn for it (frontend configs)."""
    small = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    model = lm.init_params(torch.Generator(device=DEV).manual_seed(seed + 1),
                           small, device=DEV)
    prefix = frontends.synthetic_prefix(
        small, tokens.shape[0],
        torch.Generator(device=DEV).manual_seed(seed + 2), device=DEV)
    out = forward_vs_decode(model, small, tokens, noise, prefix)
    del model
    return out


def scan_share(model, cfg, tokens) -> dict:
    """One layer's chunked scan (``_ssd_chunked`` / ``_wkv_chunked``) and
    its whole block, on the prefill's own first-layer inputs, each timed
    alone (CUDA events) and counted once per layer: the scans' and the
    blocks' share of a prefill."""
    B, S = tokens.shape
    eps = cfg.norm_eps
    with torch.inference_mode():
        x = layers.embed(model.embed, tokens)
        if cfg.ssm is not None:
            blk = model.blocks[0][0] if cfg.shared_attn_every else (
                model.blocks[0])
            h = layers.rmsnorm(blk.ln, x, eps)
            _, x_ssm, b, c, dt, _ = mamba2._projections(blk.mamba, h, None)
            dt = torch.nn.functional.softplus(dt.float() + blk.mamba.dt_bias)
            xh = x_ssm.reshape(B, S, -1, cfg.ssm.head_dim)
            scan = lambda: mamba2._ssd_chunked(xh, b, c, dt, blk.mamba.a_log,
                                               cfg.ssm.chunk_size)
            block = lambda: lm._apply_mamba_block(blk, cfg, x, False)
        else:
            blk = model.blocks[0]
            h = layers.rmsnorm(blk.ln1, x, eps)
            r, k, v, logw, _ = rwkv6._time_mix_heads(blk.tm, cfg, h, None)
            scan = lambda: rwkv6._wkv_chunked(r, k, v, logw, blk.tm.bonus,
                                              rwkv6.WKV_CHUNK)
            block = lambda: lm._apply_rwkv_block(blk, cfg, x, False)
        scan_ms = cuda_ms(scan, REC_TIMED)[0]
        block_ms = cuda_ms(block, REC_TIMED)[0]
    n = cfg.num_layers
    print(f"  one layer at {B} x {S}: chunked scan {scan_ms:.2f} ms, whole "
          f"block {block_ms:.2f} ms; x {n} layers: scans {n * scan_ms:.1f} "
          f"ms, blocks {n * block_ms:.1f} ms", flush=True)
    return {"scan_ms_per_layer": scan_ms, "block_ms_per_layer": block_ms,
            "scans_ms": n * scan_ms, "blocks_ms": n * block_ms}


def _count_steps(srv):
    """Count the server's decode steps (admission replays and ticks)."""
    n = [0]
    step = srv._step

    def counted(*a):
        n[0] += 1
        return step(*a)

    srv._step = counted
    return n


def _k_launches():
    return {"K1": tsel.hamming_hist_kernel.launches,
            "K2": tsel.hamming_emit_kernel.launches,
            "K3": tham.hamming_distance_kernel.launches,
            "K4": fa.flash_attention_kernel.launches}


def _reset_k_launches():
    tsel.reset_launch_counts()
    tham.reset_launch_counts()
    fa.reset_launch_counts()


def _plan_launches(p) -> dict:
    """K-kernel launches one search of plan ``p`` makes: fused runs K1 and
    K2 once; a materializing select runs K3 once per chunk only with
    method "pallas" (with "xor" its distances are plain PyTorch)."""
    out = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    if p.select.path == "fused":
        out["K1"] = out["K2"] = 1
    elif p.select.method == "pallas":
        out["K3"] = p.geometry()["n_chunks"]
    return out


def _serve_alone(cfg, model, store, req):
    """``req``'s prompt served alone on a fresh Server: its tokens."""
    srv = server.Server(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                        store=store, device=DEV)
    r = server.Request(uid=req.uid, prompt=req.prompt.copy(),
                       max_new_tokens=req.max_new_tokens)
    srv.submit(r)
    srv.run(max_ticks=1000)
    if r.status != "done":
        raise AssertionError(f"request {r.uid} alone: {r.status}")
    return r.out_tokens


def recurrent_serving(cfg, model, store, corpus):
    """16 requests on 8 slots (each slot reused once), with retrieval in
    every decode step; K-kernel launches per decode step against the
    plan; requests on reused slots equal the same requests alone on a
    fresh server; one decode batch's retrieval through the plan, fused
    (K1 + K2) and the board-scan composite (K3), all equal."""
    rcfg = cfg.retrieval
    srv = server.Server(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                        store=store, device=DEV)
    n_steps = _count_steps(srv)
    reqs = [server.Request(uid=i, prompt=corpus[i, :PROMPT_LEN].cpu().numpy()
                           .astype(np.int32), max_new_tokens=MAX_NEW)
            for i in range(N_REQUESTS)]
    for r in reqs:
        if not srv.submit(r):
            raise AssertionError(f"request {r.uid} shed")
    _reset_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = srv.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _k_launches()
    st = srv.stats()
    if (st["lost"] != 0 or st["done"] != N_REQUESTS
            or any(r.status != "done" or len(r.out_tokens) != MAX_NEW
                   for r in reqs)):
        raise AssertionError(f"{cfg.name} serving failed: {st}")
    per_step = _plan_launches(srv.retrieval_plan)
    want = {k: v * n_steps[0] for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{cfg.name} serving: launches {launches} over "
                             f"{n_steps[0]} decode steps, the plan "
                             f"{srv.retrieval_plan.compact()} makes {want}")
    new_tok = N_REQUESTS * MAX_NEW
    print(f"  served {st['done']}/{N_REQUESTS} requests on {SERVE_BATCH} "
          f"slots ({PROMPT_LEN}-token prompts, {MAX_NEW} new tokens) in "
          f"{ticks} ticks, {n_steps[0]} decode steps, {wall:.2f} s: p50 "
          f"token {st['p50_token_s'] * 1e3:.2f} ms, p99 token "
          f"{st['p99_token_s'] * 1e3:.2f} ms, {new_tok / wall:.1f} new "
          f"tokens/s; lost {st['lost']}; plan "
          f"{srv.retrieval_plan.compact()}: per step {per_step}, launched "
          f"{launches}", flush=True)

    # the second half of the requests took slots the first half left
    reused = [r for r in reqs if r.admit_tick > 0][:REC_FRESH_CHECKS]
    if len(reused) < REC_FRESH_CHECKS:
        raise AssertionError("no request was admitted to a reused slot")
    for r in reused:
        alone = _serve_alone(cfg, model, store, r)
        if alone != r.out_tokens:
            raise AssertionError(f"{cfg.name}: request {r.uid} on a reused "
                                 f"slot {r.out_tokens} != alone {alone}")
    print(f"  requests {[r.uid for r in reused]} on reused slots == each "
          f"alone on a fresh server", flush=True)

    with torch.inference_mode():
        tok = torch.from_numpy(srv.last_token).to(DEV)
        _, _, h = lm.decode_step(model, cfg, tok, srv.state,
                                 return_hidden=True)
        h = h[:, 0, :]
        lp = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size)
        q_codes = binary.pack_bits(quantize.itq_encode(h, store.itq))
        p_board = retrieval.plan_for_store(store, rcfg, SERVE_BATCH,
                                           method="pallas",
                                           select="composite")
        _reset_k_launches()
        lp_fused = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size,
                                        select="fused")
        lp_board = retrieval.knn_logits(store, h, rcfg, cfg.vocab_size,
                                        method="pallas", select="composite")
        torch.cuda.synchronize()
    batch_launches = _k_launches()
    want = {k: _plan_launches(p_board)[k] + (1 if k in ("K1", "K2") else 0)
            for k in batch_launches}
    if not (torch.equal(lp, lp_fused) and torch.equal(lp, lp_board)
            and batch_launches == want and q_codes.shape[0] == SERVE_BATCH):
        raise AssertionError(f"{cfg.name}: decode batch retrieval differs "
                             f"between plans (launches {batch_launches}, "
                             f"expected {want})")
    print(f"  decode batch retrieval: {srv.retrieval_plan.compact()} == fused "
          f"== {p_board.compact()} (log-probs identical; launches "
          f"{batch_launches})", flush=True)
    out = {"plan": srv.retrieval_plan.compact(), "serve_ticks": ticks,
           "decode_steps": n_steps[0], "launches": launches,
           "launches_per_step_by_plan": per_step, "serve_wall_s": wall,
           "p50_token_ms": st["p50_token_s"] * 1e3,
           "p99_token_ms": st["p99_token_s"] * 1e3,
           "new_tokens_per_s": new_tok / wall, "lost": st["lost"],
           "reused_equal_alone": [r.uid for r in reused],
           "decode_batch_launches": batch_launches}
    out.update(decode_breakdown(model, cfg, store, srv))
    tok = torch.from_numpy(srv.last_token).to(DEV)
    active = torch.ones(SERVE_BATCH, dtype=torch.bool, device=DEV)
    with torch.inference_mode():
        out["decode_step_profile"] = _profiled(
            "one decode step", lambda: lm.decode_step(
                model, cfg, tok, srv.state, active=active))
    return out


def flash_vs_xla_noise_gated(model, cfg, prompts):
    """The final hidden state through flash (K4) against the blockwise
    path at full depth in bf16, gated at REC_NOISE_X times the blockwise
    path against itself at chunk 256 (the run's own noise), never below
    FLASH_XLA_REL_L2_BF16: (relative L2, noise)."""
    h_xla = final_hidden(model, cfg, prompts, "xla")
    err = rel_l2(final_hidden(model, cfg, prompts, "flash"), h_xla)
    noise = rel_l2(final_hidden(model, cfg, prompts, "xla", chunk=256), h_xla)
    del h_xla
    limit = max(FLASH_XLA_REL_L2_BF16, REC_NOISE_X * noise)
    print(f"  flash vs xla final hidden state, {cfg.num_layers} bf16 layers: "
          f"relative L2 {err:.3e} (limit {limit:.3e}); xla chunk 256 vs "
          f"1024: {noise:.3e}", flush=True)
    if not err <= limit:
        raise AssertionError(f"{cfg.name}: flash and xla prefill disagree")
    return err, noise


def _init_arch(cfg, seed, label=""):
    """The model of ``cfg`` drawn on the card, its parameters held to
    ``param_count``; prints what it is and what it holds."""
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                           cfg, device=DEV)
    torch.cuda.synchronize()
    n_params = lm.param_count(cfg)
    if sum(p.numel() for p in model.parameters()) != n_params:
        raise AssertionError(f"{cfg.name}: the parameters != param_count")
    print(f"model: {cfg.name} ({cfg.family}{label}) {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV, hd {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; param_count {n_params:,}; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB in use; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, n_params


def _prefill_checked(model, cfg, batch, k4_want):
    """One flash prefill of ``batch`` with the K4 count zeroed just before
    and read just after (``k4_want`` launches), its logits and decode
    state checked against their shapes and for finite values; then its
    median time over REC_TIMED runs. Returns the readings and the step."""
    prefill = steps.make_prefill_step(cfg, seq_len=PREFILL_LEN,
                                      attn_impl="flash", device=DEV)
    fa.reset_launch_counts()
    logits, state = prefill(model, batch)
    torch.cuda.synchronize()
    k4 = fa.flash_attention_kernel.launches
    if k4 != k4_want:
        raise AssertionError(f"{cfg.name}: K4 launched {k4} times in one "
                             f"prefill, expected {k4_want}")
    B, S = batch["tokens"].shape
    n = S + cfg.frontend_positions
    ref = lm.init_decode_state(cfg, B, n, device="meta")
    shapes = lambda st: [tuple(a.shape) for a in _leaves_of(st["cache"])]
    if (tuple(logits.shape) != (B, n, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or shapes(state) != shapes(ref)
            or state["pos"].tolist() != [n] * B
            or not all(bool(torch.isfinite(a).all())
                       for a in _leaves_of(state["cache"]))):
        raise AssertionError(f"{cfg.name}: prefill output shape or values "
                             f"wrong")
    del logits, state
    ms, _ = cuda_ms(lambda: prefill(model, batch)[1]["pos"], REC_TIMED)
    print(f"  prefill (flash, {B} x {n}"
          + (f" = {S} tokens + {cfg.frontend_positions} prefix"
             if cfg.frontend_positions else "")
          + f"): K4 launches {k4}, median {ms:.1f} ms, "
          f"{B * n / ms * 1e3:.0f} positions/s", flush=True)
    return {"k4_launches_per_prefill": k4, "prefill_positions": n,
            "prefill_ms": ms, "prefill_tokens_per_s": B * n / ms * 1e3
            }, prefill


def _profiled(what, fn) -> dict:
    """``_profile(fn)``, printed as ``what``."""
    prof = _profile(fn)
    print(f"  {what} under torch.profiler: {prof['wall_ms']:.1f} ms wall, "
          f"{prof['device_events']} device events, busy share "
          f"{prof['busy_share']}; by kind {prof['by_kind']}", flush=True)
    return prof


def recurrent_arch(arch: str, seed: int) -> dict:
    cfg = get_config(arch)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, n_params = _init_arch(cfg, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    corpus = torch.randint(0, cfg.vocab_size, (REC_CORPUS_SEQS, PREFILL_LEN),
                           generator=g, device=DEV)
    prompts = corpus[:PREFILL_BATCH]
    batch = {"tokens": prompts}
    k4_want = _attention_layers(cfg)
    out = {"arch": arch, "param_count": n_params}
    pre, prefill = _prefill_checked(model, cfg, batch, k4_want)
    out.update(pre)
    out.update(scan_share(model, cfg, prompts))
    out["prefill_profile"] = _profiled("one prefill",
                                       lambda: prefill(model, batch))
    if k4_want:
        err, noise = flash_vs_xla_noise_gated(model, cfg, prompts)
        out.update(flash_vs_xla_rel_l2_bf16=err, xla_chunk_rel_l2_bf16=noise,
                   flash_vs_xla_max_abs_err_f32=flash_vs_xla_f32(
                       cfg, seed, REC_F32_LAYERS[arch]))
    check = prompts[:, :REC_CHECK_LEN]
    err, noise = forward_vs_decode(model, cfg, check, half_chunk_forward)
    err32, noise32 = forward_vs_decode_f32(cfg, seed, REC_F32_LAYERS[arch],
                                           check, half_chunk_forward)
    out.update(chunked_vs_recurrent_rel_l2=err, half_chunk_rel_l2=noise,
               chunked_vs_recurrent_rel_l2_f32=err32,
               half_chunk_rel_l2_f32=noise32)
    sizes = {n: _state_bytes(lm.init_decode_state(cfg, SERVE_BATCH, n,
                                                  device="meta"))
             for n in (1024, 4096)}
    print(f"  decode state at batch {SERVE_BATCH}: {sizes[1024] / 2**20:.1f} "
          f"MiB at max_len 1024, {sizes[4096] / 2**20:.1f} MiB at 4096",
          flush=True)
    if not cfg.shared_attn_every and sizes[1024] != sizes[4096]:
        raise AssertionError(f"{arch}: the decode state grows with max_len")
    out["decode_state_bytes"] = sizes

    store, t_hidden, t_build = build_corpus_store(model, cfg, corpus)
    out.update(store_entries=int(store.codes.shape[0]),
               store_hidden_s=t_hidden, store_build_s=t_build)
    out.update(recurrent_serving(cfg, model, store, corpus))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  {arch}: peak {out['peak_gb']:.2f} GB, phase "
          f"{out['wall_s']:.1f} s", flush=True)
    del store, model, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_path(seed: int) -> dict:
    """zamba2-2.7b and rwkv6-1.6b at their registered configs: prefill
    through K4 (9 launches for zamba2, none for rwkv6), chunked against
    recurrent, the sub-quadratic state, a datastore and a server whose
    reused slots equal fresh ones."""
    t0 = time.perf_counter()
    out = {arch: recurrent_arch(arch, seed) for arch in REC_ARCHS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  recurrent path: {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7d: the dense, frontend and MoE families
# ---------------------------------------------------------------------------

def dense_path(seed: int) -> dict:
    """internlm2-20b at its registered width and depth: a flash prefill of
    8 x 2048 (48 K4 launches) with K4 timed at that shape, flash against
    the blockwise path (bf16 at full depth within REC_NOISE_X of the run's
    own noise; a 2-layer f32 copy within FLASH_XLA_ATOL_F32), a store of
    DENSE_CORPUS_SEQS x 2047 entries from the model's hidden states (a cut
    of the registered size), and 16 requests on 8 slots."""
    cfg = get_config(DENSE_ARCH)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, n_params = _init_arch(cfg, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    corpus = torch.randint(0, cfg.vocab_size,
                           (DENSE_CORPUS_SEQS, PREFILL_LEN), generator=g,
                           device=DEV)
    prompts = corpus[:PREFILL_BATCH]
    batch = {"tokens": prompts}
    out = {"arch": DENSE_ARCH, "param_count": n_params}
    pre, prefill = _prefill_checked(model, cfg, batch, cfg.num_layers)
    out.update(pre)
    out["prefill_profile"] = _profiled("one prefill",
                                       lambda: prefill(model, batch))
    err, noise = flash_vs_xla_noise_gated(model, cfg, prompts)
    out.update(flash_vs_xla_rel_l2_bf16=err, xla_chunk_rel_l2_bf16=noise,
               flash_vs_xla_max_abs_err_f32_2layer=flash_vs_xla_f32(cfg,
                                                                    seed))
    store, t_hidden, t_build = build_corpus_store(model, cfg, corpus)
    print(f"  (the store is cut from the registered "
          f"{cfg.retrieval.datastore_size:,} entries to "
          f"{int(store.codes.shape[0]):,} for the run's time limit)",
          flush=True)
    out.update(store_entries=int(store.codes.shape[0]),
               store_registered_entries=cfg.retrieval.datastore_size,
               store_hidden_s=t_hidden, store_build_s=t_build)
    out.update(recurrent_serving(cfg, model, store, corpus))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  {DENSE_ARCH}: peak {out['peak_gb']:.2f} GB, phase "
          f"{out['wall_s']:.1f} s", flush=True)
    del store, model, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_arch(arch: str, seed: int) -> dict:
    """One frontend config at its registered width and depth: a flash
    prefill of 8 x 2048 tokens after the config's prefix of synthetic
    embeddings (drawn on a CUDA generator), then prefill + one decode step
    against forward at S + 1, in bf16 at full depth and on a 2-layer f32
    copy."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, n_params = _init_arch(cfg, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_BATCH, PREFILL_LEN + 1), generator=g,
                           device=DEV)
    prefix = frontends.synthetic_prefix(cfg, PREFILL_BATCH, g, device=DEV)
    out = {"arch": arch, "param_count": n_params,
           "prefix_positions": cfg.frontend_positions,
           "prefix_width": frontends.frontend_dim(cfg)}
    out.update(_prefill_checked(model, cfg, {
        "tokens": tokens[:, :PREFILL_LEN], "prefix_emb": prefix},
        cfg.num_layers)[0])
    err, noise = forward_vs_decode(model, cfg, tokens, xla_forward, prefix)
    err32, noise32 = forward_vs_decode_f32(
        cfg, seed, DECODE_F32_LAYERS, tokens[:2, :DECODE_F32_LEN + 1],
        xla_forward)
    out.update(decode_vs_forward_rel_l2=err, flash_vs_xla_last_rel_l2=noise,
               decode_vs_forward_rel_l2_f32=err32,
               flash_vs_xla_last_rel_l2_f32=noise32,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t0)
    del model, prefix, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_path(seed: int) -> dict:
    return {arch: frontend_arch(arch, seed) for arch in FRONTEND_ARCHS}


def _swiglu_f32(x, w_gate, w_up, w_out):
    """A swiglu MLP in f32, written out."""
    silu = torch.nn.functional.silu
    return (silu(x @ w_gate.float()) * (x @ w_up.float())) @ w_out.float()


def moe_f32_recompute(mod, cfg, h):
    """The MoE layer on rows ``h`` (T, d), recomputed in f32 without the
    program's route or MLPs: f32 logits, softmax, a stable descending sort
    (ties to the lower expert), the top K renormalised by max(sum, 1e-9);
    then only each token's K experts (grouped by expert), weighted and
    summed, plus the shared expert and the dense residual (swiglu in both
    MoE configs). Returns (y, the (T, K) expert ids)."""
    K = cfg.moe.experts_per_token
    x = h.float()
    probs = torch.softmax(x @ mod.router.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :K], idx[:, :K]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y.index_add_(0, tok, w[tok, slot][:, None] * _swiglu_f32(
            x[tok], mod.w_gate[e], mod.w_up[e], mod.w_out[e]))
    if cfg.moe.num_shared_experts:
        m = mod.shared
        y = y + _swiglu_f32(x, m.w_gate, m.w_up, m.w_out)
    if cfg.moe.dense_residual_d_ff:
        if cfg.mlp_activation != "swiglu":
            raise ValueError(f"{cfg.name}: the recomputation writes out "
                             f"swiglu only, not {cfg.mlp_activation}")
        m = mod.dense
        y = y + _swiglu_f32(x, m.w_gate, m.w_up, m.w_out)
    return y, idx


def moe_arch(arch: str, seed: int) -> dict:
    """One MoE config at its registered width, cut to MOE_LAYERS layer(s):
    a flash prefill of 8 x 2048; the layer's MoE output on MOE_SAMPLE
    sampled tokens against an independent f32 recomputation; the aux
    loss; the expert loop's share of the layer's time; prefill + one
    decode step against forward at S + 1 (bf16, and a 1-layer f32 copy
    with MOE_F32_EXPERTS experts)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, n_params = _init_arch(
        cfg, seed, f"; DEPTH CUT from {full.num_layers} layers to "
        f"{MOE_LAYERS}, {lm.param_count(full):,} params registered")
    moe_cfg = cfg.moe
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_BATCH, PREFILL_LEN + 1), generator=g,
                           device=DEV)
    prompts = tokens[:, :PREFILL_LEN]
    out = {"arch": arch, "layers": MOE_LAYERS,
           "registered_layers": full.num_layers, "param_count": n_params,
           "registered_param_count": lm.param_count(full),
           "active_param_count": lm.param_count(full, active_only=True),
           "experts": moe_cfg.num_experts, "top_k": moe_cfg.experts_per_token}
    out.update(_prefill_checked(model, cfg, {"tokens": prompts},
                                cfg.num_layers)[0])

    # the first layer's MoE input, from the prefill's own tokens
    blk = model.blocks[0]
    ctx = lm.RunCtx(attn_impl="flash")
    with torch.inference_mode():
        x0 = lm._embed_scale(cfg, layers.embed(model.embed, prompts))
        pos = torch.arange(PREFILL_LEN, device=DEV)[None].expand(
            PREFILL_BATCH, PREFILL_LEN)
        x1, _ = lm._attn_prefill(blk, cfg, ctx, x0, pos, False)
        h = layers.rmsnorm(blk.ln2, x1, cfg.norm_eps)
        h_tok = h.reshape(-1, cfg.d_model)
        y, aux = moe.moe_forward(blk.moe, cfg, h)
        loop_ms, _ = cuda_ms(lambda: moe.moe_reference(blk.moe, cfg, h_tok),
                             REC_TIMED)
        layer_ms, _ = cuda_ms(lambda: lm._apply_moe_block(
            blk, cfg, ctx, x0, pos, False), REC_TIMED)
        pick = torch.randperm(h_tok.shape[0], generator=g, device=DEV)[
            :MOE_SAMPLE]
        ref, ref_idx = moe_f32_recompute(blk.moe, cfg, h_tok[pick])
        err = rel_l2(y.reshape(-1, cfg.d_model)[pick], ref)
        ids_equal = torch.equal(moe._route(
            blk.moe.router, h_tok[pick], moe_cfg.experts_per_token)[1],
            ref_idx)
    aux = float(aux)
    ratio = moe_cfg.num_experts / moe_cfg.experts_per_token
    print(f"  MoE layer on {MOE_SAMPLE} sampled tokens vs its f32 "
          f"recomputation (routed experts only): relative L2 {err:.3e} "
          f"(limit {MOE_REL_L2}), expert ids equal to the program's "
          f"route: {ids_equal}; aux {aux:.6f} (>= {MOE_AUX_MIN}); the "
          f"expert loop {loop_ms:.1f} ms of the layer's {layer_ms:.1f} ms "
          f"({loop_ms / layer_ms:.1%}), running every expert on every "
          f"token: {ratio:.0f}x the routed work", flush=True)
    if not ids_equal:
        raise AssertionError(f"{arch}: the program's route picks other "
                             f"experts than the written-out one")
    if not err <= MOE_REL_L2:
        raise AssertionError(f"{arch}: the MoE layer disagrees with its f32 "
                             f"recomputation")
    if not aux >= MOE_AUX_MIN:
        raise AssertionError(f"{arch}: aux loss {aux} < {MOE_AUX_MIN}")
    del x0, x1, h, h_tok, y, ref, ref_idx
    err_d, noise_d = forward_vs_decode(model, cfg, tokens, xla_forward)
    del model, blk
    gc.collect()
    torch.cuda.empty_cache()
    # the f32 copy at full width holds MOE_F32_EXPERTS experts: one
    # layer's 128 or 384 in f32 is 54-68 GB
    err32, noise32 = forward_vs_decode_f32(dataclasses.replace(
        cfg, moe=dataclasses.replace(moe_cfg, num_experts=min(
            moe_cfg.num_experts, MOE_F32_EXPERTS))),
        seed, MOE_LAYERS, tokens[:2, :DECODE_F32_LEN + 1], xla_forward)
    out.update(moe_vs_f32_rel_l2=err, route_ids_equal=ids_equal, aux=aux,
               expert_loop_ms=loop_ms,
               layer_ms=layer_ms, expert_loop_share=loop_ms / layer_ms,
               overcompute_x=ratio, decode_vs_forward_rel_l2=err_d,
               flash_vs_xla_last_rel_l2=noise_d,
               decode_vs_forward_rel_l2_f32=err32,
               flash_vs_xla_last_rel_l2_f32=noise32,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_path(seed: int) -> dict:
    """arctic-480b and kimi-k2 at full width, one layer each (a depth
    cut), one arch at a time."""
    return {arch: moe_arch(arch, seed) for arch in MOE_ARCHS}


def _ep_cfg():
    """arctic-480b's layer for the EP check: full width, one layer, f32,
    the experts cut to EP_EXPERTS at capacity factor EP_CF."""
    cfg = get_config(MOE_ARCHS[0])
    return dataclasses.replace(
        cfg, num_layers=1, dtype="float32",
        moe=dataclasses.replace(cfg.moe, num_experts=EP_EXPERTS,
                                capacity_factor=EP_CF))


def _ep_inputs(cfg, seed):
    """The whole layer and the (EP_B, EP_S, d) tokens, both drawn on the
    card from ``seed`` (every rank draws the same)."""
    layer = moe.moe_init(torch.Generator(device=DEV).manual_seed(seed), cfg,
                         torch.float32, DEV)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=g, device=DEV)
    return layer, x * EP_X_SCALE


def ep_rank(rank: int, cfg: dict) -> None:
    """One rank of the EP check, in a process of its own: joins the gloo
    world, keeps its experts (``carry.expert_shard``) and its slice of the
    tokens, runs each strategy once untimed and EP_TIMED times timed, and
    writes its output slice and a JSON summary into ``cfg["dir"]``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{cfg['init']}", world_size=EP_RANKS,
        rank=rank, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = init_device_mesh(DEV, (1, EP_RANKS),
                                mesh_dim_names=("data", "model"))
        mcfg = _ep_cfg()
        layer, x = _ep_inputs(mcfg, cfg["seed"])
        part = carry.expert_shard(layer, mcfg, rank, EP_RANKS)
        del layer
        summary = {}
        for name, strategy, int8 in EP_STRATEGIES:
            xs = x
            if strategy == "a2a":
                s = EP_S // EP_RANKS
                xs = x[:, rank * s:(rank + 1) * s].contiguous()
            run = lambda: moe.moe_forward(
                part, mcfg, xs, mesh=mesh, strategy=strategy, a2a_int8=int8)
            ms, (y, aux) = cuda_ms(run, EP_TIMED)
            np.save(Path(cfg["dir"]) / f"{name}_{rank}.npy", y.cpu().numpy())
            summary[name] = {"ms": ms, "aux": float(aux),
                             "transport": moe.a2a_transport(
                                 xs, mesh.get_group("model"))}
        (Path(cfg["dir"]) / f"rank{rank}.json").write_text(
            json.dumps(summary))
    finally:
        dist.destroy_process_group()


def moe_ep(seed: int) -> dict:
    """``moe.moe_forward`` over EP_RANKS gloo ranks on the one card, each
    holding EP_EXPERTS / EP_RANKS of arctic's full-width experts (the
    expert count a cut): a2a and allgather within EP_REL_MAX (relative
    max) of the single-device reference, a2a_int8 within EP_INT8_ATOL;
    the transport each took."""
    mcfg = _ep_cfg()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="moe_ep_") as tmp:
        _run_ranks({"init": str(Path(tmp) / "init"), "dir": tmp,
                    "seed": seed, "world": EP_RANKS}, ep_rank)
        summaries = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(EP_RANKS)]
        ys = {name: [torch.from_numpy(np.load(Path(tmp) / f"{name}_{r}.npy"))
                     .to(DEV) for r in range(EP_RANKS)]
              for name, _, _ in EP_STRATEGIES}
    wall = time.perf_counter() - t0
    layer, x = _ep_inputs(mcfg, seed)
    with torch.inference_mode():
        ref, ref_aux = moe.moe_forward(layer, mcfg, x)
    del layer
    scale = float(ref.abs().max())
    out = {"experts": EP_EXPERTS, "registered_experts":
           get_config(MOE_ARCHS[0]).moe.num_experts, "ranks": EP_RANKS,
           "tokens": EP_B * EP_S, "d_model": mcfg.d_model,
           "expert_d_ff": mcfg.moe.expert_d_ff, "wall_s": wall}
    for name, strategy, int8 in EP_STRATEGIES:
        parts = ys[name]
        if strategy == "a2a":
            y = torch.cat(parts, dim=1)
        else:
            if not torch.equal(parts[0], parts[1]):
                raise AssertionError(f"EP {name}: the ranks' replicas differ")
            y = parts[0]
        err = float((y - ref).abs().max())
        auxes = {s[name]["aux"] for s in summaries}
        transports = {s[name]["transport"] for s in summaries}
        ok = (err <= EP_INT8_ATOL if int8 else err <= EP_REL_MAX * scale)
        # every rank holds the same aux; allgather's is over all tokens,
        # a2a's the mean of the ranks' local ones (repro's definition)
        ok = ok and len(auxes) == 1 and (
            strategy != "allgather"
            or abs(next(iter(auxes)) - float(ref_aux)) <= 1e-5)
        print(f"  EP {name}: max_abs_err {err:.3e} vs the reference "
              f"(relative {err / scale:.3e}; limit "
              + (f"{EP_INT8_ATOL} absolute" if int8 else
                 f"{EP_REL_MAX} relative") + f"); transport "
              f"{sorted(transports)}; ms per rank "
              f"{[round(s[name]['ms'], 3) for s in summaries]}", flush=True)
        if not ok:
            raise AssertionError(f"EP {name} disagrees with the reference")
        out[name] = {"max_abs_err": err, "rel_max_err": err / scale,
                     "aux": next(iter(auxes)),
                     "transport": sorted(transports),
                     "ms_per_rank": [s[name]["ms"] for s in summaries]}
    print(f"  (the experts are cut from {out['registered_experts']} to "
          f"{EP_EXPERTS}, at capacity factor {EP_CF}: nothing drops) "
          f"{wall:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the approximate tier on the kNN cell and on the index store
# ---------------------------------------------------------------------------

def approx_path(eng, q, fused):
    """``approx_topk`` over the kNN cell in insertion order and, through
    the planner, in layout order, at each recall target: ms, bn, l, the
    bound's predicted recall and the measured recall@K (ids, and
    distances within the exact k-th) against the fused result. At 1.0
    both orders are gated bit-for-bit equal to fused. The ``torch._int_mm``
    score tile of one chunk is timed alone beside them."""
    t_phase = time.perf_counter()
    flat = eng._replace(layout=None)
    fd, fi = fused
    ld_ref, li_ref = eng.search(q, K)
    Q, W = q.shape
    N, bins = flat.n, D_BITS + 1
    bn = tuning.approx_blocks(Q, N, W, backend=device.backend_of(q))
    n_blocks = -(-N // bn)
    # one chunk of the product, as approx_topk takes it
    (qs, b0, b1), *_ = approx_select._chunks(Q, n_blocks, bn,
                                             device.backend_of(q))
    rows = min((b1 - b0) * bn, N)
    qpl = approx_select.bit_planes(q, D_BITS)
    xpl = approx_select.bit_planes(flat.codes[:rows], D_BITS)
    mm_ms, tile = cuda_ms(lambda: approx_select.hamming_scores_planes(
        qpl, xpl, D_BITS), N_TIMED)
    if not torch.equal(tile[:N_CHECK], binary.hamming_xor(
            q[:N_CHECK], flat.codes[:rows])):
        raise AssertionError("the _int_mm score tile != popcount distances")
    del tile, xpl
    n_chunks = -(-N // rows)
    print(f"  torch._int_mm score tile ({Q} x {rows} x {D_BITS} int8 -> "
          f"int32, + affine): {mm_ms:.3f} ms; {n_chunks} tiles a search; "
          f"bn {bn}, {n_blocks} blocks", flush=True)
    out = {"bn": bn, "n_blocks": n_blocks, "chunk_rows": rows,
           "n_chunks": n_chunks, "int_mm_tile_ms": mm_ms,
           "int_mm_ms_per_search": mm_ms * n_chunks, "targets": {}}
    stats = plan.stats_of(eng.codes, q, D_BITS, layout=eng.layout)
    for rt in APPROX_TARGETS:
        l = approx_select.l_for_recall(K, n_blocks, bn, rt)
        ms, (dd, ii) = cuda_ms(lambda: approx_select.approx_topk(
            q, flat.codes, K, bins, recall_target=rt), N_APPROX_TIMED)
        p = plan.plan_local(stats, K, select="approx", recall_target=rt)
        lms, (ld, li) = cuda_ms(lambda: plan.execute(
            p, q, codes=eng.codes, layout=eng.layout), N_APPROX_TIMED)
        if rt >= 1.0 and not (torch.equal(dd, fd) and torch.equal(ii, fi)
                              and torch.equal(ld, ld_ref)
                              and torch.equal(li, li_ref)):
            raise AssertionError("approx at recall_target 1.0 != fused")
        row = {"l": l, "ms": ms, "layout_ms": lms,
               "plan": p.compact(),
               "predicted_recall": approx_select.expected_recall(
                   K, n_blocks, l),
               "recall": recall_at(ii, fi),
               "dist_recall": float((dd <= fd[:, K - 1:K]).float().mean()),
               "layout_recall": recall_at(li, li_ref),
               "pool_merge_ms_est": ms - mm_ms * n_chunks}
        out["targets"][str(rt)] = row
        print(f"  approx rt {rt}: insertion order {ms:.3f} ms, layout "
              f"order {lms:.3f} ms; bn {bn}, l {l}, predicted recall "
              f"{row['predicted_recall']:.4f}, measured recall@{K} "
              f"{row['recall']:.4f} (distances {row['dist_recall']:.4f}; "
              f"layout order {row['layout_recall']:.4f})"
              + ("; == fused bit-for-bit, both orders" if rt >= 1.0
                 else ""), flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  approx phase: {out['wall_s']:.1f} s", flush=True)
    return out


def l2_truth(data, qx):
    """Exact float nearest neighbours: (S, K) ids by squared L2 over the
    whole store, in chunks of rows."""
    best_d = torch.full((qx.shape[0], K), float("inf"), device=DEV)
    best_i = torch.zeros((qx.shape[0], K), dtype=torch.int64, device=DEV)
    for r0 in range(0, data.shape[0], 1 << 18):
        x = data[r0:r0 + (1 << 18)]
        d2 = (x * x).sum(1)[None, :] - 2 * qx @ x.t()
        cd, ci = torch.topk(d2, K, dim=1, largest=False)
        alld = torch.cat([best_d, cd], 1)
        alli = torch.cat([best_i, ci + r0], 1)
        best_d, o = torch.topk(alld, K, dim=1, largest=False)
        best_i = torch.gather(alli, 1, o)
    return best_i


def approx_index(kmi, itq, codes, qx, qc, ex_ids, sample, l2_rows, l2_ids):
    """The approx tier on the index store: the masked approx probe of the
    IVF layout at nprobe APPROX_NPROBE and recall_target 1.0, gated on
    sampled queries equal to a brute force over the rows of the blocks its
    probed buckets cover (rounded out to the approx blocks, worked out
    here on the host); ``asymmetric_topk`` of the ITQ projections against
    the codes. Recall@K against the exact Hamming search and, on
    L2_SAMPLE queries, against the exact float neighbours."""
    t_phase = time.perf_counter()
    lay = kmi.layout
    Q, W = qc.shape
    probe = index._kmeans_probe(kmi, qx, APPROX_NPROBE)
    stats = plan.stats_of(lay.codes, qc, D_BITS, layout=lay, index="kmeans",
                          n_buckets=lay.n_buckets)
    p = plan.plan_index(stats, K, kind="kmeans", nprobe=APPROX_NPROBE,
                        select="approx", recall_target=1.0)
    ms, (dd, ii) = cuda_ms(lambda: plan.execute(p, qc, layout=lay,
                                                probe=probe), N_APPROX_TIMED)
    bn = min(tuning.approx_blocks(Q, lay.n, W,
                                  backend=device.backend_of(qc)), lay.n)
    starts = lay.starts.cpu().numpy().astype(np.int64)
    for i in sample.tolist():
        want = np.zeros(-(-lay.n // bn), bool)
        for b in np.unique(probe[i].cpu().numpy()):
            lo, hi = starts[b], starts[b + 1]
            if hi > lo:
                want[lo // bn:(hi - 1) // bn + 1] = True
        pos = torch.cat([torch.arange(j * bn, min(j * bn + bn, lay.n))
                         for j in np.flatnonzero(want).tolist()]).to(DEV)
        dist = binary.hamming_xor(qc[i:i + 1], lay.codes[pos])[0]
        order = torch.argsort(dist, stable=True)[:K]
        if not (torch.equal(dd[i], dist[order])
                and torch.equal(ii[i], lay.perm[pos[order]])):
            raise AssertionError(f"masked approx: query {i} != the brute "
                                 f"force over its blocks' rows")
    out = {"masked_plan": p.compact(), "masked_bn": bn, "masked_ms": ms,
           "masked_recall": recall_at(ii, ex_ids)}
    print(f"  masked approx ({p.compact()}), IVF nprobe {APPROX_NPROBE}, "
          f"bn {bn}: {ms:.3f} ms, == the brute force over the probed "
          f"blocks' rows on {len(sample)} sampled queries, recall@{K} "
          f"{out['masked_recall']:.4f}", flush=True)
    v = quantize.itq_project(qx, itq)
    out["fused_l2_recall"] = recall_at(ex_ids[l2_rows].long(), l2_ids)
    for rt in (1.0, 0.9):
        ams, (av, ai) = cuda_ms(lambda: approx_select.asymmetric_topk(
            v, codes, K, D_BITS, recall_target=rt), N_APPROX_TIMED)
        out[f"asymmetric_rt{rt}"] = {
            "ms": ams, "recall_vs_hamming": recall_at(ai, ex_ids),
            "l2_recall": recall_at(ai[l2_rows].long(), l2_ids)}
        print(f"  asymmetric_topk (ITQ projections vs codes), rt {rt}: "
              f"{ams:.3f} ms, recall@{K} vs exact Hamming "
              f"{out[f'asymmetric_rt{rt}']['recall_vs_hamming']:.4f}, vs "
              f"exact L2 ({L2_SAMPLE} queries) "
              f"{out[f'asymmetric_rt{rt}']['l2_recall']:.4f} (exact "
              f"Hamming: {out['fused_l2_recall']:.4f})", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  approx on the index store: {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7b: the serving ladder and the snapshot fallback
# ---------------------------------------------------------------------------

class FailUntilRestored(faults.FaultInjector):
    """Fails every store search until the server has restored its store
    from a snapshot once."""

    def __init__(self):
        super().__init__(seed=0, p={})
        self.srv = None

    def check(self, site, tenant=None):
        super().check(site, tenant)
        if (site == "store_search"
                and self.srv.counters["snapshot_restores"] == 0):
            self.fired[site] = self.fired.get(site, 0) + 1
            raise faults.InjectedFault(site)


def shard_loss_rung(srv, fts, submit):
    """The ladder's shard-loss rung: the server's shard layer loses unit1
    mid-run, so the server serves the degraded view of the covered rows;
    then unit1 comes back with its data and maintain() returns the full
    store. Nothing is lost."""
    before = srv.stats()
    for _ in range(SERVE_BATCH):
        submit(2)
    srv.tick()
    fts.kill("unit1")
    degraded_ticks = 0
    for _ in range(3):
        srv.tick()
        if (srv.store is not srv._full_store and srv.store.codes.shape[0]
                == fts.coverage().covered_rows):
            degraded_ticks += 1
    mid = srv.stats()
    fts.revive("unit1", with_data=True)
    submit(2)
    srv.run(max_ticks=srv.ticks + 200)
    st = srv.stats()
    losses = st["shard_losses"] - before["shard_losses"]
    recoveries = st["shard_recoveries"] - before["shard_recoveries"]
    if (degraded_ticks < 1 or losses < 1 or recoveries < 1 or st["lost"]
            or srv.store is not srv._full_store
            or st["coverage_frac"] != 1.0):
        raise AssertionError(f"shard-loss rung: {degraded_ticks} degraded "
                             f"ticks, losses {losses}, recoveries "
                             f"{recoveries}, lost {st['lost']}, coverage "
                             f"{st['coverage_frac']}")
    out = {"degraded_ticks": degraded_ticks,
           "coverage_while_degraded": mid["coverage_frac"],
           "rows_while_degraded": fts.map.total_rows * mid["coverage_frac"],
           "shard_losses": losses, "shard_recoveries": recoveries,
           "shard_degraded_ticks": st["shard_degraded_ticks"]
           - before["shard_degraded_ticks"], "lost": st["lost"],
           "done": st["done"] - before["done"]}
    print(f"  shard-loss rung: unit1 killed mid-run, {degraded_ticks} ticks "
          f"on the degraded view (coverage {mid['coverage_frac']:.4f}), "
          f"revived: full store back; shard_losses {losses}, "
          f"shard_recoveries {recoveries}, lost {st['lost']}", flush=True)
    return out


def serving_ladder(model, cfg, store, corpus):
    """The same model and store under a DegradationPolicy, with snapshots:
    a burst walks the ladder down to retrieval_off, calm ticks walk it back
    to exact; then a fault injector fails retrieval until the server
    restores its store from the last snapshot. Each approx rung's
    retrieval is timed at batch SERVE_BATCH."""
    t_phase = time.perf_counter()
    rcfg = cfg.retrieval
    fts = dsearch.FaultTolerantSearch(store.codes, rcfg.code_bits,
                                      n_units=FTS_UNITS, device=DEV)
    with tempfile.TemporaryDirectory() as snap:
        srv = server.Server(
            cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
            store=store, device=DEV,
            degradation=server.DegradationPolicy(**LADDER_POLICY),
            snapshot_dir=snap, snapshot_every=SNAPSHOT_EVERY,
            shard_search=fts)
        names = [r.name for r in srv.rungs]
        ticks_at = {n: 0 for n in names}
        uid = 0

        def submit(n_new):
            nonlocal uid
            srv.submit(server.Request(
                uid=uid, prompt=corpus[uid % corpus.shape[0], :LADDER_PROMPT]
                .cpu().numpy().astype(np.int32), max_new_tokens=n_new))
            uid += 1

        for _ in range(LADDER_REQUESTS):
            submit(LADDER_NEW)
        bottom = False
        while srv.ticks < 2000 and (srv.has_work or srv.rung != 0
                                    or not bottom):
            if not srv.has_work:
                submit(1)
            ticks_at[srv.rungs[srv.rung].name] += 1
            srv.tick()
            bottom |= srv.rung == len(srv.rungs) - 1
        st = srv.stats()
        if (st["lost"] != 0 or srv.rung != 0
                or any(v == 0 for v in ticks_at.values())):
            raise AssertionError(f"ladder walk: visited {ticks_at}, rung "
                                 f"{st['rung']}, lost {st['lost']}")
        print(f"  ladder {names}: ticks at each rung {ticks_at}, "
              f"{st['transitions']} transitions, {st['done']} done, lost "
              f"{st['lost']}, snapshots saved {st['snapshot_saves']}",
              flush=True)

        inj = FailUntilRestored()
        inj.srv = srv
        srv.faults = inj
        for _ in range(SERVE_BATCH):
            submit(2)
        srv.run(max_ticks=srv.ticks + 200)
        st = srv.stats()
        if st["snapshot_restores"] < 1 or st["lost"] != 0:
            raise AssertionError(f"snapshot fallback: {st}")
        print(f"  fault injected on store_search until a restore: "
              f"{inj.fired.get('store_search', 0)} failed attempts, "
              f"search_failures {st['search_failures']}, snapshot_restores "
              f"{st['snapshot_restores']}, failover_ticks "
              f"{st['failover_ticks']}, lost {st['lost']}", flush=True)

        srv.faults = None
        shard = shard_loss_rung(srv, fts, submit)

        tok = torch.from_numpy(srv.last_token).to(DEV)
        with torch.inference_mode():
            _, _, h = lm.decode_step(model, cfg, tok, srv.state,
                                     return_hidden=True)
            h = h[:, 0, :]
            rung_ms = {"exact": cuda_ms(lambda: retrieval.knn_logits(
                store, h, rcfg, cfg.vocab_size), N_TIMED)[0]}
            for r in srv.rungs:
                if r.select == "approx":
                    rung_ms[r.name] = cuda_ms(
                        lambda r=r: retrieval.knn_logits(
                            store, h, rcfg, cfg.vocab_size, select="approx",
                            recall_target=r.recall_target), N_TIMED)[0]
        print("  retrieval at batch {}: {}".format(SERVE_BATCH, ", ".join(
            f"{k} {v:.3f} ms" for k, v in rung_ms.items())), flush=True)
        out = {"rungs": names, "ticks_at": ticks_at,
               "transitions": st["transitions"],
               "snapshot_saves": st["snapshot_saves"],
               "snapshot_restores": st["snapshot_restores"],
               "search_failures": st["search_failures"],
               "failover_ticks": st["failover_ticks"], "lost": st["lost"],
               "retrieval_ms": rung_ms,
               "p50_token_ms": st["p50_token_s"] * 1e3,
               "p99_token_ms": st["p99_token_s"] * 1e3,
               "shard_loss": shard}
        del srv
    out["stores"] = served_stores(model, cfg, store, corpus)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  ladder phase: {out['wall_s']:.1f} s", flush=True)
    return out


def served_stores(model, cfg, store, corpus):
    """The server over a MutableStore of the same datastore (its epoch
    served through ``datastore_view``, audited every STORE_AUDIT_EVERY
    ticks) with a two-tenant arena attached: online appends and deletes
    between ticks, then one ``tenant_search``, each tenant equal to its
    own store."""
    d = cfg.retrieval.code_bits
    codes = store.codes.cpu().numpy().view(np.uint32)
    values = store.values.cpu().numpy()
    n = codes.shape[0] - STORE_APPENDS * STORE_ROUNDS
    mstore, t_create = timed(lambda: mutable.MutableStore.create(
        codes[:n], d, values=values[:n], itq=store.itq, device=DEV))
    arena = tenant.TenantArena(d, bn=TENANT_BN, device=DEV)
    for i, rows in enumerate(np.array_split(np.arange(STORE_TENANT_ROWS),
                                            2)):
        arena.create_tenant(f"t{i}", codes[rows], values=values[rows])
    srv = server.Server(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                        store=mstore, device=DEV, tenants=arena,
                        audit_every=STORE_AUDIT_EVERY)
    rng = np.random.default_rng(7)
    for i in range(SERVE_BATCH):
        srv.submit(server.Request(uid=i, prompt=corpus[i, :LADDER_PROMPT]
                                  .cpu().numpy().astype(np.int32),
                                  max_new_tokens=STORE_ROUNDS))
    row = n
    while srv.has_work and srv.ticks < 500:
        if row < codes.shape[0]:
            if not (srv.submit_append(codes[row:row + STORE_APPENDS],
                                      values=values[row:row + STORE_APPENDS])
                    and srv.submit_delete(rng.choice(row, STORE_APPENDS // 2,
                                                     replace=False))
                    and srv.submit_append(codes[row:row + 4], tenant="t0")):
                raise AssertionError("a mutation was shed")
            row += STORE_APPENDS
        srv.tick()
    q = {t: codes[-8 * (i + 1):][:8] for i, t in enumerate(("t0", "t1"))}
    arena.maintain()
    res = srv.tenant_search(q, K)
    for t in q:
        own = arena.tenant(t).store.search(q[t], K)
        if not (np.array_equal(res[t][0], own[0])
                and np.array_equal(res[t][1], own[1])):
            raise AssertionError(f"tenant_search {t} != its own store")
    st = srv.stats()
    if (st["lost"] != 0 or st["audits"] == 0 or st["audit_failures"]
            or st["store_epoch"] <= 1 or st["mutations_applied"] == 0
            or st["n_tenants"] != 2):
        raise AssertionError(f"served stores: {st}")
    print(f"  server over a MutableStore of the datastore (create "
          f"{t_create:.2f} s) and a 2-tenant arena: {st['done']} done, lost "
          f"{st['lost']}, mutations applied {st['mutations_applied']}, "
          f"epoch {st['store_epoch']}, audits {st['audits']} "
          f"(failures {st['audit_failures']}), tenant_search == each "
          f"tenant's own store", flush=True)
    out = {"create_s": t_create, "done": st["done"], "lost": st["lost"],
           "mutations_applied": st["mutations_applied"],
           "store_epoch": st["store_epoch"], "audits": st["audits"],
           "audit_failures": st["audit_failures"]}
    del srv, mstore, arena
    return out


# ---------------------------------------------------------------------------
# phase 9: the mutable store
# ---------------------------------------------------------------------------

def store_search(label, st, q):
    """One ``MutableStore.search`` with the counts zeroed just before it:
    one K1 and one K2 launch."""
    tsel.reset_launch_counts()
    out = st.search(q, K)
    torch.cuda.synchronize()
    launches = (tsel.hamming_hist_kernel.launches,
                tsel.hamming_emit_kernel.launches)
    if launches != (1, 1):
        raise AssertionError(f"{label}: K1, K2 launched {launches}")
    return out, launches


def check_store(label, st, q, got, sample):
    """``got`` == a from-scratch KNNEngine over the epoch's live rows (the
    arena rebuilt from them in id order with the frozen key bits), and its
    distances == a brute force over the live rows on sampled queries."""
    ep = st.epoch
    order = np.argsort(ep.store_ids)
    arena = layout.build_arena(
        ep.layout.codes.cpu().numpy().view(np.uint32)[order], D_BITS,
        ids=ep.store_ids[order], positions=st.arena.positions)
    live = arena.live_mask()
    ext = arena.ids[live]
    counts = [int(np.count_nonzero(live[arena.cap_starts[b]:
                                        arena.cap_starts[b + 1]]))
              for b in range(arena.n_buckets)]
    starts = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32)).to(DEV)
    eng = carry.engine(arena.codes[live], D_BITS, device=DEV)
    codes = eng.codes
    ident = torch.arange(codes.shape[0], dtype=torch.int32, device=DEV)
    eng = eng._replace(layout=layout.BucketLayout(
        codes=codes, perm=ident, inv=ident, starts=starts))
    dd, pos = eng.search(q, K)
    ids = np.where(dd.cpu().numpy() <= D_BITS,
                   ext[np.clip(pos.cpu().numpy(), 0, len(ext) - 1)], -1)
    if not (np.array_equal(got[0], dd.cpu().numpy())
            and np.array_equal(got[1], ids)):
        raise AssertionError(f"{label}: != the from-scratch engine")
    full = binary.hamming_xor(q[sample], codes)
    if not np.array_equal(topk.topk_ref(full, K)[0].cpu().numpy(),
                          got[0][sample.cpu().numpy()]):
        raise AssertionError(f"{label}: != the brute force")


def mutable_path(seed, codes_np, q):
    """``MutableStore.create`` over the kNN cell's codes in a temporary
    root; MUT_ROUNDS rounds of MUT_BATCH appends and MUT_BATCH deletes (a
    snapshot half way), flush, search (gated against a from-scratch engine
    and a brute force); then a crash without close, ``recover`` and
    ``audit``, and the same search again."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 30)
    centers = rng.integers(0, 1 << 32, size=(N_CLUSTERS, codes_np.shape[1]),
                           dtype=np.uint32)
    sample = torch.from_numpy(rng.choice(N_QUERIES, N_GATE,
                                         replace=False)).to(DEV)
    with tempfile.TemporaryDirectory() as root:
        st, t_create = timed(lambda: mutable.MutableStore.create(
            codes_np, D_BITS, root=root, device=DEV))
        live = np.arange(codes_np.shape[0], dtype=np.int64)
        t0 = time.perf_counter()
        t_snap = 0.0
        for r in range(MUT_ROUNDS):
            ids = st.append(clustered_codes(rng, MUT_BATCH, centers),
                            values=rng.integers(0, 1 << 20, MUT_BATCH)
                            .astype(np.int32))
            live = np.concatenate([live, ids])
            pick = rng.choice(live.shape[0], MUT_BATCH, replace=False)
            if st.delete(live[pick]) != MUT_BATCH:
                raise AssertionError("a live id was not deleted")
            live = np.delete(live, pick)
            if r == MUT_ROUNDS // 2 - 1:
                _, t_snap = timed(st.snapshot)
        t_mut = time.perf_counter() - t0
        _, t_flush = timed(st.flush)
        if st.epoch.n != live.shape[0] or not np.array_equal(
                np.sort(st.epoch.store_ids), np.sort(live)):
            raise AssertionError("the epoch's ids != the live ids")
        got, launches = store_search("mutable store search", st, q)
        check_store("mutable store search", st, q, got, sample)
        ms, _ = cuda_ms(lambda: st.search(q, K), N_TIMED)
        checksum = st.epoch.checksum
        print(f"  mutable store: create {t_create:.2f} s; {MUT_ROUNDS} x "
              f"({MUT_BATCH} appends + {MUT_BATCH} deletes) {t_mut:.2f} s "
              f"(snapshot half way {t_snap:.2f} s); flush "
              f"{t_flush * 1e3:.1f} ms; {st.epoch.n} live rows; search "
              f"{ms:.3f} ms, K1, K2 launches {launches}, == the "
              f"from-scratch engine and the brute force", flush=True)
        del st                       # the crash: no close, no flush
        rec, t_rec = timed(lambda: mutable.MutableStore.recover(
            root, device=DEV))
        report = rec.audit()
        got2, _ = store_search("recovered store search", rec, q)
        if (not report["ok"] or rec.epoch.checksum != checksum
                or not np.array_equal(got2[0], got[0])
                or not np.array_equal(got2[1], got[1])):
            raise AssertionError(f"recovery: audit {report}, checksum "
                                 f"{rec.epoch.checksum} != {checksum}, or "
                                 f"the search differs")
        print(f"  crash, recover {t_rec:.2f} s (audit ok, epoch checksum "
              f"equal, search equal)", flush=True)
        rec.close()
    out = {"rows": int(live.shape[0]), "create_s": t_create,
           "mutate_s": t_mut, "snapshot_s": t_snap,
           "flush_ms": t_flush * 1e3, "search_ms": ms,
           "k1_launches": launches[0], "k2_launches": launches[1],
           "recover_s": t_rec, "wall_s": time.perf_counter() - t_phase}
    print(f"  mutable phase: {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the tenant arena
# ---------------------------------------------------------------------------

def tenant_path(codes_np, q_np):
    """8 tenants of uneven sizes over the kNN cell's codes in one arena of
    TENANT_BN-row tiles; a mixed batch of N_QUERIES queries through one K1
    and one K2 launch, each tenant's answer gated equal to its own
    ``MutableStore.search`` and the split emit equal to the single-run
    one."""
    t_phase = time.perf_counter()
    arena, t_build = timed(lambda: _tenants(codes_np))
    tids = arena.healthy_tids()
    share = np.array_split(np.arange(N_QUERIES), len(tids))
    queries = {t: q_np[rows] for t, rows in zip(tids, share)}
    arena.pack()
    tsel.reset_launch_counts()
    res = arena.search(queries, K)
    torch.cuda.synchronize()
    launches = (tsel.hamming_hist_kernel.launches,
                tsel.hamming_emit_kernel.launches)
    if launches != (1, 1):
        raise AssertionError(f"tenant search: K1, K2 launched {launches}")
    single = arena.search(queries, K, emit="single")
    for t in tids:
        own = arena.tenant(t).store.search(queries[t], K)
        for other, what in ((own, "its own store"), (single[t], "single")):
            if not (np.array_equal(res[t][0], other[0])
                    and np.array_equal(res[t][1], other[1])):
                raise AssertionError(f"tenant {t}: split emit != {what}")
    _, t_search = timed(lambda: arena.search(queries, K))
    ms, _ = cuda_ms(lambda: arena.search(queries, K), N_TIMED)
    st = arena.stats()
    print(f"  tenant arena: {len(tids)} tenants "
          f"{[arena.tenant(t).store.n_live for t in tids]} rows, "
          f"{st['packed_rows']} packed rows ({st['packed_pad_rows']} pads), "
          f"bn {TENANT_BN}, built {t_build:.2f} s; mixed batch of "
          f"{N_QUERIES}: K1, K2 launches {launches}, {ms:.3f} ms; == each "
          f"tenant's own store, split == single-run emit", flush=True)
    out = {"tenants": len(tids), "packed_rows": st["packed_rows"],
           "pad_rows": st["packed_pad_rows"], "bn": TENANT_BN,
           "build_s": t_build, "search_ms": ms, "search_wall_s": t_search,
           "k1_launches": launches[0], "k2_launches": launches[1],
           "wall_s": time.perf_counter() - t_phase}
    arena.close()
    print(f"  tenant phase: {out['wall_s']:.1f} s", flush=True)
    return out


def _tenants(codes_np):
    arena = tenant.TenantArena(D_BITS, bn=TENANT_BN, device=DEV)
    off = 0
    for i, n in enumerate(TENANT_SIZES):
        arena.create_tenant(f"t{i}", codes_np[off:off + n])
        off += n
    return arena



# ---------------------------------------------------------------------------
# the sharded path: engine.search_sharded over SHARD_RANKS gloo ranks
# ---------------------------------------------------------------------------

def shard_cases(uneven, dead: int):
    """(name, store, search_sharded arguments) of every sharded case;
    "padded" is the ``uneven`` store, ``dead`` the dead shard, and an
    approx case's arguments name its recall target."""
    part = [0 if s == dead else 1 for s in range(len(uneven))]
    return (
        ("hist_merge", "even", {}),
        ("hist_tree", "even", {"merge": "hist_tree",
                               "fanout": SHARD_FANOUT}),
        ("concat_sort", "even", {"merge": "concat_sort", "select": "fused"}),
        ("concat_sort_k4", "even", {"k_local": SHARD_KLOCAL,
                                    "select": "fused"}),
        ("reorder_local", "even", {"reorder_local": True}),
        ("uneven", "padded", {"shard_n_valid": list(uneven)}),
        ("dead", "even", {"shard_participate": part}),
    ) + tuple((f"approx_rt{rt}", "even", {"recall_target": rt})
              for rt in SHARD_APPROX_RT)


def _stamp(dev: str):
    if dev == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def shard_rank(rank: int, cfg: dict) -> None:
    """One rank of the sharded path, in a process of its own: joins the
    gloo world, holds its slice of the store on the card, runs every case
    with the launch counts zeroed just before and read just after, times
    the hist_merge search and its phases, and writes its results and a
    JSON summary into ``cfg["dir"]``. Any failure raises (exit code 1)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    warnings.simplefilter("ignore")          # the legacy select= knob
    dev = cfg["dev"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{cfg['init']}",
        world_size=cfg["world"], rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        _shard_rank_cases(rank, cfg, dev, dist,
                          init_device_mesh(dev, (cfg["world"],),
                                           mesh_dim_names=SHARD_AXES))
    finally:
        dist.destroy_process_group()


def _shard_rank_cases(rank, cfg, dev, dist, mesh):
    out = Path(cfg["dir"])
    world, d, k = cfg["world"], cfg["d"], cfg["k"]
    q = carry.codes(np.load(out / "q.npy"), dev)
    x = {name: engine.shard_datastore(np.load(out / f"{name}.npy",
                                              mmap_mode="r"),
                                      mesh, SHARD_AXES, device=dev)
         for name in ("even", "padded")}
    calls = {"K1": 0, "K2": 0}
    if dev == "cpu":
        # a rehearsal: CPU tensors never launch, so count the plain calls
        for name, key in (("hamming_hist_kernel", "K1"),
                          ("hamming_emit_kernel", "K2")):
            def counted(*a, _f=getattr(ops, name), _k=key, **kw):
                calls[_k] += 1
                return _f(*a, **kw)
            setattr(ops, name, counted)

    def launches():
        if dev == "cpu":
            return [calls["K1"], calls["K2"]]
        return [tsel.hamming_hist_kernel.launches,
                tsel.hamming_emit_kernel.launches]

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def run(store, kw):
        if "recall_target" in kw:
            stats = plan.stats_for(x[store].shape[0] * world, d,
                                   q.shape[1], q.shape[0], n_shards=world)
            p = plan.plan_sharded(stats, k, axes=SHARD_AXES, select="approx",
                                  recall_target=kw["recall_target"])
            return plan.execute(p, q, codes=x[store], mesh=mesh)
        return engine.search_sharded(x[store], q, k, d, mesh, SHARD_AXES,
                                     device=dev, **kw)

    summary = {"rank": rank, "launches": {}}
    for name, store, kw in shard_cases(cfg["uneven"], cfg["dead"]):
        tsel.reset_launch_counts()
        calls.update(K1=0, K2=0)
        dist.barrier()
        dd, ii = run(store, kw)
        sync()
        summary["launches"][name] = launches()
        np.save(out / f"{name}.r{rank}.npy",
                np.stack([dd.cpu().numpy(), ii.cpu().numpy()]))

    # each rank's K2 split over runs of N tiles against the single-run
    # emit from the shard's bases (outside the counted searches)
    split = np.load(out / f"hist_merge.r{rank}.npy")
    single = ops.hamming_topk_sharded(q, x["even"], k, d + 1, SHARD_AXES,
                                      mesh=mesh, n_shards=world,
                                      emit="single")
    summary["single_run_emit_equal"] = bool(np.array_equal(
        split, np.stack([a.cpu().numpy() for a in single])))

    def timed(fn):
        times = []
        for _ in range(SHARD_TIMED + 1):       # the first is a warm-up
            dist.barrier()
            sync()
            a = _stamp(dev)
            fn()
            times.append(_elapsed_ms(a, _stamp(dev)))
        return statistics.median(times[1:])

    summary["search_ms"] = timed(lambda: run("even", {}))
    runs = []
    for _ in range(SHARD_TIMED + 1):
        marks = []
        dist.barrier()
        sync()
        ops.hamming_topk_sharded(
            q, x["even"], k, d + 1, SHARD_AXES, mesh=mesh, n_shards=world,
            mark=lambda phase: marks.append((phase, _stamp(dev))))
        sync()
        runs.append({p: _elapsed_ms(a, b)
                     for (p, a), (_, b) in zip(marks, marks[1:])})
    summary["phase_ms"] = {p: statistics.median(r[p] for r in runs[1:])
                           for p in SHARD_PHASES}
    # the same three reductions of host tensors: gloo's ring over loopback
    # alone, without the staging of CUDA tensors through host memory
    summary["host_reduce_ms"] = {}
    for phase, shape in (("hist_reduce", (q.shape[0], d + 1)),
                         ("counts", (world, q.shape[0], 2)),
                         ("out_reduce", (2, q.shape[0], k))):
        buf = torch.zeros(shape, dtype=torch.int32)
        times = []
        for _ in range(SHARD_TIMED + 1):
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            times.append((time.perf_counter() - t0) * 1e3)
        summary["host_reduce_ms"][phase] = statistics.median(times[1:])
    (out / f"rank{rank}.json").write_text(json.dumps(summary))


def _uneven_store(codes_np):
    """The main store's rows, shard s holding SHARD_UNEVEN[s] consecutive
    rows, each padded with all-ones rows to the largest."""
    nv = np.asarray(SHARD_UNEVEN)
    if nv.sum() != codes_np.shape[0] or len(nv) != SHARD_RANKS:
        raise AssertionError(f"SHARD_UNEVEN {nv} does not split "
                             f"{codes_np.shape[0]} rows over {SHARD_RANKS}")
    slc = int(nv.max())
    padded = np.full((SHARD_RANKS * slc, codes_np.shape[1]), 0xFFFFFFFF,
                     np.uint32)
    off = np.concatenate([[0], np.cumsum(nv)])
    for s in range(SHARD_RANKS):
        padded[s * slc:s * slc + nv[s]] = codes_np[off[s]:off[s + 1]]
    return padded


def _run_ranks(cfg, target=None) -> float:
    """Spawn ``cfg["world"]`` ranks of ``target`` (``shard_rank`` unless
    given) and wait; the first rank to fail, or the phase outliving
    SHARD_TIMEOUT_S, ends every rank and fails the phase."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or shard_rank, args=(r, cfg))
             for r in range(cfg["world"])]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"ranks of {(target or shard_rank).__name__} "
                             f"exited with {codes}")
    return time.perf_counter() - t0


def _true_dists(codes_t, q, ids):
    """(Q, k) Hamming distance of every returned id to its query."""
    x = codes_t[ids.clamp(0, codes_t.shape[0] - 1).long()]    # (Q, k, W)
    return binary.popcount32(q[:, None, :] ^ x).sum(dim=-1, dtype=torch.int32)


def sharded_path(codes_np, q, fused):
    """``engine.search_sharded`` over SHARD_RANKS gloo ranks, each a process
    holding its 2^20 / SHARD_RANKS-row slice of the main store on the one
    card: hist_merge, hist_tree (fanout 2), concat_sort (k' = k, and the
    statistical k' < k), reorder_local, uneven shards, a dead shard, and
    the approx tier. Every exact case equals the single-device fused
    search over the same rows (the surviving rows; for reorder_local the
    ranks' local_sort layouts side by side) on every query, dists and ids,
    with one K1 and one K2 launch per rank; every rank's answer is the
    same. Per rank: the hist_merge search and its phases (K1, histogram
    all_reduce, counts all-gather, K2, output all_reduce), median of
    SHARD_TIMED, CUDA events after a barrier."""
    t_phase = time.perf_counter()
    world = SHARD_RANKS
    n_loc = N_ROWS // world
    fd, fi = fused
    codes_t = carry.codes(codes_np, DEV)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "even.npy", codes_np)
        np.save(tmp / "padded.npy", _uneven_store(codes_np))
        np.save(tmp / "q.npy", q.cpu().numpy().view(np.uint32))
        cfg = {"dev": DEV, "world": world, "init": str(tmp / "init"),
               "dir": str(tmp), "d": D_BITS, "k": K,
               "uneven": list(SHARD_UNEVEN), "dead": SHARD_DEAD}
        wall = _run_ranks(cfg)
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(world)]
        got = {}
        for name, _, _ in shard_cases(SHARD_UNEVEN, SHARD_DEAD):
            outs = [np.load(tmp / f"{name}.r{r}.npy") for r in range(world)]
            if any(not np.array_equal(o, outs[0]) for o in outs[1:]):
                raise AssertionError(f"sharded {name}: the ranks disagree")
            got[name] = tuple(torch.from_numpy(a).to(DEV) for a in outs[0])

    # the single-device references on the card
    bins = D_BITS + 1
    surv = torch.cat([codes_t[:SHARD_DEAD * n_loc],
                      codes_t[(SHARD_DEAD + 1) * n_loc:]])
    sorted_parts = [layout.local_sort(codes_t[s * n_loc:(s + 1) * n_loc],
                                      D_BITS) for s in range(world)]
    rd, rp = ops.hamming_topk(q, torch.cat([c for c, _ in sorted_parts]), K,
                              bins)
    perm = torch.cat([p + s * n_loc for s, (_, p) in enumerate(sorted_parts)])
    local = [ops.hamming_topk(q, codes_t[s * n_loc:(s + 1) * n_loc],
                              SHARD_KLOCAL, bins) for s in range(world)]
    ld = torch.cat([dd for dd, _ in local], dim=1)
    li = torch.cat([ii + s * n_loc for s, (_, ii) in enumerate(local)], dim=1)
    if not all(r["single_run_emit_equal"] for r in ranks):
        raise AssertionError("a rank's split K2 != its single-run emit")
    want = {"hist_merge": (fd, fi), "hist_tree": (fd, fi),
            "concat_sort": (fd, fi), "uneven": (fd, fi),
            "dead": ops.hamming_topk(q, surv, K, bins),
            "reorder_local": (rd, perm[rp.long()]),
            "concat_sort_k4": topk.sort_key_val(ld, li),
            "approx_rt1.0": (fd, fi)}
    cases = {}
    for name, _, kw in shard_cases(SHARD_UNEVEN, SHARD_DEAD):
        dd, ii = got[name]
        per_rank = [r["launches"][name] for r in ranks]
        expect = [0, 0] if name.startswith("approx") else [1, 1]
        if any(lc != expect for lc in per_rank):
            raise AssertionError(f"sharded {name}: launches per rank "
                                 f"{per_rank}, expected {expect}")
        row = {"launches_per_rank": per_rank[0]}
        if name in want:
            wd, wi = want[name]
            if not (torch.equal(dd, wd) and torch.equal(ii, wi)):
                raise AssertionError(f"sharded {name} != the single-device "
                                     f"fused search over the same rows")
            row["equal"] = True
        if name in ("concat_sort_k4", "approx_rt0.9"):
            if not torch.equal(_true_dists(codes_t, q, ii), dd):
                raise AssertionError(f"sharded {name}: an id's distance "
                                     f"differs from its reported one")
            if bool((dd[:, 1:] < dd[:, :-1]).any()):
                raise AssertionError(f"sharded {name}: not ascending")
            row["recall"] = recall_at(ii, fi)
        cases[name] = row
    bound = hierarchy.failure_bound(K, world, SHARD_KLOCAL)
    cases["concat_sort_k4"]["failure_bound"] = bound
    # the ranks' approx geometry: blocks of their slice, L for the global
    # pool of every rank's blocks
    bn = min(tuning.approx_blocks(N_QUERIES, n_loc, D_BITS // 32,
                                  backend=device.backend_of(q)), n_loc)
    n_blocks = -(-n_loc // bn)
    l9 = approx_select.l_for_recall(K, world * n_blocks, bn, 0.9)
    cases["approx_rt0.9"].update(
        bn=bn, l=l9, predicted_recall=approx_select.expected_recall(
            K, world * n_blocks, l9))
    med = lambda key: statistics.median(r[key] for r in ranks)
    out = {"ranks": world, "rows_per_rank": n_loc,
           "uneven_rows": list(SHARD_UNEVEN), "cases": cases,
           "single_run_emit_equal": True,
           "search_ms_per_rank": [r["search_ms"] for r in ranks],
           "search_ms": med("search_ms"),
           "phase_ms": {p: statistics.median(r["phase_ms"][p] for r in ranks)
                        for p in SHARD_PHASES},
           "phase_ms_per_rank": [r["phase_ms"] for r in ranks],
           "host_reduce_ms": {p: statistics.median(
               r["host_reduce_ms"][p] for r in ranks)
               for p in ("hist_reduce", "counts", "out_reduce")},
           "ranks_wall_s": wall}
    print(f"  {world} ranks x {n_loc} rows: every exact case == fused on "
          f"{N_QUERIES} queries (dead shard {SHARD_DEAD}: == its surviving "
          f"rows; reorder_local: == the ranks' layouts side by side), one K1 "
          f"+ one K2 per rank per search; concat k'={SHARD_KLOCAL} recall@"
          f"{K} {cases['concat_sort_k4']['recall']:.4f} (failure bound "
          f"{bound:.4f}); approx rt 1.0 == fused, rt 0.9 recall "
          f"{cases['approx_rt0.9']['recall']:.4f} (predicted "
          f"{cases['approx_rt0.9']['predicted_recall']:.4f})", flush=True)
    print("  per rank (median of {}): search {} ms; {}".format(
        SHARD_TIMED, ", ".join(f"{r['search_ms']:.3f}" for r in ranks),
        "; ".join(f"{p} " + ", ".join(f"{r['phase_ms'][p]:.3f}"
                                       for r in ranks)
                  for p in SHARD_PHASES)), flush=True)
    print("  the same reductions of host tensors (median over ranks): "
          + ", ".join(f"{p} {v:.3f} ms"
                      for p, v in out["host_reduce_ms"].items()), flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  sharded phase: {out['wall_s']:.1f} s (ranks {wall:.1f} s)",
          flush=True)
    return out


def shard_faults(codes_np, q, fused):
    """``FaultTolerantSearch`` over the main store, FTS_UNITS units at
    factor FTS_FACTOR on the card: healthy; units killed (a replica
    serves, then a range is lost); injected shard_hist / shard_emit /
    merge_psum faults; revived units and maintain() until coverage is
    whole; a cold revive refilled from replicas. Every answer equals
    ``reference_over_covered`` and, on sampled queries, an on-card brute
    force over the covered rows."""
    t_phase = time.perf_counter()
    codes_t = carry.codes(codes_np, DEV)
    fts = dsearch.FaultTolerantSearch(codes_np, D_BITS, n_units=FTS_UNITS,
                                      factor=FTS_FACTOR, device=DEV)
    sample = torch.from_numpy(np.random.default_rng(5).choice(
        N_QUERIES, N_GATE, replace=False)).to(DEV)
    full = binary.hamming_xor(q[sample], codes_t)              # (S, N)
    steps_out = []

    def check(label):
        tsel.reset_launch_counts()
        t0 = time.perf_counter()
        dd, ii, rep = fts.search(q, K)
        ms = (time.perf_counter() - t0) * 1e3
        launches = [tsel.hamming_hist_kernel.launches,
                    tsel.hamming_emit_kernel.launches]
        m = fts.covered_row_ids()
        rd, ri = dsearch.reference_over_covered(codes_t, q, K, D_BITS, m,
                                                device=DEV)
        if not (np.array_equal(dd, rd) and np.array_equal(ii, ri)):
            raise AssertionError(f"fault-tolerant search, {label}: != "
                                 f"reference_over_covered")
        covered = torch.zeros(codes_t.shape[0], dtype=torch.bool,
                              device=DEV)
        covered[torch.from_numpy(m).to(DEV)] = True
        ref_d, _ = topk.topk_ref(torch.where(covered, full, D_BITS + 1), K)
        dd_s = torch.from_numpy(dd).to(DEV)[sample]
        ii_s = torch.from_numpy(ii).to(DEV)[sample].long()
        if not (torch.equal(ref_d, dd_s) and bool(covered[ii_s].all())
                and torch.equal(torch.gather(full, 1, ii_s), dd_s)):
            raise AssertionError(f"fault-tolerant search, {label}: != the "
                                 f"on-card brute force over covered rows")
        row = {"step": label, "coverage": rep.as_dict(), "ms": ms,
               "launches": launches, "counters": dict(fts.counters)}
        steps_out.append(row)
        print(f"  {label}: coverage {rep.coverage_frac:.4f} (dead "
              f"{list(rep.dead_shards)}), {ms:.1f} ms, launches K1/K2 "
              f"{launches}, == reference and brute force; counters "
              f"{fts.counters}", flush=True)
        return dd, ii

    dd, ii = check("healthy")
    if not (np.array_equal(dd, fused[0].cpu().numpy())
            and np.array_equal(ii, fused[1].cpu().numpy())):
        raise AssertionError("healthy fault-tolerant search != fused")
    fts.kill("unit1")
    check("unit1 killed (its replica serves)")
    fts.kill("unit2")
    check("unit1 and unit2 killed (range 1 lost)")
    fts.injector = faults.FaultInjector(seed=7, p={
        "shard_hist@unit0": 1.0, "shard_emit@unit3": 0.5,
        "merge_psum": 0.5})
    check("injected shard_hist / shard_emit / merge_psum faults")
    fired = dict(fts.injector.fired)
    fts.injector = None
    for u in fts.registry.dead():
        fts.revive(u, with_data=True)
    rounds = 0
    while (not fts.coverage().complete or fts.registry.not_serving()) \
            and rounds < 4 * FTS_UNITS:
        fts.maintain()
        rounds += 1
    check(f"revived and maintained ({rounds} rounds)")
    fts.kill("unit3")
    fts.revive("unit3", with_data=False)
    cold = 0
    while fts.registry.not_serving() and cold < 4 * FTS_UNITS:
        fts.maintain(budget=1)
        cold += 1
    dd, ii = check(f"unit3 revived cold, refilled ({cold} rounds)")
    if not fts.coverage().complete or fts.registry.not_serving():
        raise AssertionError(f"coverage not restored: {fts.stats()}")
    out = {"units": FTS_UNITS, "factor": FTS_FACTOR, "steps": steps_out,
           "injected": fired, "stats": fts.stats(),
           "wall_s": time.perf_counter() - t_phase}
    print(f"  shard-faults phase: {out['wall_s']:.1f} s", flush=True)
    return out


def _max_param_diff(a, b) -> float:
    return max(float((pa.detach().cpu().float() - pb.detach().cpu().float())
                     .abs().max())
               for (_, pa), (_, pb) in zip(a.named_parameters(),
                                           b.named_parameters()))


def _kernel_kind(name: str) -> str:
    """A device event's kind, from its name (cuBLAS, CUTLASS and ATen)."""
    n = name.lower()
    if "sgemm" in n or "f32f32" in n:
        return "f32 GEMM (CUDA cores)"
    if "gemm" in n or "nvjet" in n or "xmma" in n:
        return "GEMM (tensor cores)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copy or cast"
    if "elementwise" in n:
        return "elementwise"
    if "reduce" in n:
        return "reduction"
    return "other"


def _profile_step(step_fn, model, opt, batch, step) -> dict:
    """One train step under torch.profiler (``_profile``)."""
    return _profile(lambda: step_fn(model, opt, batch, step))


def _profile(fn) -> dict:
    """``fn()`` once under torch.profiler: wall ms, the summed device time
    of its kernels and copies, by kind, their count, and the kernels that
    take the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    n_events = 0
    # the raw trace: ``prof.events()`` would first build Python objects
    # for every CPU op, ~80 s for a recurrent training step's ~10^5 ops
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n_events += 1
            by_name[e.name()] = (by_name.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6)
    device_ms = sum(by_name.values())
    by_kind: dict = {}
    for n, ms in by_name.items():
        by_kind[_kernel_kind(n)] = by_kind.get(_kernel_kind(n), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TRAIN_PROFILE_TOP]
    return {"wall_ms": wall_ms, "device_ms": device_ms or "not measured",
            "busy_share": device_ms / wall_ms if device_ms else
            "not measured", "kernels": len(by_name),
            "device_events": n_events, "by_kind": by_kind,
            "top": [[n[:90], ms] for n, ms in top]}


def train_full_width(seed: int, arch: str = ARCH, micro: int = TRAIN_MICRO,
                     profile_one_micro: bool = False) -> dict:
    """``arch`` at its registered width and depth through trainer.train,
    in ``micro`` microbatches."""
    cfg = get_config(arch)
    n_params = lm.param_count(cfg)
    tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1,
                     microbatches=micro, seed=seed)
    # the initial weights, as the trainer draws them, kept on the host
    init = lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                          cfg, device=DEV)
    snap = {n: p.detach().cpu() for n, p in init.named_parameters()}
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    print(f"  model: {arch}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} x {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_params:,} parameters; AdamW f32 moments, remat "
          f"{tc.remat}", flush=True)
    print(f"  cut: train_4k takes 256 x 4096 tokens a step; this run takes "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} in {micro} "
          f"microbatches, {TRAIN_STEPS} steps (one card's memory, the time "
          f"limit)", flush=True)
    steps_out = []
    rep = trainer.train(
        cfg, tc, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, device=DEV,
        log_every=0, on_metrics=lambda s, m: steps_out.append(
            {"step": s, "loss": float(m["loss"]),
             "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"])}))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for row, dt in zip(steps_out, rep.step_times):
        row["ms"] = dt * 1e3
        print(f"  step {row['step']}: loss {row['loss']:.4f}, grad_norm "
              f"{row['grad_norm']:.4f}, lr {row['lr']:.3e}, "
              f"{row['ms']:.1f} ms", flush=True)
    if len(steps_out) != TRAIN_STEPS or rep.steps_done != TRAIN_STEPS:
        raise AssertionError(f"{rep.steps_done} steps ran, expected "
                             f"{TRAIN_STEPS}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in steps_out):
        raise AssertionError(f"a loss or grad norm is not finite: "
                             f"{steps_out}")
    # step 0 runs at lr 0 (warmup 1): the weights move from step 1 on
    unchanged = [n for n, p in rep.model.named_parameters()
                 if torch.equal(p.detach().cpu(), snap[n])]
    if unchanged:
        raise AssertionError(f"parameters unchanged by training: "
                             f"{unchanged[:5]} ({len(unchanged)} in all)")
    del snap
    st = rep.opt_state
    tensors = list(rep.model.parameters()) + [st.count] + [
        t for tree in (st.mu, st.nu) for t in tree.values()]
    off = sum(t.device.type != torch.device(DEV).type for t in tensors)
    if off:
        raise AssertionError(f"{off} parameters or moments are not on the "
                             f"card")
    if sum(p.numel() for p in rep.model.parameters()) != n_params:
        raise AssertionError("the model's parameters != param_count")
    step_s = statistics.median(rep.step_times[1:])
    # one more step under the profiler: where the step's time goes (with
    # ``profile_one_micro``, a step of one microbatch's tokens: the
    # recurrent stacks' chunk loops take the profiler's time per launch)
    p_micro = 1 if profile_one_micro else micro
    ptc = dataclasses.replace(tc, microbatches=p_micro)
    dc = pipeline.data_config_for(cfg, TRAIN_SEQ, TRAIN_BATCH * p_micro
                                  // micro, tc.seed)
    prof = _profile_step(steps.make_train_step(cfg, ptc, device=DEV),
                         rep.model, rep.opt_state,
                         pipeline.make_batch(dc, TRAIN_STEPS), TRAIN_STEPS)
    prof["tokens"] = dc.global_batch * TRAIN_SEQ
    print(f"  profiled step of {dc.global_batch} x {TRAIN_SEQ} tokens: wall "
          f"{prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']} ms (busy share {prof['busy_share']}) over "
          f"{prof['kernels']} kernel names; by "
          f"kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              prof["by_kind"].items(), key=lambda kv: -kv[1])) + "; top:",
          flush=True)
    for name, ms in prof["top"]:
        print(f"    {ms:9.2f} ms  {name}", flush=True)
    out = {"arch": arch, "n_params": n_params, "dtype": cfg.dtype,
           "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "microbatches": micro, "steps": steps_out,
           "cut": f"train_4k 256 x 4096 -> {TRAIN_BATCH} x {TRAIN_SEQ}, "
                  f"{TRAIN_STEPS} steps",
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "train_mfu": 6 * n_params * tokens / (step_s * BF16_FLOPS_PER_S),
           "peak_mem_gb": peak_gb, "profile": prof}
    print(f"  steady step (median of steps 1-{TRAIN_STEPS - 1}) "
          f"{out['median_step_ms']:.1f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s, train_mfu {out['train_mfu']:.4f}, peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    del rep, st, tensors
    torch.cuda.empty_cache()
    return out


def _small_run(cfg, tc, dc, dev, seed, tf32=False):
    """TRAIN_CHECK_STEPS make_train_step steps of the scaled model on
    ``dev`` from weights drawn on the CPU: (model, per-step losses)."""
    model = lm.init_params(torch.Generator().manual_seed(seed + 11), cfg,
                           device=dev)
    opt = optimizer.init(dict(model.named_parameters()), tc)
    step = steps.make_train_step(cfg, tc, device=dev)
    losses = []
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for s in range(TRAIN_CHECK_STEPS):
            model, opt, m = step(model, opt, pipeline.make_batch(dc, s), s)
            losses.append(float(m["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if next(model.parameters()).device.type != torch.device(dev).type:
        raise AssertionError(f"the model left {dev}")
    return model, losses


def _against_cpu(card, cpu) -> dict:
    (gm, gl), (cm, cl) = card, cpu
    err = [abs(a - b) for a, b in zip(gl, cl)]
    return {"loss_card": gl, "loss_cpu": cl, "loss_abs_err": err,
            "loss0_abs_err": err[0], "loss_max_abs_err": max(err),
            "param_max_abs_err": _max_param_diff(gm, cm)}


def train_card_vs_cpu(seed: int, arch: str = ARCH, limits=None) -> dict:
    """The same initial weights and batches through make_train_step on the
    card and on the CPU, f32 with TF32 off, for TRAIN_CHECK_SEEDS seeds;
    then the first seed on the card with TF32 on, as the control (above
    every one of ``limits``: gemma's unless given)."""
    cfg = scaled_down(get_config(arch), dtype="float32")
    limits = limits or {"loss0_abs_err": TRAIN_LOSS0_ATOL,
                        "loss_max_abs_err": TRAIN_LOSS_ATOL,
                        "param_max_abs_err": TRAIN_PARAM_ATOL}
    out = {"arch": arch, "steps": TRAIN_CHECK_STEPS, "tol": limits,
           "seeds": {}}
    for sd in range(seed, seed + TRAIN_CHECK_SEEDS):
        tc = TrainConfig(total_steps=TRAIN_CHECK_STEPS, warmup_steps=0,
                         seed=sd)
        dc = pipeline.data_config_for(cfg, TRAIN_SMALL_SEQ,
                                      TRAIN_SMALL_BATCH, sd)
        cpu = _small_run(cfg, tc, dc, "cpu", sd)
        r = _against_cpu(_small_run(cfg, tc, dc, DEV, sd), cpu)
        out["seeds"][sd] = r
        print(f"  card vs CPU, seed {sd} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, f32): loss errors "
              f"{', '.join(f'{e:.2e}' for e in r['loss_abs_err'])}, params "
              f"{r['param_max_abs_err']:.2e}", flush=True)
        if sd == seed:
            ctl = _against_cpu(_small_run(cfg, tc, dc, DEV, sd, tf32=True),
                               cpu)
            out["control_tf32"] = ctl
            print(f"  control, seed {sd} with TF32 on: loss errors "
                  f"{', '.join(f'{e:.2e}' for e in ctl['loss_abs_err'])}, "
                  f"params {ctl['param_max_abs_err']:.2e}", flush=True)
        del cpu
    for key, lim in limits.items():
        worst = max(r[key] for r in out["seeds"].values())
        if worst > lim:
            raise AssertionError(f"card and CPU training disagree: {key} "
                                 f"{worst} > {lim}: {out}")
        if out["control_tf32"][key] <= lim:
            raise AssertionError(f"the TF32 control passes the {key} limit "
                                 f"{lim}: {out['control_tf32']}")
    return out


def train_preempt_resume(seed: int) -> dict:
    """trainer.train preempted at TRAIN_PREEMPT_AT and resumed, against an
    uninterrupted run, all on the card."""
    cfg = scaled_down(get_config(ARCH), dtype="float32")
    tc = TrainConfig(total_steps=TRAIN_RESUME_STEPS, warmup_steps=1,
                     seed=seed)
    kw = dict(seq_len=TRAIN_SMALL_SEQ, global_batch=TRAIN_SMALL_BATCH,
              device=DEV, log_every=0)
    full = trainer.train(cfg, tc, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "run")
        try:
            trainer.train(cfg, tc, ckpt_dir=root,
                          ckpt_every=TRAIN_CKPT_EVERY,
                          preempt_at=TRAIN_PREEMPT_AT, **kw)
            raise AssertionError("the preempted run did not raise")
        except trainer.PreemptionError:
            pass
        rep = trainer.train(cfg, tc, ckpt_dir=root,
                            ckpt_every=TRAIN_CKPT_EVERY, **kw)
    err = _max_param_diff(rep.model, full.model)
    out = {"preempt_at": TRAIN_PREEMPT_AT, "steps": TRAIN_RESUME_STEPS,
           "resumed_from": rep.resumed_from,
           "final_loss": rep.final_loss, "uninterrupted_loss": full.final_loss,
           "param_max_abs_err": err, "tol": TRAIN_RESUME_ATOL}
    print(f"  preempted at step {TRAIN_PREEMPT_AT}, resumed from "
          f"{rep.resumed_from}: final params {err:.2e} from the "
          f"uninterrupted run, loss {rep.final_loss:.6f} vs "
          f"{full.final_loss:.6f}", flush=True)
    if rep.resumed_from != TRAIN_PREEMPT_AT or err > TRAIN_RESUME_ATOL:
        raise AssertionError(f"resume differs from the uninterrupted run: "
                             f"{out}")
    return out


def train_path(seed: int) -> dict:
    """Training on the card: gemma-2b at full width, then the card against
    the CPU and preemption with resume on a scaled_down model. None of
    K1-K4 may launch: training takes the blockwise attention path."""
    t0 = time.perf_counter()
    tsel.reset_launch_counts()
    tham.reset_launch_counts()
    fa.reset_launch_counts()
    out = train_full_width(seed)
    out["card_vs_cpu"] = train_card_vs_cpu(seed)
    out["preempt_resume"] = train_preempt_resume(seed)
    out["kernel_launches"] = {
        "K1": tsel.hamming_hist_kernel.launches,
        "K2": tsel.hamming_emit_kernel.launches,
        "K3": tham.hamming_distance_kernel.launches,
        "K4": fa.flash_attention_kernel.launches}
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"a kernel launched on the training path: "
                             f"{out['kernel_launches']}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"  train phase: {out['wall_s']:.1f} s", flush=True)
    return out


def moe_train_cut(full):
    """(config cut to one layer and the experts that fit, the reckoning)."""
    one = dataclasses.replace(full, num_layers=1)
    d, ff, k = full.d_model, full.moe.expert_d_ff, full.moe.experts_per_token
    per_expert = 12 * 3 * d * ff + 16 * d
    with_k = dataclasses.replace(one, moe=dataclasses.replace(
        full.moe, num_experts=k))
    fixed_params = lm.param_count(with_k) - k * (3 * d * ff + d)
    fixed = 12 * fixed_params + 4 * d * k   # the router is f32: 16 B a param
    room = (MOE_TRAIN_BUDGET_GB - MOE_TRAIN_ACT_GB) * 1e9 - fixed
    n = int(room // per_expert)
    if n < k:
        raise AssertionError(f"{full.name}: {n} experts fit, top-{k} needs "
                             f"{k}")
    cfg = dataclasses.replace(one, moe=dataclasses.replace(full.moe,
                                                           num_experts=n))
    return cfg, {"fixed_gb": fixed / 1e9, "per_expert_gb": per_expert / 1e9,
                 "budget_gb": MOE_TRAIN_BUDGET_GB,
                 "activations_gb": MOE_TRAIN_ACT_GB, "experts": n,
                 "registered_experts": full.moe.num_experts,
                 "registered_layers": full.num_layers}


def _grads_on(cfg, dev, batch, seed, tf32=False):
    """make_grad_fn on ``dev`` from weights drawn on the CPU: (loss, {name:
    grad on the CPU})."""
    model = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                           device=dev)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        grads, met = steps.make_grad_fn(cfg, TrainConfig(), device=dev)(
            model, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return float(met["loss"]), {n: g.detach().cpu() for n, g in
                                grads.items()}


def _grads_against(card, cpu) -> tuple:
    """(the loss's relative error, (the largest gradient error as a share
    of its leaf's largest entry, that leaf))."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    worst = max((float((g_card[n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30), n)
                for n, g in g_cpu.items())
    return abs(l_card - l_cpu) / abs(l_cpu), worst


def train_moe_layer(seed: int) -> dict:
    """kimi-k2's layer at full width, trained through trainer.train
    (moe_reference), then an f32 copy's gradients on the card against the
    CPU."""
    full = get_config(MOE_TRAIN_ARCH)
    cfg, cut = moe_train_cut(full)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_params = lm.param_count(cfg)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    print(f"  model: {MOE_TRAIN_ARCH} DEPTH CUT from {full.num_layers} "
          f"layers to 1, experts CUT from {full.moe.num_experts} to "
          f"{cut['experts']} (top {full.moe.experts_per_token}, one shared): "
          f"{cut['fixed_gb']:.2f} GB for the embeddings, attention, shared "
          f"expert and router at 12 B a parameter, {cut['per_expert_gb']:.3f}"
          f" GB an expert, {cut['budget_gb']:.0f} GB less "
          f"{cut['activations_gb']:.0f} GB for activations; d_model "
          f"{cfg.d_model}, expert d_ff {cfg.moe.expert_d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params:,} parameters; "
          f"{MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}",
          flush=True)
    losses = []
    tc = TrainConfig(total_steps=MOE_TRAIN_STEPS, warmup_steps=0, seed=seed)
    rep = trainer.train(cfg, tc, seq_len=MOE_TRAIN_SEQ,
                        global_batch=MOE_TRAIN_BATCH, device=DEV,
                        log_every=0, on_metrics=lambda st, m: losses.append(
                            (float(m["loss"]), float(m["aux"]),
                             float(m["grad_norm"]))))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if rep.steps_done != MOE_TRAIN_STEPS or not all(
            np.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"{MOE_TRAIN_ARCH} layer: {rep.steps_done} "
                             f"steps, losses {losses}")
    step_s = statistics.median(rep.step_times[1:] or rep.step_times)
    out = {"arch": MOE_TRAIN_ARCH, "cut": cut, "n_params": n_params,
           "tokens": tokens, "loss_aux_gnorm": losses,
           "step_ms": [t * 1e3 for t in rep.step_times],
           "tokens_per_s": tokens / step_s,
           "train_mfu": 6 * lm.param_count(cfg, active_only=True) * tokens
           / (step_s * BF16_FLOPS_PER_S), "peak_mem_gb": peak}
    print(f"  steps: (loss, aux, grad_norm) {losses}; ms "
          f"{[round(t * 1e3, 1) for t in rep.step_times]}; "
          f"{out['tokens_per_s']:.0f} tokens/s, train_mfu (active params) "
          f"{out['train_mfu']:.4f}; peak memory {peak:.2f} GB", flush=True)
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 copy cut further: its gradients on the card and on the CPU
    c32 = dataclasses.replace(
        cfg, dtype="float32", vocab_size=MOE_F32_TRAIN_VOCAB,
        moe=dataclasses.replace(cfg.moe, num_experts=MOE_F32_TRAIN_EXPERTS))
    dc = pipeline.data_config_for(c32, MOE_F32_TRAIN_S, MOE_F32_TRAIN_B, seed)
    batch = pipeline.make_batch(dc, 0)
    cpu = _grads_on(c32, "cpu", batch, seed + 3)
    card = _grads_on(c32, DEV, batch, seed + 3)
    loss_err, worst = _grads_against(card, cpu)
    ctl_loss, ctl = _grads_against(
        _grads_on(c32, DEV, batch, seed + 3, tf32=True), cpu)
    out["f32_vs_cpu"] = {"experts": MOE_F32_TRAIN_EXPERTS,
                         "vocab": MOE_F32_TRAIN_VOCAB,
                         "tokens": MOE_F32_TRAIN_B * MOE_F32_TRAIN_S,
                         "loss_card": card[0], "loss_cpu": cpu[0],
                         "loss_rel_err": loss_err,
                         "grad_rel_err": worst[0], "worst_leaf": worst[1],
                         "control_tf32": {"loss_rel_err": ctl_loss,
                                          "grad_rel_err": ctl[0],
                                          "worst_leaf": ctl[1]},
                         "tol": {"loss": MOE_F32_LOSS_RTOL,
                                 "grad": MOE_F32_GRAD_RTOL}}
    print(f"  f32 copy ({MOE_F32_TRAIN_EXPERTS} experts, vocab "
          f"{MOE_F32_TRAIN_VOCAB}) card vs CPU: loss {card[0]:.6f} vs "
          f"{cpu[0]:.6f} (rel {loss_err:.2e}, limit {MOE_F32_LOSS_RTOL}); "
          f"gradients within {worst[0]:.2e} of their leaf's largest "
          f"(limit {MOE_F32_GRAD_RTOL}; worst {worst[1]}); control, TF32 "
          f"on: loss rel {ctl_loss:.2e}, gradients {ctl[0]:.2e} (worst "
          f"{ctl[1]})", flush=True)
    if loss_err > MOE_F32_LOSS_RTOL or worst[0] > MOE_F32_GRAD_RTOL:
        raise AssertionError(f"{MOE_TRAIN_ARCH} f32 layer: card and CPU "
                             f"gradients disagree: {out['f32_vs_cpu']}")
    if ctl_loss <= MOE_F32_LOSS_RTOL or ctl[0] <= MOE_F32_GRAD_RTOL:
        raise AssertionError(f"{MOE_TRAIN_ARCH} f32 layer: the TF32 control "
                             f"passes a limit: {out['f32_vs_cpu']}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def _ept_cfg():
    """arctic-480b's width for the EP training check: one layer, f32, the
    experts cut to EP_EXPERTS at capacity factor EPT_CF, and the aux
    loss's weight 0 (a2a's aux is the mean of the ranks' sequence-chunk
    auxes, ``repro``'s definition, and not the global batch's that the
    one-device step takes; its gradient is held against ``repro`` on the
    CPU, tests/test_torch_train_ep.py, and the card against the CPU at
    scaled_down arctic, ``_ept_small_run``)."""
    cfg = get_config(MOE_ARCHS[0])
    return dataclasses.replace(
        cfg, num_layers=1, dtype="float32",
        moe=dataclasses.replace(cfg.moe, num_experts=EP_EXPERTS,
                                capacity_factor=EPT_CF, router_aux_loss=0.0))


def _ept_no_drops(cfg) -> dict:
    """The capacities of each case (``moe``'s formulas), and that none can
    drop an entry: a2a's send slots hold all of a rank's entries and each
    expert's slots every token of the global batch; allgather's
    likewise."""
    moe_cfg, n = cfg.moe, EP_RANKS
    K, E, cf = (moe_cfg.experts_per_token, moe_cfg.num_experts,
                moe_cfg.capacity_factor)
    caps = {}
    for name, seq, _ in EPT_CASES:
        tokens = EPT_B * seq
        if moe.resolve_strategy("auto", seq, n) == "a2a":
            t_loc = tokens // n
            c_send = moe._round_up(max(1, int(cf * t_loc * K / n)), 8)
            c_exp = moe._round_up(max(1, int(cf * n * c_send / (E // n))),
                                  8)
            caps[name] = {"c_send": c_send, "c_exp": c_exp}
            ok = c_send >= t_loc * K and c_exp >= tokens
        else:
            c_exp = moe._round_up(max(1, int(cf * tokens * K / E)), 8)
            caps[name] = {"c_exp": c_exp}
            ok = c_exp >= tokens
        if not ok:
            raise AssertionError(f"EP training may drop entries: {caps}")
    return caps


@contextlib.contextmanager
def _card_transport(tf32: bool = False):
    """The all_reduce transport (the card's, forced on CPU tensors) and
    TF32 as asked, for the ``with`` block."""
    real = moe.a2a_transport
    moe.a2a_transport = lambda x, group: "all_reduce"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        moe.a2a_transport = real
        torch.backends.cuda.matmul.allow_tf32 = False


def _ept_small_model(cfg, rank: int, sd: int, dev):
    """scaled arctic's weights drawn on the CPU, this rank's experts."""
    return carry.expert_shard(
        lm.init_params(torch.Generator().manual_seed(sd + 11), cfg,
                       device=dev), cfg, rank, EP_RANKS)


def _ept_small_run(mesh, rank: int, sd: int, seq: int, dev,
                   tf32: bool = False):
    """TRAIN_CHECK_STEPS mesh train steps of scaled_down arctic (f32, the
    aux loss weighted) on ``dev``, over the all_reduce transport: (this
    rank's model, per-step losses)."""
    cfg = scaled_down(get_config(MOE_ARCHS[0]), dtype="float32")
    tc = TrainConfig(total_steps=TRAIN_CHECK_STEPS, warmup_steps=0, seed=sd)
    dc = pipeline.data_config_for(cfg, seq, EPT_SMALL_B, sd)
    model = _ept_small_model(cfg, rank, sd, dev)
    opt = optimizer.init(dict(model.named_parameters()), tc)
    step = steps.make_train_step(cfg, tc, mesh=mesh, device=dev)
    losses = []
    with _card_transport(tf32):
        for s in range(TRAIN_CHECK_STEPS):
            b = steps.shard_batch(pipeline.make_batch(dc, s), cfg, tc, mesh)
            model, opt, m = step(model, opt, b, s)
            losses.append(float(m["loss"]))
    return model, losses


def _ept_int8_grads(mesh, rank: int, sd: int, dev, tf32: bool = False):
    """The loss gradients of one batch of scaled_down arctic cut to one
    layer (f32, the aux loss weighted) under the int8 dispatch on
    ``dev``, over the all_reduce transport: (loss, {name: this rank's
    grad on the CPU})."""
    cfg = dataclasses.replace(
        scaled_down(get_config(MOE_ARCHS[0]), dtype="float32"), num_layers=1)
    tc = TrainConfig(seed=sd)
    dc = pipeline.data_config_for(cfg, EPT_SMALL_S, EPT_SMALL_B, sd)
    model = _ept_small_model(cfg, rank, sd, dev)
    grad_fn = steps.make_grad_fn(cfg, tc, mesh=mesh, moe_a2a_int8=True,
                                 device=dev)
    with _card_transport(tf32):
        grads, met = grad_fn(model, steps.shard_batch(
            pipeline.make_batch(dc, 0), cfg, tc, mesh))
    return float(met["loss"]), {n: g.detach().cpu() for n, g in
                                grads.items()}


def _int8_against_cpu(card, cpu) -> dict:
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    share = max((float(((g_card[n] - g).abs()
                        > EPT_INT8_GRAD_CUT * g.abs().max()).float().mean()),
                 n) for n, g in g_cpu.items())
    return {"loss_abs_err": abs(l_card - l_cpu), "grad_share": share[0],
            "worst_leaf": share[1]}


def ep_train_rank(rank: int, cfg: dict) -> None:
    """One rank of the EP training check, in a process of its own: for each
    sequence length the one-device reference steps first (every rank runs
    them; its share is kept on the card), then each case's steps on this
    rank's experts and its slice of each global batch, held against the
    reference; then the scaled cases on the card and on the CPU. A JSON
    summary into ``cfg["dir"]``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{cfg['init']}", world_size=EP_RANKS,
        rank=rank, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = init_device_mesh(DEV, (1, EP_RANKS),
                                mesh_dim_names=("data", "model"))
        mcfg = _ept_cfg()
        tc = TrainConfig(total_steps=EPT_STEPS, warmup_steps=0,
                         seed=cfg["seed"])
        gen = lambda: torch.Generator(device=DEV).manual_seed(cfg["seed"])

        def run(step, model, batches, shard):
            opt = optimizer.init(dict(model.named_parameters()), tc)
            ms, mets = [], []
            for s, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, opt, m = step(model, opt, shard(b), s)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                mets.append({k: float(v) for k, v in m.items()})
            return model, ms, mets

        summary = {"reference": {}}
        for seq in sorted({seq for _, seq, _ in EPT_CASES}, reverse=True):
            dc = pipeline.data_config_for(mcfg, seq, EPT_B, cfg["seed"])
            batches = [pipeline.make_batch(dc, s) for s in range(EPT_STEPS)]
            ref, ref_ms, ref_mets = run(
                steps.make_train_step(mcfg, tc, device=DEV),
                lm.init_params(gen(), mcfg, device=DEV), batches,
                lambda b: b)
            scale = max(float(p.detach().abs().max())
                        for p in ref.parameters())
            want = carry.expert_shard(
                {n: p.detach() for n, p in ref.named_parameters()}, mcfg,
                rank, EP_RANKS)
            del ref
            torch.cuda.empty_cache()
            summary["reference"][str(seq)] = {
                "ms": ref_ms, "metrics": ref_mets, "max_abs_param": scale}
            for name, s_case, int8 in EPT_CASES:
                if s_case != seq:
                    continue
                model = carry.expert_shard(
                    lm.init_params(gen(), mcfg, device=DEV), mcfg, rank,
                    EP_RANKS)
                step = steps.make_train_step(mcfg, tc, mesh=mesh,
                                             moe_a2a_int8=int8, device=DEV)
                model, ms, mets = run(step, model, batches,
                                      lambda b: steps.shard_batch(
                                          b, mcfg, tc, mesh))
                finite = all(bool(torch.isfinite(p).all())
                             for p in model.parameters())
                worst = max(float((p.detach() - want[n]).abs().max())
                            for n, p in model.named_parameters()
                            if not int8 or n.startswith(EPT_INT8_HELD))
                summary[name] = {
                    "ms": ms, "metrics": mets, "param_max_abs_err": worst,
                    "finite": finite, "seq": seq,
                    "transport": moe.a2a_transport(
                        next(model.parameters()), mesh.get_group("model"))}
                del model, step
                torch.cuda.empty_cache()
            del want
            torch.cuda.empty_cache()
        small = {}
        for name, _, int8 in EPT_CASES:
            seq = EPT_SMALL_S_ODD if name == "allgather" else EPT_SMALL_S
            if int8:
                run_on, against = (lambda dev, tf32=False: _ept_int8_grads(
                    mesh, rank, sd, dev, tf32)), _int8_against_cpu
            else:
                run_on, against = (lambda dev, tf32=False: _ept_small_run(
                    mesh, rank, sd, seq, dev, tf32)), _against_cpu
            small[name] = {}
            for sd in range(cfg["seed"], cfg["seed"] + TRAIN_CHECK_SEEDS):
                cpu = run_on("cpu")
                small[name][f"seed {sd}"] = against(run_on(DEV), cpu)
                if sd == cfg["seed"]:
                    small[name]["control_tf32"] = against(
                        run_on(DEV, tf32=True), cpu)
        summary["card_vs_cpu"] = small
        (Path(cfg["dir"]) / f"rank{rank}.json").write_text(
            json.dumps(summary))
    finally:
        dist.destroy_process_group()


def _ept_card_vs_cpu(sums) -> list:
    """Print the scaled cases' card-vs-CPU readings (the largest over the
    ranks) and return the failed gates."""
    bad = []
    for name, _, int8 in EPT_CASES:
        limits = EPT_INT8_CPU_LIMITS if int8 else EPT_CPU_LIMITS
        runs = {k: {key: max(sm["card_vs_cpu"][name][k][key] for sm in sums)
                    for key in limits}
                for k in sums[0]["card_vs_cpu"][name]}
        print(f"  EP train {name}, scaled"
              + (" (one layer, one batch's gradients)" if int8 else "")
              + ", card vs CPU: " + "; ".join(
                  f"{k}: " + ", ".join(f"{key} {v:.2e}"
                                       for key, v in r.items())
                  for k, r in runs.items()) + f" (limits {limits})",
              flush=True)
        for key, lim in limits.items():
            if max(r[key] for k, r in runs.items()
                   if k != "control_tf32") > lim:
                bad.append(f"{name} card vs CPU {key}")
            if runs["control_tf32"][key] <= lim:
                bad.append(f"{name}: the TF32 control passes {key}")
        sums[0]["card_vs_cpu"][name] = runs
    return bad


def train_ep(seed: int) -> dict:
    """make_train_step over EP_RANKS gloo ranks on the one card in each
    case against the one-device step on the same global batches, and the
    scaled cases on the card against the CPU."""
    mcfg = _ept_cfg()
    caps = _ept_no_drops(mcfg)
    t0 = time.perf_counter()
    print(f"  arctic-480b's width (d_model {mcfg.d_model}, expert d_ff "
          f"{mcfg.moe.expert_d_ff}, dense residual "
          f"{mcfg.moe.dense_residual_d_ff}, vocab {mcfg.vocab_size}), 1 layer "
          f"(DEPTH CUT from 35), experts CUT from 128 to {EP_EXPERTS}, aux "
          f"weight CUT to 0, f32, {EPT_STEPS} steps of {EPT_B} x "
          f"{EPT_S} (a2a, a2a_int8) or {EPT_B} x {EPT_S_ODD} (allgather); "
          f"capacity factor {EPT_CF}: {caps} (no entry drops)", flush=True)
    with tempfile.TemporaryDirectory(prefix="ep_train_") as tmp:
        _run_ranks({"init": str(Path(tmp) / "init"), "dir": tmp,
                    "seed": seed, "world": EP_RANKS}, ep_train_rank)
        sums = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(EP_RANKS)]
    refs = sums[0]["reference"]
    out = {"ranks": EP_RANKS, "experts": EP_EXPERTS, "capacities": caps,
           "steps": EPT_STEPS,
           "reference_ms": {s: r["ms"] for s, r in refs.items()},
           "max_abs_param": {s: r["max_abs_param"] for s, r in refs.items()},
           "tol": {"param_rtol": EPT_PARAM_RTOL, "int8_max": EPT_INT8_MAX,
                   "int8_loss0_rtol": EPT_INT8_LOSS_RTOL,
                   "card_vs_cpu": EPT_CPU_LIMITS,
                   "int8_card_vs_cpu": EPT_INT8_CPU_LIMITS}}
    bad = []
    for name, seq, int8 in EPT_CASES:
        rs = [sm[name] for sm in sums]
        ref_mets = refs[str(seq)]["metrics"]
        worst = max(r["param_max_abs_err"] for r in rs)
        scale = refs[str(seq)]["max_abs_param"]
        mets = [r["metrics"] for r in rs]
        agree = all(m == mets[0] for m in mets)
        loss_errs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(mets[0], ref_mets)]
        if int8:
            # the first loss is taken before any update: under int8 it
            # differs by the dispatch's rounding alone
            ok = worst <= EPT_INT8_MAX and loss_errs[0] <= EPT_INT8_LOSS_RTOL
        else:
            ok = worst <= EPT_PARAM_RTOL * scale
        ok = ok and agree and all(r["finite"] for r in rs)
        out[name] = {"tokens": EPT_B * seq, "param_max_abs_err": worst,
                     "loss_rel_err_by_step": loss_errs, "metrics": mets[0],
                     "ms_per_rank": [r["ms"] for r in rs],
                     "transport": sorted({r["transport"] for r in rs})}
        print(f"  EP train {name} ({EPT_B} x {seq}): "
              + ("the router, dense residual, final norm and embeddings "
                 if int8 else "") + f"params within {worst:.3e} of the "
              f"one-device step (limit "
              + (f"{EPT_INT8_MAX}" if int8
                 else f"{EPT_PARAM_RTOL * scale:.2e}")
              + f"); loss rel err by step "
              f"{', '.join(f'{e:.2e}' for e in loss_errs)}"
              + (f" (the first's limit {EPT_INT8_LOSS_RTOL})" if int8 else "")
              + f"; metrics equal on every rank: {agree}; step ms per rank "
              f"{[[round(t, 1) for t in r['ms']] for r in rs]}; transport "
              f"{out[name]['transport']}", flush=True)
        if not ok:
            bad.append(name)
    bad += _ept_card_vs_cpu(sums)
    out["card_vs_cpu"] = sums[0]["card_vs_cpu"]
    out["wall_s"] = time.perf_counter() - t0
    ref_ms = {s: [round(t, 1) for t in v]
              for s, v in out["reference_ms"].items()}
    print(f"  one-device step ms by S {ref_ms}; {out['wall_s']:.1f} s",
          flush=True)
    if bad:
        raise AssertionError(f"EP training fails: {bad}: {out}")
    return out


def train_families_path(seed: int) -> dict:
    """Training the recurrent and MoE families on the card: zamba2-2.7b and
    rwkv6-1.6b at full width, each new family's card against the CPU,
    kimi-k2's layer at full width, and expert-parallel training over
    gloo ranks. None of K1-K4 may launch."""
    t0 = time.perf_counter()
    tsel.reset_launch_counts()
    tham.reset_launch_counts()
    fa.reset_launch_counts()
    out = {}
    for arch in TRAIN_REC_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"  full width: {arch}", flush=True)
        out[arch] = train_full_width(seed, arch, TRAIN_REC_MICRO,
                                     profile_one_micro=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = {
        arch: train_card_vs_cpu(seed, arch, lim)
        for arch, lim in TRAIN_FAMILY_LIMITS.items()}
    print(f"  one MoE layer at full width: {MOE_TRAIN_ARCH}", flush=True)
    out["moe_layer"] = train_moe_layer(seed)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  expert-parallel training over {EP_RANKS} gloo ranks",
          flush=True)
    out["ep"] = train_ep(seed)
    out["kernel_launches"] = {
        "K1": tsel.hamming_hist_kernel.launches,
        "K2": tsel.hamming_emit_kernel.launches,
        "K3": tham.hamming_distance_kernel.launches,
        "K4": fa.flash_attention_kernel.launches}
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"a kernel launched on a training path: "
                             f"{out['kernel_launches']}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"  train families phase: {out['wall_s']:.1f} s", flush=True)
    return out


def lt_shapes() -> dict:
    """gemma-2b's three steps at this script's shapes: {name: (shape,
    build_step's options)}."""
    mk = lambda name, s, b, kind: ShapeConfig(name, seq_len=s,
                                              global_batch=b, step=kind)
    return {
        "prefill": (mk("chip_prefill", PREFILL_LEN, PREFILL_BATCH,
                       StepKind.PREFILL), {"attn_impl": "flash"}),
        "decode": (mk("chip_decode", SERVE_LEN, SERVE_BATCH,
                      StepKind.DECODE), {}),
        "train": (mk("chip_train", TRAIN_SEQ, TRAIN_BATCH, StepKind.TRAIN),
                  {"microbatches": TRAIN_MICRO}),
    }


def launch_child(path: str) -> None:
    """The dry run in a process of its own: LT_CELLS on the production
    meshes (a fake world each), then gemma-2b's three steps on one fake
    card at this script's shapes; the records as JSON in ``path``."""
    out = {"cells": [], "steps": {}}
    for multi_pod in (False, True):
        shape, _ = launch_mesh.PRODUCTION[multi_pod]
        with launch_mesh.fake_world(int(np.prod(shape))):
            mesh = launch_mesh.make_production_mesh(multi_pod=multi_pod)
            for arch, name, mp, impl in LT_CELLS:
                if mp == multi_pod:
                    out["cells"].append(dryrun.run_cell(
                        arch, name, multi_pod=mp, attn_impl=impl, mesh=mesh))
    cfg = get_config(ARCH)
    for name, (shape, kw) in lt_shapes().items():
        t0 = time.perf_counter()
        dev = dryrun.trace_device(kw.get("attn_impl", "xla"))
        with dryrun.stand_ins(dev):
            fn, args, _, _ = dryrun.build_step(cfg, shape, None, device=dev,
                                               **kw)
            counts, mem = dryrun.trace_cell(fn, args)
        rec = roofline.build_report(cfg, shape, "1", 1,
                                    dryrun.stats_of(counts), mem).as_dict()
        rec.update(kernel_calls=dict(counts.kernel_calls),
                   io_by=dict(counts.io_by),
                   trace_s=time.perf_counter() - t0)
        out["steps"][name] = rec
    Path(path).write_text(json.dumps(out))


def _storage_bytes(args) -> int:
    seen = {}
    for t in dryrun.tensors_of(args):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _lt_args(name: str, cfg, shape, kw, model, seed: int):
    """(step fn, real arguments on the card) of one of lt_shapes."""
    g = torch.Generator(device=DEV).manual_seed(seed + 41)
    B, S = shape.global_batch, shape.seq_len
    tok = lambda *sz: torch.randint(0, cfg.vocab_size, sz, generator=g,
                                    device=DEV, dtype=torch.int32)
    if name == "prefill":
        fn = steps.make_prefill_step(cfg, S, attn_impl=kw["attn_impl"],
                                     device=DEV)
        return fn, (model, {"tokens": tok(B, S), "labels": tok(B, S)})
    if name == "decode":
        store = retrieval.synthetic_datastore(
            cfg, generator=torch.Generator(device=DEV).manual_seed(seed + 3),
            device=DEV)
        state = lm.init_decode_state(cfg, B, S, device=DEV)
        active = torch.ones((B,), dtype=torch.bool, device=DEV)
        return (steps.make_serve_step(cfg, S),
                (model, tok(B, 1), state, active, store))
    tc = TrainConfig(microbatches=kw["microbatches"])
    batch = pipeline.make_batch(pipeline.data_config_for(cfg, S, B, seed), 0)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    opt = optimizer.init(dict(model.named_parameters()), tc)
    return (steps.make_train_step(cfg, tc, device=DEV),
            (model, opt, batch, torch.zeros((), dtype=torch.int32,
                                            device=DEV)))


def _lt_step(name: str, pred: dict, fn, args) -> dict:
    """One step on the card against its dry run: the instrumented run's
    counts (and K4 launches), the un-instrumented runs' peak and median."""
    _reset_k_launches()
    counts = op_analysis.trace_step(fn, args)[1]
    torch.cuda.synchronize()
    launches = _k_launches()
    same = (counts.flops == pred["flops_per_device"]
            and counts.io_bytes == pred["hbm_bytes_per_device"]
            and dict(counts.kernel_calls) == pred["kernel_calls"])
    if not same:
        diff = {k: (v, pred["io_by"].get(k)) for k, v in counts.io_by.items()
                if v != pred["io_by"].get(k)}
        raise AssertionError(
            f"{name}: the card's op counts differ from the dry run's: "
            f"flops {counts.flops} vs {pred['flops_per_device']}, bytes "
            f"{counts.io_bytes} vs {pred['hbm_bytes_per_device']}, kernels "
            f"{dict(counts.kernel_calls)} vs {pred['kernel_calls']}; "
            f"classes (card, dry run) {diff}")
    if launches["K4"] != counts.kernel_calls.get("K4", 0):
        raise AssertionError(f"{name}: {launches['K4']} K4 launches, the "
                             f"analysis counted {counts.kernel_calls}")
    gc.collect()
    torch.cuda.synchronize()
    leftover = torch.cuda.memory_allocated() - _storage_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LT_TIMED):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            peak = torch.cuda.max_memory_allocated() - leftover
    ms = statistics.median(times) * 1e3
    bound_ms = pred["step_time_bound_s"] * 1e3
    out = {"ms": ms, "times_ms": [t * 1e3 for t in times],
           "bound_ms": bound_ms, "dominant": pred["dominant"],
           "measured_over_bound": ms / bound_ms,
           "useful_ratio": pred["useful_ratio"],
           "flops": counts.flops, "io_bytes": counts.io_bytes,
           "kernel_calls": dict(counts.kernel_calls),
           "k4_launches": launches["K4"],
           "predicted_bytes": pred["memory_stats"]["per_device_bytes"],
           "measured_peak_bytes": peak,
           "compute_ms": pred["compute_s"] * 1e3,
           "memory_ms": pred["memory_s"] * 1e3,
           "trace_s": pred["trace_s"]}
    print(f"  {name}: {ms:.1f} ms (median of {LT_TIMED}) against a "
          f"{out['dominant']} bound of {bound_ms:.2f} ms (compute "
          f"{out['compute_ms']:.2f}, memory {out['memory_ms']:.2f}): "
          f"measured/bound {out['measured_over_bound']:.2f}, useful_ratio "
          f"{out['useful_ratio']:.3f}; {counts.flops:.6e} FLOPs and "
          f"{counts.io_bytes:.6e} bytes on the card and in the dry run; "
          f"kernels {out['kernel_calls']} ({launches['K4']} K4 launches); "
          f"peak {peak / 1e9:.2f} GB measured, "
          f"{out['predicted_bytes'] / 1e9:.2f} GB predicted", flush=True)
    if bound_ms > ms:
        raise AssertionError(f"{name}: the bound {bound_ms:.3f} ms exceeds "
                             f"the measured {ms:.3f} ms")
    return out


def launch_tooling(seed: int) -> dict:
    """The dry run's cells and gemma-2b's three steps predicted in a child
    process (spawned: a fresh interpreter), then the steps on the card
    against their dry run (module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dryrun.json"
        child = torch.multiprocessing.get_context("spawn").Process(
            target=launch_child, args=(str(path),))
        child.start()
        child.join(timeout=LT_CHILD_TIMEOUT_S)
        if child.is_alive():
            child.kill()
            child.join(timeout=30)
            raise AssertionError(f"the dry run outlived "
                                 f"{LT_CHILD_TIMEOUT_S} s")
        if child.exitcode != 0:
            raise AssertionError(f"the dry run exited with "
                                 f"{child.exitcode}")
        pred = json.loads(path.read_text())
    out = {"cells": {}, "steps": {}}
    for rec in pred["cells"]:
        key = f"{rec['arch']} x {rec['shape']} on {rec['mesh']}"
        ms = rec["memory_stats"]
        out["cells"][key] = {
            "dominant": rec["dominant"],
            "bound_s": rec["step_time_bound_s"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"],
            "useful_ratio": rec["useful_ratio"],
            "per_device_bytes": ms["per_device_bytes"],
            "fits_hbm": ms["fits_hbm"], "rows_per_rank": rec["rows_per_rank"],
            "kernel_calls": rec["kernel_calls"],
            "attn_impl": rec["attn_impl"], "trace_s": rec["trace_s"]}
        print(f"  dry run {key} ({rec['attn_impl']}): {rec['dominant']}-bound"
              f" {rec['step_time_bound_s']:.4f} s, per device "
              f"{ms['per_device_bytes'] / 1e9:.2f} GB, fits_hbm "
              f"{ms['fits_hbm']}, useful_ratio {rec['useful_ratio']:.4f}, "
              f"kernels {rec['kernel_calls']}, traced in "
              f"{rec['trace_s']:.1f} s", flush=True)
    cfg = get_config(ARCH)
    model = lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                           cfg, device=DEV)
    for name, (shape, kw) in lt_shapes().items():
        fn, args = _lt_args(name, cfg, shape, kw, model, seed)
        out["steps"][name] = _lt_step(name, pred["steps"][name], fn, args)
        del fn, args
        gc.collect()
        torch.cuda.empty_cache()
    tr = out["steps"]["train"]
    err = abs(tr["predicted_bytes"] - tr["measured_peak_bytes"])
    tr["peak_rel_err"] = err / tr["measured_peak_bytes"]
    if tr["peak_rel_err"] > LT_MEM_RTOL:
        raise AssertionError(f"the predicted train peak is "
                             f"{tr['peak_rel_err']:.3f} off the measured one "
                             f"(limit {LT_MEM_RTOL})")
    if out["steps"]["prefill"]["kernel_calls"] != {"K4": cfg.num_layers}:
        raise AssertionError(f"a prefill made "
                             f"{out['steps']['prefill']['kernel_calls']} "
                             f"kernel calls, not {cfg.num_layers} K4")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"  launch tooling phase: {out['wall_s']:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this check needs "
                    "a CUDA card")

    # phase 1: the card
    card = nvidia_smi("name,power.limit")
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    print(f"card: {card}; {props.multi_processor_count} SMs, max SM clock "
          f"{max_clk_mhz:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sms, clk_hz = props.multi_processor_count, max_clk_mhz * 1e6

    # phase 2: build the kernels from the checkout's sources, one nvcc per
    # source, all started together
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    sources = [tsel._SOURCE, tham._SOURCE, fa._SOURCE]
    t0 = time.perf_counter()
    variant = start_variants(tsel._SOURCE, {POPC_ROUTE: POPC_VARIANT})
    try:
        logs = _build.build(sources)
    finally:
        popc_lib = finish_variants(variant)[POPC_ROUTE]
    print(f"build: {', '.join(sources)} and {tsel._SOURCE} without its "
          f"tensor-core dispatch in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # the main path's store: seeded clustered codes, made with numpy
    rng = np.random.default_rng(args.seed)
    W = D_BITS // 32
    centers = rng.integers(0, 1 << 32, size=(N_CLUSTERS, W), dtype=np.uint32)
    codes_np = clustered_codes(rng, N_ROWS, centers)
    q_np = clustered_codes(rng, N_QUERIES, centers)
    q = carry.codes(q_np, DEV)

    t0 = time.perf_counter()
    eng = carry.engine(codes_np, D_BITS, device=DEV).with_layout()
    torch.cuda.synchronize()
    print(f"store: N={N_ROWS} d={D_BITS} ({N_ROWS * W * 4 / 2**20:.0f} MiB "
          f"of codes), layout with {eng.layout.n_buckets} buckets built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # kNN-SIFT's store at the same scale (d=128, layout order), for K1/K2's
    # W = 4 tile; kNN-WordEmbed's (d=64), for the W = 2 one
    sift_q, sift_x = clustered_store(np.random.default_rng(args.seed + 2),
                                     SIFT_BITS, N_ROWS, N_QUERIES)
    we_q, we_x = clustered_store(np.random.default_rng(args.seed + 3),
                                 WORDEMBED_BITS, N_ROWS, N_QUERIES)

    # phase 3: each kernel against its plain version
    print("kernels vs plain (bit-for-bit):", flush=True)
    k1_err, k2_err = run_cases(q, eng.layout.codes, sift_q, sift_x, we_q,
                               we_x)
    if k1_err or k2_err:
        return fail(f"kernel != plain: K1 err {k1_err}, K2 err {k2_err}")
    k3_err = run_k3_cases(q, eng.codes[:K3_CHUNK])
    if k3_err:
        return fail(f"kernel != plain: K3 err {k3_err}")

    # phase 4: the main path, KNNEngine.with_layout().search
    sample = torch.from_numpy(
        np.random.default_rng(args.seed + 1).choice(N_QUERIES, N_CHECK,
                                                    replace=False)).to(DEV)
    print(f"main path: Q={N_QUERIES} N={N_ROWS} d={D_BITS} k={K}", flush=True)
    qplan = eng.query_plan(q, K)
    print(f"  plan: {qplan.compact()} ({qplan.reason})", flush=True)
    launches, main_ms, _ = drive("with_layout().search", eng, q, sample)
    kt = kernel_timings(q, eng.layout.codes, "layout order")
    if kt["k1_err"] or kt["k2_err"]:
        return fail(f"kernel != plain at the main path's shape: K1 err "
                    f"{kt['k1_err']}, K2 err {kt['k2_err']}")
    k1_err, k2_err = max(k1_err, kt["k1_err"]), max(k2_err, kt["k2_err"])
    st = kernel_timings(sift_q, sift_x, f"d={SIFT_BITS} layout order",
                        d=SIFT_BITS, k=SIFT_K)
    if st["k1_err"] or st["k2_err"]:
        return fail(f"kernel != plain at d={SIFT_BITS}'s main shape: K1 err "
                    f"{st['k1_err']}, K2 err {st['k2_err']}")
    k1_err, k2_err = max(k1_err, st["k1_err"]), max(k2_err, st["k2_err"])
    wt = kernel_timings(we_q, we_x, f"d={WORDEMBED_BITS} layout order",
                        d=WORDEMBED_BITS, k=WORDEMBED_K)
    if wt["k1_err"] or wt["k2_err"]:
        return fail(f"kernel != plain at d={WORDEMBED_BITS}'s main shape: "
                    f"K1 err {wt['k1_err']}, K2 err {wt['k2_err']}")
    k1_err, k2_err = max(k1_err, wt["k1_err"]), max(k2_err, wt["k2_err"])
    shares = [kt["cudacore_share"], st["cudacore_share"],
              wt["cudacore_share"]]
    if shares != [0.0, 0.0, 0.0]:
        return fail(f"tiles counted on the CUDA cores at d=256, 128, 64: "
                    f"{shares} %, expected 0, 0, 0")
    routes = route_comparison(q, eng.layout.codes, {
        W8_ROUTE: tsel._lib(), POPC_ROUTE: popc_lib})
    we_routes = route_comparison(we_q, we_x, {
        W8_ROUTE: tsel._lib(), POPC_ROUTE: popc_lib}, d=WORDEMBED_BITS,
        k=WORDEMBED_K)
    bt = binembed_path(args.seed + 4, {
        W8_ROUTE: tsel._lib(), POPC_ROUTE: popc_lib})
    k1_err, k2_err = max(k1_err, bt["k1_err"]), max(k2_err, bt["k2_err"])

    # phase 5: the same store on insertion order through select="fused"
    flat = eng._replace(layout=None)
    _, flat_ms, fused = drive("select='fused', insertion order", flat, q,
                              sample, select="fused")
    ft = kernel_timings(q, flat.codes, "insertion order", with_plain=False)

    b1, by1, route1 = bound_ms(kt["k1_pairs"], kt["W"], kt["k1_pairs"],
                               kt["k1_bytes"], sms, clk_hz)
    b2, by2, route2 = bound_ms(kt["k2_pairs"], kt["W"], 0, kt["k2_bytes"],
                               sms, clk_hz)
    print(f"bounds: K1 {b1:.4f} ms set by {route1}; K2 {b2:.4f} ms set by "
          f"{route2}", flush=True)

    # phase 5b: the board scan through K3, then K3's times at its main
    # shape (one chunk of the store)
    print(f"board scan: KNNEngine.search(method='pallas'), Q={N_QUERIES} "
          f"N={N_ROWS} d={D_BITS} k={K}", flush=True)
    bs = board_scan(flat, q, fused)
    k3 = k3_timings(q, flat.codes[:K3_CHUNK], sms, clk_hz)
    if k3["err"]:
        return fail(f"kernel != plain at K3's main shape: err {k3['err']}")

    # phase 5c: index-probed search
    print("index path: IVF, LSH, kd-tree, hamming-prefix probes", flush=True)
    ip = index_path(args.seed, eng, q, fused[1])

    # phase 5d: the sharded path over gloo ranks on this card, then the
    # shard-fault-tolerance layer, while card memory is free
    print(f"sharded path: engine.search_sharded over {SHARD_RANKS} gloo "
          f"ranks on one card, Q={N_QUERIES} N={N_ROWS} d={D_BITS} k={K}",
          flush=True)
    shp = sharded_path(codes_np, q, fused)
    print(f"shard faults: FaultTolerantSearch, {FTS_UNITS} units at factor "
          f"{FTS_FACTOR}, Q={N_QUERIES} N={N_ROWS}", flush=True)
    sf = shard_faults(codes_np, q, fused)

    # phase 6: K4 against its plain version, then its times at the main
    # shape
    print("K4 vs plain (f32 atol {0}; bf16 {1} ulps + {0}):".format(
        K4_ATOL_F32, K4_BF16_ULPS), flush=True)
    k4_err = run_k4_cases()
    k4 = k4_timings()
    k4_zamba2 = k4_timings(*K4_ZAMBA2[:3], PREFILL_LEN, K4_ZAMBA2[3])
    k4_dense = k4_timings(*K4_DENSE[:3], PREFILL_LEN, K4_DENSE[3])

    # phase 7: kNN-LM serving of gemma-2b, prefill through K4
    print(f"serving path: {ARCH}", flush=True)
    sp = serving_path(args.seed)

    # phase 7c: the recurrent families at full width, prefill of zamba2
    # through K4
    gc.collect()
    torch.cuda.empty_cache()
    print(f"recurrent path: {', '.join(REC_ARCHS)}", flush=True)
    rp = recurrent_path(args.seed)

    # phase 7d: the dense, frontend and MoE families at full width, one
    # model at a time
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dense path: {DENSE_ARCH}", flush=True)
    dp = dense_path(args.seed)
    print(f"frontend path: {', '.join(FRONTEND_ARCHS)}", flush=True)
    fp = frontend_path(args.seed)
    print(f"moe path: {', '.join(MOE_ARCHS)}, {MOE_LAYERS} layer each "
          f"(depth cut)", flush=True)
    mop = moe_path(args.seed)
    print(f"moe ep: moe_forward over {EP_RANKS} gloo ranks on one card, "
          f"{EP_EXPERTS} experts (cut) of {MOE_ARCHS[0]}'s width",
          flush=True)
    mep = moe_ep(args.seed)

    # phase 8: the approximate tier on the kNN cell
    print(f"approx path: approx_topk, Q={N_QUERIES} N={N_ROWS} d={D_BITS} "
          f"k={K}", flush=True)
    ap = approx_path(eng, q, fused)
    del fused

    # phases 9 and 10: the mutable store and the tenant arena
    print(f"mutable path: MutableStore over N={N_ROWS} d={D_BITS}",
          flush=True)
    mp = mutable_path(args.seed, codes_np, q)
    print(f"tenant path: {len(TENANT_SIZES)} tenants, Q={N_QUERIES} k={K}",
          flush=True)
    tp = tenant_path(codes_np, q_np)

    # phase 11: training, with the serving phases' memory given back
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"train path: {ARCH} through trainer.train, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens a step", flush=True)
    trp = train_path(args.seed)

    # phase 12: training the recurrent and MoE families
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train families: {', '.join(TRAIN_REC_ARCHS)} at full width, "
          f"card vs CPU for {', '.join(TRAIN_FAMILY_LIMITS)}, "
          f"{MOE_TRAIN_ARCH}'s layer, EP over {EP_RANKS} ranks", flush=True)
    tfp = train_families_path(args.seed)

    # phase 13: the launch tooling's dry run against the card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launch tooling: dry run of {len(LT_CELLS)} cells at full width, "
          f"then {ARCH}'s prefill, decode and train steps against the card",
          flush=True)
    ltp = launch_tooling(args.seed)
    print("main_path: " + json.dumps({
        "search_ms": main_ms, "queries_per_s": N_QUERIES / main_ms * 1e3,
        "blocks_skipped_frac": kt["skipped"],
        "insertion_order_search_ms": flat_ms,
        "insertion_order_blocks_skipped_frac": ft["skipped"],
        "insertion_order_k1_ms": ft["k1_ms"],
        "insertion_order_k2_ms": ft["k2_ms"], "runs": kt["runs"],
        "k2_one_run_ms": kt["k2_one_run_ms"], "w8_routes": routes,
        "d64_routes": we_routes, "d1024_search_ms": bt["search_ms"],
        "d1024_blocks_skipped_frac": bt["skipped"],
        "d1024_layout_s": bt["layout_s"], "d1024_routes": bt["turns"]}),
        flush=True)
    print("board_scan: " + json.dumps(bs), flush=True)
    print("index_path: " + json.dumps(ip), flush=True)
    print("sharded_path: " + json.dumps(shp), flush=True)
    print("shard_faults: " + json.dumps(sf), flush=True)
    print("serving_path: " + json.dumps(sp), flush=True)
    print("recurrent_path: " + json.dumps(rp), flush=True)
    print("dense_path: " + json.dumps(dp), flush=True)
    print("frontend_path: " + json.dumps(fp), flush=True)
    print("moe_path: " + json.dumps(mop), flush=True)
    print("moe_ep: " + json.dumps(mep), flush=True)
    print("approx_path: " + json.dumps(ap), flush=True)
    print("mutable_path: " + json.dumps(mp), flush=True)
    print("tenant_path: " + json.dumps(tp), flush=True)
    print("train_path: " + json.dumps(trp), flush=True)
    print("train_families: " + json.dumps(tfp), flush=True)
    print("launch_tooling: " + json.dumps(ltp), flush=True)
    src = "src/repro_torch/kernels/csrc/topk_select.cu"
    # K1/K2 as they were before this design: CUDA-core popcounts, K2 as one
    # run (measured in this run by route_comparison)
    popc = routes[POPC_ROUTE]
    print(json.dumps({"kernels": [
        {"name": "K1 hamming_hist_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/topk_select.py:91",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": kt["k1_ms"], "plain_ms": kt["k1_plain"], "bound_ms": b1,
         "ms_d128": st["k1_ms"], "plain_ms_d128": st["k1_plain"],
         "ms_d64": wt["k1_ms"], "plain_ms_d64": wt["k1_plain"],
         "ms_d1024": bt["k1_ms"], "plain_ms_d1024": bt["k1_plain"],
         "bound_by": by1, "bound_route": route1, "library_ms": None,
         "w8_route": W8_ROUTE,
         "earlier_design_ms": popc["k1_ms"]},
        {"name": "K2 hamming_emit_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/topk_select.py:192",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": kt["k2_ms"], "plain_ms": kt["k2_plain"], "bound_ms": b2,
         "ms_d128": st["k2_ms"], "plain_ms_d128": st["k2_plain"],
         "ms_d64": wt["k2_ms"], "plain_ms_d64": wt["k2_plain"],
         "ms_d1024": bt["k2_ms"], "plain_ms_d1024": bt["k2_plain"],
         "bound_by": by2, "bound_route": route2, "library_ms": None,
         "w8_route": W8_ROUTE,
         "earlier_design_ms": popc["k2_one_run_ms"]},
        {"name": "K3 hamming_distance_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming.py:22",
         "launches": bs["counting"]["k3_launches"],
         "max_abs_err": max(k3_err, k3["err"]), "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "bound_route": k3["bound_route"],
         "library_ms": k3["library_ms"]},
        {"name": "K4 flash_attention_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:30",
         "launches": sp["k4_launches_per_prefill"], "max_abs_err": k4_err,
         "ms": k4["ms"], "ms_f32": k4["ms_f32"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "bound_route": "bf16 tensor cores" if k4["bound_by"] ==
         "operations" else "HBM bytes", "library_ms": k4["library_ms"],
         "head_dims": list(fa._HEAD_DIMS),
         "bf16_tile": {hd: fa.bf16_tile(hd) for hd in fa._HEAD_DIMS},
         "recurrent_launches_per_prefill": {
             a: rp[a]["k4_launches_per_prefill"] for a in REC_ARCHS},
         "zamba2_prefill_hd80": dict(
             k4_zamba2, launches=rp["zamba2-2.7b"][
                 "k4_launches_per_prefill"]),
         "dense_prefill_hd128": dict(
             k4_dense, launches=dp["k4_launches_per_prefill"]),
         "new_family_launches_per_prefill": {
             DENSE_ARCH: dp["k4_launches_per_prefill"],
             **{a: fp[a]["k4_launches_per_prefill"] for a in FRONTEND_ARCHS},
             **{a: mop[a]["k4_launches_per_prefill"] for a in MOE_ARCHS}}},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
