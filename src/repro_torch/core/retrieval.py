"""kNN-LM retrieval: the paper's similarity-search engine as a serving
feature of the model (port of the local half of ``repro.core.retrieval``).

The datastore maps binary-quantized hidden states -> next-token ids
(Khandelwal et al.-style). At decode time the current hidden state is ITQ-
encoded, searched against the datastore (exact Hamming kNN — the paper's
engine, ``plan.execute``), and the neighbor distribution is interpolated
with the LM softmax.

``nprobe > 0`` with the store's key positions runs the DEGRADED search the
serving ladder downshifts to: the ``nprobe`` nearest hamming-prefix buckets
through the masked fused kernels.

``select="approx"`` with a ``recall_target`` runs the approximate tier
(``kernels/approx_select.py``), the serving ladder's approx rungs.

With a ``torch.distributed`` device mesh and axes, the search is the
sharded plan: every rank of the mesh calls ``knn_logits`` with a store
whose ``codes`` are its own slice of the rows (``engine.shard_datastore``)
and whose ``values`` are whole, and gets the whole answer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig, RetrievalConfig
from repro_torch.core import binary, index as index_mod
from repro_torch.core import layout as layout_mod, plan as plan_mod, quantize

class DataStore(NamedTuple):
    codes: torch.Tensor     # (N, W) int32 packed ITQ codes of hidden states
    values: torch.Tensor    # (N,) int32 next-token ids
    itq: quantize.ITQParams
    # optional bucket-clustered reorder of codes (core/layout.py): the
    # fused select streams layout.codes and maps winners back to original
    # ids, so `values` never needs reordering
    layout: Optional[layout_mod.BucketLayout] = None
    # the hamming-prefix key bit positions a mutable store froze at build
    key_positions: Optional[torch.Tensor] = None


def _maybe_layout(codes: torch.Tensor, code_bits: int, rcfg_layout: str,
                  layout_buckets: int) -> Optional[layout_mod.BucketLayout]:
    if rcfg_layout == "none":
        return None
    if rcfg_layout != "hamming_prefix":
        raise ValueError(f"unknown layout {rcfg_layout!r}")
    return layout_mod.build_layout(codes, code_bits,
                                   n_buckets=layout_buckets or None)


def build_datastore(hidden: torch.Tensor, next_tokens: torch.Tensor,
                    code_bits: int, itq_iters: int = 20,
                    generator: Optional[torch.Generator] = None,
                    layout: str = "none", layout_buckets: int = 0
                    ) -> DataStore:
    """hidden: (N, d_model); next_tokens: (N,) -> a store on hidden's
    device. ``layout``/``layout_buckets`` follow RetrievalConfig's fields
    of the same name."""
    itq = quantize.itq_train(hidden, code_bits, iters=itq_iters,
                             generator=generator)
    codes = binary.pack_bits(quantize.itq_encode(hidden, itq))
    return DataStore(codes=codes, values=next_tokens.to(torch.int32),
                     itq=itq,
                     layout=_maybe_layout(codes, code_bits, layout,
                                          layout_buckets))


def synthetic_datastore(cfg: ModelConfig, n: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> DataStore:
    """Deterministic random datastore sized per the arch's RetrievalConfig,
    on ``device`` — CUDA unless ``device="cpu"``. ``generator`` defaults
    to one seeded 3 on that device."""
    r = cfg.retrieval
    n = n if n is not None else r.datastore_size
    dev = device_mod.resolve(device)
    g = generator if generator is not None else (
        torch.Generator(dev).manual_seed(3))
    W = binary.padded_words(r.code_bits)
    codes = torch.randint(0, 2**31 - 1, (n, W), generator=g, device=g.device,
                          dtype=torch.int32).to(dev)
    values = torch.randint(0, cfg.vocab_size, (n,), generator=g,
                           device=g.device, dtype=torch.int32).to(dev)
    itq = quantize.ITQParams(
        mean=torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        proj=torch.eye(cfg.d_model, r.code_bits, dtype=torch.float32,
                       device=dev),
        rot=torch.eye(r.code_bits, dtype=torch.float32, device=dev))
    return DataStore(codes=codes, values=values, itq=itq,
                     layout=_maybe_layout(codes, r.code_bits, r.layout,
                                          r.layout_buckets))


def plan_for_store(store: DataStore, rcfg: RetrievalConfig, q: int,
                   mesh=None, axes: Sequence[str] = (), method: str = "xor",
                   select: Optional[str] = None,
                   recall_target: Optional[float] = None,
                   n_rows: Optional[int] = None) -> plan_mod.QueryPlan:
    """The QueryPlan ``knn_logits`` executes against this store.

    Select precedence: explicit ``select`` argument > ``rcfg.plan`` (when
    not "auto") > ``rcfg.select``; ``rcfg.force_plan`` overrides apply
    last. ``rcfg.layout != "none"`` demands a layout (``layout_policy=
    "require"``): the planner streams the prebuilt store layout when one
    exists, else falls back to a per-call re-sort.
    Sharded (a mesh and axes; ``store.codes`` is this rank's slice, so N is
    its rows times the shard count, unless ``n_rows`` gives the global
    count: a store held whole, as the server's is), a prebuilt GLOBAL
    layout cannot
    follow the shard slicing, so the planner only opts into per-shard
    re-sorting when the config asks. Exact sharded serving
    (``rcfg.local_k >= rcfg.k``) rides the hist_merge distributed counting
    select; ``local_k < k`` keeps the statistical concat/sort reduction."""
    if select is None:
        select = rcfg.plan if rcfg.plan != "auto" else rcfg.select
    if recall_target is None:
        recall_target = rcfg.recall_target
    policy = "require" if rcfg.layout != "none" else "auto"
    n, w = store.codes.shape
    if mesh is not None and axes:
        from repro_torch.kernels import ops

        n_dev = ops.n_shards_of(mesh, axes)
        # a prebuilt GLOBAL layout cannot follow the shard slicing, so the
        # sharded stats deliberately omit it (layout_policy still carries
        # the config's demand, satisfied per shard via local_sort)
        stats = plan_mod.stats_for(n * n_dev if n_rows is None else n_rows,
                                   rcfg.code_bits, w, q,
                                   k=rcfg.k, n_shards=n_dev)
        return plan_mod.plan_sharded(
            stats, rcfg.k, axes=tuple(axes), k_local=rcfg.local_k,
            select=select, method=method, chunk=rcfg.chunk_size,
            layout_policy=policy, recall_target=recall_target,
            force=rcfg.force_plan)
    stats = plan_mod.stats_for(n, rcfg.code_bits, w, q, k=rcfg.k,
                               layout=store.layout)
    return plan_mod.plan_local(
        stats, rcfg.k, select=select, method=method, chunk=rcfg.chunk_size,
        layout_policy=policy, recall_target=recall_target,
        force=rcfg.force_plan)


def log_store_plan(store: DataStore, rcfg: RetrievalConfig, q: int,
                   logger, mesh=None, axes: Sequence[str] = (),
                   n_rows: Optional[int] = None) -> plan_mod.QueryPlan:
    """Resolve and log the store's QueryPlan (serving-side ``explain()``);
    the server calls this once per store at startup, with ``n_rows`` the
    rows of the whole store it holds. Sharded plans also log the merge
    strategy and its predicted cross-rank traffic (``tuning.shard_hints``
    via ``plan.geometry()``)."""
    p = plan_for_store(store, rcfg, q, mesh=mesh, axes=axes, n_rows=n_rows)
    if n_rows is None:
        n_rows = store.codes.shape[0] * max(p.n_shards, 1)
    logger.info("retrieval store: %d entries, active plan %s",
                n_rows, p.compact())
    if p.merge.kind == "sharded":
        m = p.geometry()["merge"]
        logger.info(
            "retrieval shard merge: %s over %d shards, predicted merge "
            "traffic %d B/batch (hist_merge %d B vs concat_sort %d B)",
            m["strategy"], m["n_shards"], m["merge_bytes"],
            m["hist_merge_bytes"], m["concat_sort_bytes"])
    logger.debug("retrieval plan detail:\n%s", p.explain_str())
    return p


def probe_key_positions(store: DataStore, rcfg: RetrievalConfig
                        ) -> Optional[torch.Tensor]:
    """The hamming-prefix key-bit positions of ``store.layout``.

    ``build_layout``'s pure-Hamming fallback keys buckets by the
    ``log2(n_buckets)`` most balanced bit positions — a deterministic
    function of the codes, so recomputing the selection reproduces the
    bucket ids the layout was clustered by. None when the store has no
    layout or a bucket count that is not a power of two (a layout not
    keyed by the hamming prefix): degraded probing is unavailable there."""
    lay = store.layout
    if lay is None:
        return None
    if store.key_positions is not None:
        return store.key_positions     # frozen at build
    bits = lay.n_buckets.bit_length() - 1
    if (1 << bits) != lay.n_buckets:
        return None
    _, positions = layout_mod.hamming_prefix_assign(store.codes,
                                                    rcfg.code_bits, bits)
    return positions


def degraded_plan_for_store(store: DataStore, rcfg: RetrievalConfig, q: int,
                            nprobe: int) -> plan_mod.QueryPlan:
    """The reduced-nprobe masked plan a degradation rung serves with:
    hamming-prefix key probing feeds the block-mask fused kernels."""
    stats = plan_mod.stats_for(store.codes.shape[0], rcfg.code_bits,
                               store.codes.shape[1], q, k=rcfg.k,
                               layout=store.layout)
    return plan_mod.plan_index(stats, rcfg.k, kind="hamming_prefix",
                               nprobe=nprobe)


def _bucket_probe(q_codes: torch.Tensor, positions: torch.Tensor,
                  n_buckets: int, nprobe: int, d: int) -> torch.Tensor:
    """(Q, W) packed queries -> (Q, nprobe) bucket ids, nearest first
    (``index.hamming_prefix_probe``)."""
    return index_mod.hamming_prefix_probe(q_codes, positions, n_buckets,
                                          nprobe, d)


def knn_logits(store: DataStore, hidden: torch.Tensor, rcfg: RetrievalConfig,
               vocab: int, mesh=None, axes: Sequence[str] = (),
               method: str = "xor", temperature: float = 8.0,
               select: Optional[str] = None,
               recall_target: Optional[float] = None, nprobe: int = 0,
               probe_positions=None) -> torch.Tensor:
    """hidden: (Q, d_model) -> neighbor log-distribution (Q, vocab) f32.

    A thin plan-builder: ``plan_for_store`` resolves the select path,
    layout use and sharded merge from the store's stats and the config,
    and ``plan.execute`` runs the search ("fused" runs K1 + K2 once over
    the whole store; sharded, once over each rank's slice).

    ``nprobe > 0`` with ``probe_positions`` (``probe_key_positions``) on a
    store with a layout switches to the DEGRADED masked search: only the
    ``nprobe`` nearest hamming-prefix buckets are scanned.
    ``recall_target`` overrides ``rcfg.recall_target`` for the approx tier
    (the ladder's approx rungs serve at a degraded target)."""
    q_codes = binary.pack_bits(quantize.itq_encode(hidden, store.itq))
    if nprobe > 0 and store.layout is not None and probe_positions is not None:
        p = degraded_plan_for_store(store, rcfg, hidden.shape[0], nprobe)
        probe = _bucket_probe(q_codes, probe_positions,
                              store.layout.n_buckets, nprobe, rcfg.code_bits)
        dists, ids = plan_mod.execute(p, q_codes, layout=store.layout,
                                      probe=probe)
    else:
        p = plan_for_store(store, rcfg, hidden.shape[0], mesh=mesh,
                           axes=axes, method=method, select=select,
                           recall_target=recall_target)
        if p.merge.kind == "sharded":
            dists, ids = plan_mod.execute(p, q_codes, codes=store.codes,
                                          mesh=mesh)
        else:
            dists, ids = plan_mod.execute(p, q_codes, codes=store.codes,
                                          layout=store.layout)
    n = store.values.shape[0]
    # fewer than k valid neighbors -> the engine pads with sentinels (full
    # scans: dist = d+1, id >= N; masked probes: id = -1): they get no
    # softmax weight and no vote; an all-invalid row degenerates to p = 0
    # and hits the log floor below
    valid = (ids >= 0) & (ids < n) & (dists <= rcfg.code_bits)   # (Q, k)
    neighbor_tokens = store.values[torch.clamp(ids, 0, n - 1).long()]
    w = torch.softmax(torch.where(valid, -dists.float() / temperature,
                                  -torch.inf), dim=-1)
    w = torch.where(valid, w, 0.0)
    Q = hidden.shape[0]
    rows = torch.arange(Q, device=hidden.device)[:, None].expand_as(ids)
    p = torch.zeros((Q, vocab), dtype=torch.float32, device=hidden.device)
    p.index_put_((rows, neighbor_tokens.long()), w, accumulate=True)
    return torch.log(torch.clamp(p, min=1e-9))


def interpolate(lm_logits: torch.Tensor, knn_log_probs: torch.Tensor,
                lam: float) -> torch.Tensor:
    """log((1-lam) softmax(lm) + lam exp(knn_log_probs))."""
    lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)
    # the constants in f32, as repro takes them from f32 scalars
    lam32 = torch.tensor(lam, dtype=torch.float32)
    return torch.logaddexp(lm_logp + float(torch.log1p(-lam32)),
                           knn_log_probs + float(torch.log(lam32)))
