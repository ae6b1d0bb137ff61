"""Rank-side tasks of the port's sharded tests: every rank of a
``_torch_world.World`` runs one of these on its own slice and returns
numpy arrays. Only ``torch``, ``numpy`` and ``repro_torch`` are imported.
"""
from __future__ import annotations

import torch

from _torch_world import mesh
from repro_torch.core import engine, retrieval
from repro_torch.kernels import approx_select, ops
from repro_torch.kernels import topk_select as tsel


def _np(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


def _setup(shape, names, codes):
    m = mesh(shape, names)
    return m, engine.shard_datastore(codes, m, names, device="cpu")


def search(shape, names, codes, q, k, d, kw):
    """``engine.search_sharded`` over this rank's slice of ``codes``."""
    m, x = _setup(shape, names, codes)
    return _np(*engine.search_sharded(x, q, k, d, m, names, device="cpu",
                                      **kw))


def plan_of(shape, names, n, w, q, k, d, kw):
    """The compact form and reason of ``plan_sharded`` as every rank sees
    it (the mesh sets the shard count)."""
    from repro_torch.core import plan

    m = mesh(shape, names)
    stats = plan.stats_for(n, d, w, q, n_shards=ops.n_shards_of(m, names))
    p = plan.plan_sharded(stats, k, axes=names, **kw)
    return p.compact(), p.reason


def topk_sharded(shape, names, codes, q, k, bins, kw):
    """``ops.hamming_topk_sharded`` directly; ``block_masks`` (n_shards,
    ...) hands each rank its own mask, ``n_valid_all`` its own count."""
    m, x = _setup(shape, names, codes)
    flat = ops.flat_index(m, names)
    kw = dict(kw)
    if "block_masks" in kw:
        kw["block_mask"] = torch.from_numpy(kw.pop("block_masks")[flat])
    if "n_valid_all" in kw:
        kw["n_valid"] = int(kw.pop("n_valid_all")[flat])
    q_t = engine.as_codes(q, "cpu")
    return _np(*ops.hamming_topk_sharded(
        q_t, x, k, bins, names, mesh=m, n_shards=ops.n_shards_of(m, names),
        **kw))


def approx(shape, names, codes, q, k, bins, kw):
    """``approx_select.approx_topk_sharded`` directly."""
    m, x = _setup(shape, names, codes)
    flat = ops.flat_index(m, names)
    kw = dict(kw)
    if "n_valid_all" in kw:
        kw["n_valid"] = int(kw.pop("n_valid_all")[flat])
    return _np(*approx_select.approx_topk_sharded(
        engine.as_codes(q, "cpu"), x, k, bins, names, mesh=m,
        n_shards=ops.n_shards_of(m, names), **kw))


def tree_psum(shape, names, fanout):
    """``ops._tree_psum`` and ``ops._psum`` of a rank-dependent integer
    tensor, and the all-gather through ``all_reduce``."""
    m = mesh(shape, names)
    flat = ops.flat_index(m, names)
    n = ops.n_shards_of(m, names)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3) * (flat + 1) + flat
    return _np(ops._tree_psum(x, m, names, fanout), ops._psum(x, m, names),
               ops._all_gather(x, m, names, n, flat)) + (flat,)


def knn_logits(shape, names, store_np, hidden, rcfg, vocab):
    """``retrieval.knn_logits(mesh=...)`` with this rank's slice of the
    store's codes and the whole of its values."""
    m = mesh(shape, names)
    codes, values, mean, proj, rot = store_np
    from repro_torch.core import quantize

    store = retrieval.DataStore(
        codes=engine.shard_datastore(codes, m, names, device="cpu"),
        values=torch.from_numpy(values),
        itq=quantize.ITQParams(mean=torch.from_numpy(mean),
                               proj=torch.from_numpy(proj),
                               rot=torch.from_numpy(rot)))
    out = retrieval.knn_logits(store, torch.from_numpy(hidden), rcfg, vocab,
                               mesh=m, axes=names)
    p = retrieval.plan_for_store(store, rcfg, hidden.shape[0], mesh=m,
                                 axes=names)
    return out.numpy(), p.compact()


def no_fallback(shape, names, codes, q, k, d):
    """On CPU tensors the sharded select takes the plain K1/K2 and counts
    no launch; a failing kernel wrapper propagates instead of giving way to
    another path."""
    m, x = _setup(shape, names, codes)
    tsel.reset_launch_counts()
    engine.search_sharded(x, q, k, d, m, names, device="cpu")
    counts = (tsel.hamming_hist_kernel.launches,
              tsel.hamming_emit_kernel.launches)
    real = ops.hamming_emit_kernel

    def broken(*args, **kwargs):
        raise RuntimeError("K2 (topk_emit_launch) failed: CUDA error 700")

    ops.hamming_emit_kernel = broken
    try:
        engine.search_sharded(x, q, k, d, m, names, device="cpu")
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        ops.hamming_emit_kernel = real
    # every rank raised before the output reduction, so no rank is left
    # inside a collective
    return counts, raised


def serve(shape, names, cfg, model, store, prompts, max_new):
    """A ``Server`` over the whole store on this rank with ``mesh`` and
    ``shard_axes=names``: (the logged plan's compact form, its merge
    geometry, the INFO lines the server logged, each request's tokens)."""
    import logging

    from repro_torch.runtime import server

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger(server.__name__)
    handler, level = Keep(logging.INFO), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        srv = server.Server(cfg, model, max_batch=2, max_len=24, store=store,
                            device="cpu", mesh=mesh(shape, names),
                            shard_axes=names)
        for uid, prompt in enumerate(prompts):
            srv.submit(server.Request(uid=uid, prompt=prompt,
                                      max_new_tokens=max_new))
        srv.run(max_ticks=200)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    p = srv.retrieval_plan
    return (p.compact(), p.geometry()["merge"], lines,
            {r.uid: list(r.out_tokens) for r in srv.done})
