"""Carry ``repro``'s state across to the port.

``repro`` hands its state over as numpy arrays: packed codes (uint32),
optionally a ``BucketLayout``'s ``codes``/``perm``/``inv``/``starts``, an
``lm.init_params`` pytree, a decode state, an ``AdamState`` over the
params, ``ITQParams``, a ``DataStore`` and the arrays of a
``KMeansIndex`` or ``LSHIndex``. These
functions return the port's tensors, ``BucketLayout``, ``KNNEngine``,
model, decode state, optimizer state, ``ITQParams``,
``DataStore`` and indexes on the given device (CUDA unless
``device="cpu"`` is asked for; with no device given and no CUDA device
present they raise). Codes keep their bit pattern: uint32 words are
reinterpreted as int32, not converted; bfloat16 leaves (numpy's
``ml_dtypes.bfloat16``) keep theirs through a 16-bit view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import index, quantize, retrieval
from repro_torch.core.engine import KNNEngine, as_codes
from repro_torch.core.layout import BucketLayout
from repro_torch.models import lm
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.optim import optimizer


def codes(packed, device=None) -> torch.Tensor:
    """(…, W) uint32 or int32 packed codes -> int32 tensor, same bits."""
    return as_codes(packed, device_mod.resolve(device))


def _int32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(dev)


def layout(layout_codes, perm, inv, starts, device=None) -> BucketLayout:
    """A ``repro`` BucketLayout's arrays -> the port's BucketLayout."""
    dev = device_mod.resolve(device)
    return BucketLayout(codes=codes(layout_codes, dev), perm=_int32(perm, dev),
                        inv=_int32(inv, dev), starts=_int32(starts, dev))


def engine(packed, d: int, layout_arrays=None, device=None) -> KNNEngine:
    """``repro`` engine state -> the port's KNNEngine. ``layout_arrays``:
    optional (codes, perm, inv, starts) of a prebuilt BucketLayout."""
    dev = device_mod.resolve(device)
    lay = None if layout_arrays is None else layout(*layout_arrays, device=dev)
    return KNNEngine(codes=codes(packed, dev), d=d, layout=lay)


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array (float32, int32 or bfloat16) -> tensor, same bits."""
    dev = device_mod.resolve(device)
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def _flat_lm_tree(tree, n_layers: int) -> dict:
    """A tree of ``repro``'s ``lm.init_params`` structure -> {module name:
    array}. ``blocks`` leaves are stacked on a leading layer axis of
    ``n_layers``, or in the hybrid on (groups, per_group), read from the
    leaves, with the one ``shared_attn`` tree beside them."""
    flat = {"embed.table": tree["embed"]["table"],
            "final_norm.scale": tree["final_norm"]["scale"]}
    if "unembed" in tree:
        flat["unembed.table"] = tree["unembed"]["table"]
    if "frontend" in tree:
        flat["frontend.proj"] = tree["frontend"]["proj"]
    if "shared_attn" in tree:
        groups, per_group = np.shape(tree["blocks"]["ln"]["scale"])[:2]
        lead = [(g, i) for g in range(groups) for i in range(per_group)]
        for leaf, a in _leaves(tree["shared_attn"]):
            flat[f"shared_attn.{leaf}"] = a
    else:
        lead = [(i,) for i in range(n_layers)]
    for leaf, stacked in _leaves(tree["blocks"]):
        stacked = np.asarray(stacked)
        for idx in lead:
            flat[".".join(["blocks", *map(str, idx), leaf])] = stacked[idx]
    return flat


def _keyed_like(tree, model: lm.LM, dev) -> dict:
    """A ``repro`` tree of the params' structure -> tensors keyed like
    ``model.named_parameters()``."""
    flat = _flat_lm_tree(tree, len(model.blocks))
    names = {n for n, _ in model.named_parameters()}
    if set(flat) != names:
        raise ValueError(f"pytree leaves {sorted(set(flat) ^ names)} do not "
                         f"match the model")
    return {n: tensor(flat[n], dev) for n in sorted(names)}


def lm_params(tree, cfg: ModelConfig, device=None) -> lm.LM:
    """``repro``'s ``lm.init_params`` pytree as numpy (``blocks`` leaves
    stacked on a leading layer axis, or on (groups, per_group) in the
    hybrid) -> the port's model. RWKV6's f32 leaves (``mu``, ``decay_b``,
    ``bonus``, ``ln_scale``, ...) and the MoE router stay f32 in a bf16
    model, as there; the MoE leaves (``blocks.moe.*``, stacked (L, E, ...)
    for the experts, with ``shared`` and ``dense``) and a frontend's
    ``frontend.proj`` come across by the same names."""
    dev = device_mod.resolve(device)
    model = lm._build(cfg, dev)
    flat = _keyed_like(tree, model, dev)
    for name, p in model.named_parameters():
        t = flat[name]
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


def expert_shard(obj, cfg: ModelConfig, rank: int, n_shards: int):
    """One rank's share of ``obj`` for expert parallelism over
    ``n_shards`` ranks: experts [rank·E/n, (rank+1)·E/n) of ``w_gate``,
    ``w_up`` and ``w_out`` (copies), every other tensor as it is (every
    rank holds them whole, as ``repro``'s ``shard_map`` specs replicate
    them). ``obj`` is an ``MoE`` layer (a new layer is returned), a model
    (each MoE block's layer is replaced by its share, in place; the model
    is returned), a dict keyed like ``named_parameters()`` or an
    ``AdamState`` over such dicts (new ones, the expert entries sliced)."""
    from repro_torch.models import moe as moe_mod

    E = cfg.moe.num_experts
    if E % n_shards:
        raise ValueError(f"{E} experts do not split over {n_shards} ranks")
    e_loc = E // n_shards
    lo = rank * e_loc
    if isinstance(obj, optimizer.AdamState):
        return optimizer.map_moments(
            obj, lambda t: expert_shard(t, cfg, rank, n_shards))
    if isinstance(obj, dict):
        return {k: (v[lo:lo + e_loc].clone() if optimizer.is_expert(k)
                    else v) for k, v in obj.items()}
    if isinstance(obj, lm.LM):
        for blk in obj.blocks:
            blk.moe = expert_shard(blk.moe, cfg, rank, n_shards)
        return obj
    part = moe_mod.MoE(cfg, obj.w_gate.dtype, "meta", num_experts=e_loc)
    for name in ("w_gate", "w_up", "w_out"):
        setattr(part, name, torch.nn.Parameter(
            getattr(obj, name)[lo:lo + e_loc].clone(), requires_grad=False))
    part.router = obj.router
    for name in ("shared", "dense"):
        if hasattr(obj, name):
            setattr(part, name, getattr(obj, name))
    return part


_STATE_TYPES = {"KVCache": KVCache, "MambaState": MambaState,
                "RWKVState": RWKVState}


def decode_state(state, device=None) -> dict:
    """``repro``'s decode state as numpy (``{"pos", "cache"}`` with its
    ``KVCache``, ``MambaState`` or ``RWKVState`` NamedTuples, stacked as
    ``lm.init_decode_state`` stacks them) -> the port's, same structure."""
    dev = device_mod.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "_fields"):
            return _STATE_TYPES[type(x).__name__](*(conv(v) for v in x))
        return tensor(np.asarray(x), dev)

    return conv(state)


def adam_state(state, model: lm.LM, device=None) -> optimizer.AdamState:
    """``repro``'s ``optimizer.AdamState`` as numpy (each moment tree of
    the params' structure: stacked on the layer axis, on (groups,
    per_group) in the hybrid, the experts' (L, E, ...)) -> the port's,
    keyed like ``model.named_parameters()`` of the whole model (split it
    for expert parallelism with ``expert_shard``)."""
    dev = device_mod.resolve(device)
    keyed = lambda t: None if t is None else _keyed_like(t, model, dev)
    return optimizer.AdamState(
        mu=keyed(state.mu), nu=keyed(state.nu),
        count=tensor(np.asarray(state.count, np.int32), dev),
        ef=keyed(state.ef), mu_scale=keyed(state.mu_scale),
        nu_scale=keyed(state.nu_scale))


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def itq(params, device=None) -> quantize.ITQParams:
    """``repro`` ``ITQParams`` (mean, proj, rot) as numpy -> the port's."""
    dev = device_mod.resolve(device)
    return quantize.ITQParams(*(tensor(np.asarray(a, np.float32), dev)
                                for a in params))


def datastore(store, device=None) -> retrieval.DataStore:
    """``repro`` ``DataStore`` as numpy -> the port's, its layout and its
    frozen key positions (a mutable store's view) too when it has them."""
    dev = device_mod.resolve(device)
    lay = None
    if store.layout is not None:
        L = store.layout
        lay = layout(L.codes, L.perm, L.inv, L.starts, device=dev)
    kp = (None if store.key_positions is None
          else _int32(store.key_positions, dev))
    return retrieval.DataStore(
        codes=codes(store.codes, dev),
        values=_int32(store.values, dev),
        itq=itq(store.itq, dev), layout=lay, key_positions=kp)


def _index_parts(buckets, packed, layout_arrays, dev):
    lay = None if layout_arrays is None else layout(*layout_arrays,
                                                    device=dev)
    return _int32(buckets, dev), codes(packed, dev), lay


def kmeans_index(centroids, buckets, packed, layout_arrays, d: int,
                 device=None) -> index.KMeansIndex:
    """A ``repro`` ``KMeansIndex``'s arrays (centroids f32, buckets int32,
    codes, optional layout (codes, perm, inv, starts)) -> the port's."""
    dev = device_mod.resolve(device)
    b, c, lay = _index_parts(buckets, packed, layout_arrays, dev)
    return index.KMeansIndex(
        centroids=tensor(np.asarray(centroids, np.float32), dev), buckets=b,
        codes=c, d=d, layout=lay)


def lsh_index(bit_ids, buckets, packed, layout_arrays, d: int,
              device=None) -> index.LSHIndex:
    """A ``repro`` ``LSHIndex``'s arrays (bit_ids, buckets int32, codes,
    optional layout (codes, perm, inv, starts)) -> the port's."""
    dev = device_mod.resolve(device)
    b, c, lay = _index_parts(buckets, packed, layout_arrays, dev)
    return index.LSHIndex(bit_ids=_int32(bit_ids, dev), buckets=b, codes=c,
                          d=d, layout=lay)
