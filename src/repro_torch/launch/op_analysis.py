"""Operator-level FLOP / HBM-traffic analysis of one step (the counterpart
of ``repro.launch.jaxpr_analysis``, built on a ``TorchDispatchMode``).

``repro`` walks the jaxpr of its jitted step. The port runs the step once
under a dispatch mode that sees every ATen operator it issues — on fake
or meta tensors in the dry run (no memory, no kernel), on real ones on
the card — the backward pass and the optimizer included.
``torch.utils.checkpoint`` blocks are counted as they run, recomputation
and all, as ``repro``'s differentiated jaxpr holds them.
CompositeImplicitAutograd operators (``matmul``, ``linear``,
``softmax.int``, ...) are decomposed first, so inference mode (where they
reach the mode whole) and autograd (where they arrive decomposed) are
charged alike; ``torch.einsum`` is caught above autograd by a
``TorchFunctionMode`` (below).

The cost model is ``repro``'s, op class by op class:
  * ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (dot_general): FLOPs =
    2 * numel(out) * K; I/O = the two operands + the result at their
    dtypes (an ``addmm`` bias is the free elementwise add);
  * ``torch.einsum`` (and ``layers.einsum_product``, an einsum the model
    writes out as products and sums): its pairwise contractions taken
    left to right, each a dot_general (a pair with nothing to sum has
    K = 1, which PyTorch runs as a free multiply), and under autograd
    their transposes for the backward, the einsum's own backward
    operators uncharged (``einsum_pairs``);
  * gathers (``index``, ``gather``, ``index_select``, ``embedding``): 2 x
    the result; ``index_put``, the scatters, ``index_add`` and
    ``embedding_dense_backward`` (scatter-add): 2 x the update;
  * reductions (``sum``, ``mean``, ``amax``, ``max``/``min`` over a dim,
    ``argmax``, ``prod``, ``any``/``all``, ``cumsum``, ``sort``, ``topk``,
    ``cat``, ``constant_pad_nd``): operands + results;
  * elementwise operators (``torch.Tag.pointwise``), views, copies, casts
    and factories: free (they fuse on the reference's target). A view
    slice is free too: the reference's per-layer and per-chunk slices are
    ``scan`` operands, which it does not charge, and the slice's consumer
    reads it; ``stack`` is free, as a scan's stacked outputs are;
  * ``select`` of a weight (a module parameter of the step's arguments;
    the reference's ``dynamic_slice`` of a scanned expert stack): 2 x the
    slice;
  * ``split`` (the reference's ``split`` primitive): operands + results;
  * ``slice_backward`` / ``select_backward`` (the cotangent of a view into
    zeros, a ``dynamic_update_slice`` in the reference): 2 x the update;
  * the autograd engine's sum of two gradient contributions to one
    tensor (the reference's ``add_any``): operands + result
    (``OpCounter``);
  * K1-K4 (``repro_torch::k1_hist``, ``k2_emit``, ``k3_hamming``,
    ``k4_flash_attention``): their cost functions, ``repro``'s
    ``pallas_call`` branch;
  * ``c10d`` collectives: their payload (``launch/collectives.py`` tallies
    them by kind);
  * any other operator: operands + results.

Composites that PyTorch runs as one operator and ``repro`` as several
primitives are charged as ``repro``'s decomposition is:
  * ``_softmax`` / ``_log_softmax`` (reduce_max + reduce_sum): 2 x (the
    input + the reduced output); their backward (one reduce_sum): the
    incoming cotangent + the reduced output;
  * ``logsumexp`` (reduce_max + reduce_sum): 2 x (input + output).

The result is the rank's own program: per-rank ``{flops, io_bytes}``,
with no division by the chip count (``repro`` divides a global jaxpr's
totals by it). ``n_devices`` stays for ``repro``'s signature.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import flash_attention, hamming, topk_select
from repro_torch.launch import collectives
from repro_torch.models.layers import einsum_product

aten = torch.ops.aten

_MM = {aten.mm.default: 0, aten.bmm.default: 0, aten.addmm.default: 1,
       aten.baddbmm.default: 1}

_GATHER = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
           aten.embedding.default, aten.take.default}

# scatter-like operators -> the position of the update operand
_SCATTER = {
    aten.index_put.default: 2, aten.index_put_.default: 2,
    aten._index_put_impl_.default: 2,
    aten.scatter.src: 3, aten.scatter_.src: 3,
    aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
    aten.scatter_reduce.two: 3, aten.scatter_reduce_.two: 3,
    aten.index_add.default: 3, aten.index_add_.default: 3,
    aten.embedding_dense_backward.default: 0,
    aten.slice_backward.default: 0, aten.select_backward.default: 0,
}

# repro's ``split`` primitive (``jnp.split``), charged operands + results;
# in PyTorch a split returns views
_SPLIT = {aten.split.Tensor, aten.split_with_sizes.default}

# charged as any other operator; named for the breakdown
_REDUCE = {
    aten.sum.default, aten.sum.dim_IntList, aten.mean.default, aten.mean.dim,
    aten.amax.default, aten.amin.default, aten.max.dim, aten.min.dim,
    aten.max.default, aten.min.default, aten.argmax.default,
    aten.argmin.default, aten.prod.default, aten.prod.dim_int,
    aten.any.default, aten.any.dim, aten.all.default, aten.all.dim,
    aten.cumsum.default, aten.cumprod.default, aten.sort.default,
    aten.sort.stable, aten.topk.default, aten.cat.default,
    aten.constant_pad_nd.default,
}

# PyTorch composites charged as repro's decomposition (module docstring)
_SOFTMAX = {aten._softmax.default, aten._log_softmax.default,
            aten.logsumexp.default}
_SOFTMAX_BWD = {aten._softmax_backward_data.default,
                aten._log_softmax_backward_data.default}

_FREE = {
    aten.copy_.default, aten.clone.default, aten._to_copy.default,
    aten.stack.default, aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.zeros.default,
    aten.zeros_like.default, aten.new_zeros.default, aten.ones.default,
    aten.ones_like.default, aten.new_ones.default, aten.full.default,
    aten.full_like.default, aten.new_full.default, aten.arange.default,
    aten.arange.start, aten.arange.start_step, aten.scalar_tensor.default,
    aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default,
    aten.lift_fresh.default, aten.lift_fresh_copy.default,
    aten.detach.default, aten.detach_.default, aten._local_scalar_dense.default,
    aten.tril.default, aten.triu.default, aten.repeat.default,
    aten._unsafe_view.default, aten.alias.default,
    aten.resize_.default, aten.set_.source_Storage_storage_offset,
    aten.index_fill.int_Tensor, aten.index_fill.int_Scalar,
    aten.masked_fill.Scalar, aten.masked_fill.Tensor,
    aten.masked_fill_.Scalar, aten.masked_fill_.Tensor,
    torch.ops.prim.device.default,
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def kernel_costs() -> Dict[object, Callable]:
    """The hand-written kernels' operators and their cost functions."""
    ops = torch.ops.repro_torch
    return {ops.k1_hist.default: topk_select.hamming_hist_cost,
            ops.k2_emit.default: topk_select.hamming_emit_cost,
            ops.k3_hamming.default: hamming.hamming_distance_cost,
            ops.k4_flash_attention.default: flash_attention.flash_attention_cost}


KERNEL_NAMES = {"k1_hist": "K1", "k2_emit": "K2", "k3_hamming": "K3",
                "k4_flash_attention": "K4"}


def _composite(func) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


@dataclasses.dataclass
class StepCounts:
    """What one traced step issued: FLOPs, HBM bytes (also per cost
    class), the kernels' calls, and the collectives' tally."""

    flops: float = 0.0
    io_bytes: float = 0.0
    io_by: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernel_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    coll: collectives.Tally = dataclasses.field(
        default_factory=collectives.Tally)

    def charge(self, cls: str, flops: float, io: float) -> None:
        self.flops += flops
        self.io_bytes += io
        if io:
            self.io_by[cls] += io


def op_cost(func, args, kwargs, out):
    """(class, FLOPs, bytes) of one ATen operator call under ``repro``'s
    cost model (module docstring)."""
    if func in _MM:
        a, b = args[_MM[func]], args[_MM[func] + 1]
        flops = 2.0 * out.numel() * a.shape[-1]
        return "matmul", flops, _nbytes(a) + _nbytes(b) + _nbytes(out)
    if func in _SPLIT:
        return "split", 0.0, _nbytes(args[0]) + sum(map(_nbytes, out))
    if func in _FREE or func.is_view or torch.Tag.pointwise in func.tags:
        return "free", 0.0, 0
    if func in _GATHER:
        return "gather", 0.0, 2 * sum(_nbytes(t) for t in _tensors(out))
    if func in _SCATTER:
        return "scatter", 0.0, 2 * _nbytes(args[_SCATTER[func]])
    if func in _SOFTMAX:
        red = _nbytes(args[0]) // max(args[0].shape[args[1][0] if isinstance(
            args[1], (list, tuple)) else args[1]], 1)
        return "softmax", 0.0, 2 * (_nbytes(args[0]) + red)
    if func in _SOFTMAX_BWD:
        red = _nbytes(args[0]) // max(args[0].shape[args[2]], 1)
        return "softmax", 0.0, _nbytes(args[0]) + red
    coll = collectives.classify(func, args)
    if coll is not None:
        return "collective:" + coll[0], 0.0, coll[1]
    io = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
          + sum(_nbytes(t) for t in _tensors(out)))
    return ("reduce" if func in _REDUCE else "other:" + str(func)), 0.0, io


_ADD = {aten.add.Tensor, aten.add_.Tensor}
# keys of the marks left in autograd nodes' metadata (nodes are not
# weakly referenceable, and holding one keeps its saved tensors alive)
_TAG, _EINSUM = "op_analysis.tag", "op_analysis.einsum"
_TAGS = itertools.count()


def einsum_pairs(equation: str, operands) -> list:
    """The pairwise contractions of an einsum taken left to right, each
    as the reference's ``dot_general``: [(FLOPs, bytes, transposes)] with
    FLOPs 2 * numel(out) * K (K the product of the indices summed out
    there: 1 for an outer or elementwise product, which PyTorch runs as a
    free multiply), bytes the two operands + the pair's result, and
    ``transposes`` the [(FLOPs, bytes)] of the reference's backward
    products for the operands that take a gradient (the cotangent
    against the other operand: 2 * numel(operand) * the indices summed)."""
    lhs, out = equation.replace(" ", "").split("->")
    terms = lhs.split(",")
    size = {}
    for t, x in zip(terms, operands):
        size.update(zip(t, x.shape))
    item = max(x.element_size() for x in operands)
    prod = lambda idx: math.prod(size[c] for c in set(idx))
    cur, cur_item = terms[0], operands[0].element_size()
    cur_grad = operands[0].requires_grad
    pairs = []
    for i in range(1, len(terms)):
        nxt, nxt_item = terms[i], operands[i].element_size()
        later = set(out).union(*terms[i + 1:])
        res = "".join(dict.fromkeys(c for c in cur + nxt if c in later))
        k = prod(set(cur + nxt) - set(res))
        ct = prod(res) * item
        a, b = prod(cur) * cur_item, prod(nxt) * nxt_item
        back = []
        for idx, nb, other, need in ((cur, a, b, cur_grad),
                                     (nxt, b, a, operands[i].requires_grad)):
            if need:
                summed = prod(set(res + cur + nxt) - set(idx))
                back.append((2.0 * prod(idx) * summed, float(ct + other + nb)))
        pairs.append((2.0 * prod(res) * k, float(a + b + ct), back))
        cur, cur_item = res, item
        cur_grad = cur_grad or operands[i].requires_grad
    return pairs


class _ChargeBackward(torch.autograd.Function):
    """Identity whose backward charges an einsum's reference transposes;
    the einsum's own backward nodes are not charged (``OpCounter``)."""

    @staticmethod
    def forward(ctx, x, counts, charges):
        ctx.counts, ctx.charges = counts, charges
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for flops, io in ctx.charges:
            ctx.counts.charge("matmul", flops, io)
        return g, None, None


def _nodes_between(out: torch.Tensor, inputs) -> list:
    """The autograd nodes from ``out`` back to (not including) the nodes
    that made ``inputs``. A node's Python object lives only while it is
    referenced (another may take its id after), so the stop nodes and the
    nodes found are held while they are compared."""
    stop = [t.grad_fn for t in inputs if t.grad_fn is not None]
    found, stack = {}, [out.grad_fn]
    while stack:
        n = stack.pop()
        if n is None or id(n) in found or any(n is s for s in stop):
            continue
        found[id(n)] = n
        stack.extend(f for f, _ in n.next_functions)
    return list(found.values())


class OpCounter(TorchDispatchMode):
    """Counts every operator a step issues into a ``StepCounts``.

    In the backward pass it also finds the autograd engine's own
    additions — the sum of two gradient contributions to one tensor, the
    reference's ``add_any``, which it charges as an unknown primitive
    (operands + result) — by where their operands were made: an ``add``
    whose two operands were both made in this backward pass, not both by
    the node now running (a backward formula's own add), is the engine
    accumulating. Gradients summed over microbatches come from separate
    backward passes and stay free, as the reference's scan adds them with
    the free ``add``."""

    def __init__(self, weights=()):
        super().__init__()
        self.counts = StepCounts()
        self._weights = {_storage(w) for w in weights}
        self._kernels = kernel_costs()
        self._made = WeakIdKeyDictionary()     # tensor -> (pass, node tag)
        self._inside_einsum = 0

    def einsum(self, func, args, kwargs):
        """``torch.einsum`` or ``layers.einsum_product`` (seen by
        ``_EinsumCharge`` above autograd): its pairs charged as the
        reference's products, the operators it runs as not; under
        autograd its backward is charged as the reference's transposes,
        and the backward nodes it made are not."""
        eq, ops = args[0], args[1:]
        if func is einsum_product:
            ops = ops[1:]                      # after the computation
        elif len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = ops[0]
        pairs = einsum_pairs(eq, ops)
        for flops, io, _ in pairs:
            self.counts.charge("matmul", flops, io)
        self._inside_einsum += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._inside_einsum -= 1
        if not out.requires_grad:
            return out
        for n in _nodes_between(out, ops):
            n.metadata[_EINSUM] = True
        back = [t for _, _, ts in pairs for t in ts]
        return _ChargeBackward.apply(out, self.counts, back)

    def _accumulates(self, func, args, task, node) -> bool:
        if func not in _ADD or not all(isinstance(a, torch.Tensor)
                                       for a in args[:2]):
            return False
        made = [self._made.get(a) for a in args[:2]]
        return (all(m is not None and m[0] == task for m in made)
                and not all(m[1] == node for m in made))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        task = torch._C._current_graph_task_id()
        if task != -1:
            node = torch._C._current_autograd_node()
            meta = node.metadata if node is not None else {}
            tag = meta.setdefault(_TAG, next(_TAGS))
            out = self._dispatch(func, args, kwargs,
                                 self._accumulates(func, args, task, tag),
                                 meta.get(_EINSUM, False))
            for t in _tensors(out):
                self._made[t] = (task, tag)
            return out
        return self._dispatch(func, args, kwargs, False)

    def _dispatch(self, func, args, kwargs, accumulates: bool,
                  in_einsum: bool = False):
        if func is aten.select.int and _storage(args[0]) in self._weights:
            out = func(*args, **kwargs)
            self.counts.charge("weight slice", 0.0, 2 * _nbytes(out))
            return out
        if accumulates:
            out = func(*args, **kwargs)
            self.counts.charge("add_any", 0.0, sum(map(_nbytes, args[:2]))
                               + _nbytes(out))
            return out
        if in_einsum:
            return func(*args, **kwargs)
        if func in self._kernels:
            out = func(*args, **kwargs)
            flops, io = self._kernels[func](*args, **kwargs)
            self.counts.charge("kernel", flops, io)
            self.counts.kernel_calls[KERNEL_NAMES[func._opname]] += 1
            return out
        if self._inside_einsum:
            return func(*args, **kwargs)
        if (func not in _MM and func not in _FREE and func not in _SPLIT
                and _composite(func)):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        cls, flops, io = op_cost(func, args, kwargs, out)
        self.counts.charge(cls, flops, io)
        coll = collectives.classify(func, args)
        if coll is not None:
            self.counts.coll.add(*coll)
        return out


class _EinsumCharge(TorchFunctionMode):
    """Hands each ``torch.einsum`` call to the counter before autograd
    decomposes it (the dispatch mode would see only its parts)."""

    def __init__(self, counter: OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.einsum or func is einsum_product:
            return self.counter.einsum(func, args, kwargs or {})
        return func(*args, **(kwargs or {}))


def trace_step(step_fn, args, kwargs=None) -> tuple:
    """Run ``step_fn(*args)`` once under an ``OpCounter``; returns (its
    output, the ``StepCounts``). The parameters of every module among
    ``args`` are the weights (``OpCounter``)."""
    counter = OpCounter(p for a in args if isinstance(a, torch.nn.Module)
                        for p in a.parameters())
    with counter, _EinsumCharge(counter):
        out = step_fn(*args, **(kwargs or {}))
    return out, counter.counts


def analyze_step(step_fn, args, n_devices: int = 1) -> Dict[str, float]:
    """Run one step and return THIS RANK's {'flops', 'io_bytes'} (the
    rank's own program: ``n_devices`` is not divided out)."""
    _, c = trace_step(step_fn, args)
    return {"flops": c.flops, "io_bytes": c.io_bytes}
