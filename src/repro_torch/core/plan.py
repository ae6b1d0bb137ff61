"""QueryPlan IR: one planner and one executor behind every search path
(port of ``repro.core.plan``).

* **IR** — a :class:`QueryPlan` of four typed stages: :class:`ProbeStage`,
  :class:`CandidateStage` (full scan, and which physical layout it
  streams), :class:`SelectStage` (the top-k select path + its scan
  granularity) and :class:`MergeStage` (the sharded merge).
* **Planner** — ``plan_local`` / ``plan_sharded`` / ``plan_index`` inspect
  :class:`StoreStats` and emit a plan; ``resolve_select`` is THE place
  ``"auto"`` becomes a concrete path.
  Forced knobs route through the same functions as forced-plan overrides
  (``parse_force``). Paths and reason strings match ``repro``'s, so a plan
  made by either package for the same store reads the same.
* **Executor** — :func:`execute` runs a plan over concrete tensors: full
  scans (``_scan_select``: the ``fused``, ``fused_scan``, ``composite``,
  ``counting``, ``bisect`` and ``approx`` paths, the materializing ones
  over ``xor``, ``mxu`` or K3 distances), block-mask candidates
  (``layout.masked_topk``, or ``approx_select.masked_approx_topk`` on the
  approx tier), gather candidates (``gather_scan``) and sharded merges
  (``_execute_sharded``: every rank of a ``torch.distributed`` device mesh
  runs it over its own slice of the codes).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import device as device_mod, spans
from repro_torch.core import binary, layout as layout_mod, topk

DEFAULT_CHUNK = 1 << 16

SELECT_PATHS = ("composite", "counting", "bisect", "fused", "fused_scan",
                "approx")
_SELECT_ALIASES = {"auto": "auto", "composite": "composite",
                   "counting": "counting", "bisect": "bisect",
                   "fused": "fused", "fused_scan": "fused_scan",
                   "approx": "approx"}

class DistanceMethod:
    XOR = "xor"          # bit-packed popcount
    MXU = "mxu"          # +/-1 float matmul
    PALLAS = "pallas"    # materializing distance kernel (K3)


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeStage:
    """Index traversal: which buckets/leaves feed the candidate stage."""

    kind: str = "none"          # none | kmeans | lsh | kdtree
    nprobe: int = 0
    n_tables: int = 0


@dataclasses.dataclass(frozen=True)
class CandidateStage:
    """How the candidate set is restricted, and over which physical layout.

    ``layout``: "none" streams insertion order; "prebuilt" streams a
    BucketLayout's reordered codes (winners map back through the
    permutation); "local_sort" re-sorts per call by a static Hamming key."""

    kind: str = "full"          # full | block_mask | gather
    layout: str = "none"        # none | prebuilt | local_sort


@dataclasses.dataclass(frozen=True)
class SelectStage:
    """The top-k select path."""

    path: str = "composite"     # one of SELECT_PATHS
    method: str = DistanceMethod.XOR  # distance method, materializing paths
    chunk: int = DEFAULT_CHUNK  # scan granularity (ignored by "fused")
    recall_target: float = 1.0  # approx tier only


@dataclasses.dataclass(frozen=True)
class MergeStage:
    """The sharded merge stage.

    ``strategy`` (sharded plans): "hist_merge" is the distributed counting
    select — per-shard pass-1 histograms psum into ONE global race, each
    shard emits into disjoint slots of the global (Q, k) output (exact,
    O(Q·bins) cross-rank traffic, fused select only); "hist_tree" is the
    SAME distributed counting select with the psums reduced hierarchically
    (``ops._tree_psum``) — bit-identical results, tree-shaped traffic;
    "concat_sort" is the legacy hierarchical merge — every shard reports
    its local top-k', the gathered (n_shards·k') candidates are sorted and
    cut (k_local < k makes it the statistical reduction of
    core/hierarchy.py).
    """

    kind: str = "none"          # none | sharded
    k_local: int = 0            # per-shard k' (k_local == k is exact)
    axes: Tuple[str, ...] = ()
    reorder_local: bool = False  # per-shard local_sort before the scan
    strategy: str = ""          # sharded: hist_merge | hist_tree | concat_sort
    fanout: int = 0             # hist_tree group width (0 = flat psum)


# the histogram-racing merge family: flat and tree-reduced distributed
# counting select (they differ only in psum schedule)
HIST_STRATEGIES = ("hist_merge", "hist_tree")


@dataclasses.dataclass(frozen=True)
class StoreStats:
    """What the planner inspects — static facts about one search call."""

    n: int                      # datastore rows
    d: int                      # code bits
    w: int                      # packed words per code
    q: int                      # query batch size
    k: int = 0
    has_layout: bool = False
    mean_bucket_rows: int = 0
    n_buckets: int = 0
    index: str = "none"
    n_shards: int = 1
    backend: str = ""           # "" -> device.default_backend() at explain


def stats_for(n: int, d: int, w: int, q: int, *,
              layout: Optional[layout_mod.BucketLayout] = None,
              n_buckets: Optional[int] = None, **kw) -> StoreStats:
    """StoreStats from counts; THE place layout fields are derived."""
    if n_buckets is None:
        n_buckets = layout.n_buckets if layout is not None else 0
    return StoreStats(
        n=n, d=d, w=w, q=q, has_layout=layout is not None,
        mean_bucket_rows=layout.mean_bucket_rows if layout is not None else 0,
        n_buckets=n_buckets, **kw)


def stats_of(codes: torch.Tensor, q_packed: torch.Tensor, d: int,
             layout: Optional[layout_mod.BucketLayout] = None,
             **kw) -> StoreStats:
    """StoreStats from concrete tensors."""
    return stats_for(codes.shape[0], d, codes.shape[1], q_packed.shape[0],
                     layout=layout, **kw)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One search, fully decided: Probe -> Candidates -> Select -> Merge."""

    probe: ProbeStage
    candidates: CandidateStage
    select: SelectStage
    merge: MergeStage
    n: int
    d: int
    w: int
    q: int
    k: int
    n_shards: int = 1
    mean_bucket_rows: int = 0
    backend: str = ""
    reason: str = ""

    def compact(self) -> str:
        """One token, safe for benchmark ``derived`` fields (no , ; =)."""
        p = self.probe.kind
        if self.probe.nprobe:
            p += f"@{self.probe.nprobe}"
        c = self.candidates.kind
        if self.candidates.layout != "none":
            c += f"+{self.candidates.layout}"
        s = self.select.path
        if s == "approx":
            s += f"@r{self.select.recall_target:g}"
        m = self.merge.kind
        if self.merge.kind == "sharded":
            m = self.merge.strategy or "sharded"
            if m == "hist_tree":
                m += f"@f{self.merge.fanout}"
            elif m != "hist_merge":
                m += f"@k{self.merge.k_local}"
        return f"probe:{p}|cand:{c}|select:{s}|merge:{m}"

    def _kernels(self) -> Tuple[str, ...]:
        if self.candidates.kind == "gather":
            return ("xor+popcount gather", "topk.counting_topk")
        sharded = self.merge.kind == "sharded"
        hist_tree = self.merge.strategy == "hist_tree"
        path = self.select.path
        if path == "approx":
            ks = ("approx_select.bit_planes (+/-1 int8)",
                  "torch._int_mm int8->int32 Hamming-as-matmul",
                  "approx_select partial-reduce top-L + lexicographic "
                  "merge")
            if sharded and self.merge.strategy in HIST_STRATEGIES:
                ks += ((f"approx_select.approx_topk_sharded (pool-hist tree "
                        f"all_reduce + disjoint-slot output tree all_reduce, "
                        f"fanout={self.merge.fanout})") if hist_tree else
                       "approx_select.approx_topk_sharded (pool-hist "
                       "all_reduce + disjoint-slot output all_reduce)",)
            elif sharded:
                ks += ("all_gather k'-per-shard + sort_key_val cut",)
            return ks
        if path in ("fused", "fused_scan"):
            ks = ("kernels.topk_select.hamming_hist_kernel (K1, CUDA)",
                  "kernels.topk_select.hamming_emit_kernel (K2, CUDA)")
            if path == "fused_scan":
                ks += ("chunk loop + topk.merge_topk",)
        else:
            dist = {"xor": "binary.hamming_xor", "mxu": "binary.hamming_mxu",
                    "pallas": ("kernels.hamming.hamming_distance_kernel "
                               "(K3, CUDA)")}[self.select.method]
            sel = {"composite": "topk.composite_topk (torch.topk)",
                   "counting": "topk.counting_topk",
                   "bisect": "topk.counting_topk_bisect"}[path]
            ks = (dist, sel, "chunk loop + topk.merge_topk")
        if sharded and self.merge.strategy in HIST_STRATEGIES:
            ks += ((f"ops.hamming_topk_sharded (hist tree all_reduce + "
                    f"disjoint-slot output tree all_reduce, "
                    f"fanout={self.merge.fanout})") if hist_tree else
                   "ops.hamming_topk_sharded (hist all_reduce + "
                   "disjoint-slot output all_reduce)",)
        elif sharded:
            ks += ("all_gather k'-per-shard + sort_key_val cut",)
        return ks

    def _predicted_pruning(self) -> str:
        if self.select.path == "approx":
            if self.candidates.kind == "block_mask":
                return ("per-query block mask gates the score matmul; the "
                        "partial reduce keeps L candidates per enabled block")
            return ("partial reduce: only n_blocks*L candidates leave the "
                    "score matmul (the analytical recall bound sizes L)")
        if self.candidates.kind == "block_mask":
            return ("pass 1 skips every tile outside the probed buckets; "
                    "pass 2 composes the mask with the block-min bound")
        if self.candidates.kind == "gather":
            return "candidate lists bound the scan; no kernel-side pruning"
        if self.select.path not in ("fused", "fused_scan"):
            return "none (materializing path)"
        if self.candidates.layout != "none":
            return ("block-min pruning over bucket-clustered tiles "
                    "(bites even on uniform data)")
        return "block-min pruning only where the data layout has locality"

    def geometry(self) -> dict:
        """Block geometry + cost hints the kernels will run under, computed
        by the SAME rules the kernels are tiled by (``kernels/tuning.py``,
        ``topk_select.geometry``).
        Sharded plans additionally carry a ``merge`` sub-dict
        (``tuning.shard_hints``): shard geometry and the predicted
        cross-rank merge traffic of every strategy."""
        from repro_torch.kernels import tuning

        backend = self.backend or device_mod.default_backend()
        g = self._geometry_base(backend)
        if self.merge.kind == "sharded":
            g["merge"] = tuning.shard_hints(
                self.q, self.k, self.d + 1, max(self.n_shards, 1),
                k_local=self.merge.k_local,
                strategy=self.merge.strategy or "concat_sort",
                fanout=self.merge.fanout)
        return g

    def _geometry_base(self, backend: str) -> dict:
        from repro_torch.kernels import tuning

        if self.candidates.kind == "gather":
            return {"kind": "gather",
                    "cand_width_hint": self.probe.nprobe or 1}
        if self.select.path == "approx":
            from repro_torch.kernels import approx_select

            n_sh = (max(self.n_shards, 1) if self.merge.kind == "sharded"
                    else 1)
            n_eff = max(self.n // n_sh, 1)
            bn = tuning.approx_blocks(self.q, n_eff, self.w, backend=backend)
            bn = max(min(bn, n_eff), 1)
            n_blocks = -(-n_eff // bn)
            k_k = max(min(self.k, self.n), 1)
            rt = self.select.recall_target
            # the recall bound covers the GLOBAL pool on sharded plans
            l = max(min(approx_select.l_for_recall(
                k_k, n_blocks * n_sh, bn, rt), bn), 1)
            # one int8 product scores everything: 2*Q*N*d operations over
            # (Q+N)*d plane bytes
            flops = 2 * self.q * self.n * self.d
            plane_bytes = (self.q + self.n) * self.d
            return {
                "kind": "approx", "bn": bn, "n_blocks": n_blocks,
                "l_per_block": l, "cand_per_query": n_blocks * l,
                "recall_target": rt,
                "predicted_recall": round(approx_select.expected_recall(
                    k_k, n_blocks * n_sh, l), 6),
                "scores_flops": flops, "plane_bytes": plane_bytes,
                "flops_per_byte": round(flops / max(plane_bytes, 1), 2),
            }
        if self.select.path not in ("fused", "fused_scan"):
            # mirror the executor's resolution exactly (falsy -> default)
            eff = min(self.select.chunk or DEFAULT_CHUNK, self.n)
            if self.select.path == "composite":
                eff = _auto_chunk(eff, self.d)
            return dict(kind="scan", chunk=eff,
                        n_chunks=-(-self.n // max(eff, 1)),
                        **tuning.cost_hints(self.q, self.n, self.w,
                                            self.d + 1, path=self.select.path,
                                            chunk=eff, backend=backend))
        n_eff = self.n if self.merge.kind == "none" else (
            self.n // max(self.n_shards, 1))
        k_eff = (self.merge.k_local
                 if (self.merge.kind == "sharded"
                     and self.merge.strategy != "hist_merge") else self.k)
        hints = tuning.cost_hints(
            self.q, max(n_eff, 1), self.w,
            max(self.d + 1, min(k_eff, max(n_eff, 1))),
            path=self.select.path,
            chunk=((self.select.chunk or DEFAULT_CHUNK)
                   if self.select.path == "fused_scan" else 0),
            bucket_rows=(self.mean_bucket_rows
                         if self.candidates.kind == "block_mask" else 0),
            backend=backend)
        return dict(kind=self.select.path, **hints)

    def explain(self) -> dict:
        """JSON-able plan summary: stages, kernels, geometry, prediction."""
        return {
            "shape": {"n": self.n, "d": self.d, "w": self.w, "q": self.q,
                      "k": self.k},
            "stages": {
                "probe": dataclasses.asdict(self.probe),
                "candidates": dataclasses.asdict(self.candidates),
                "select": dataclasses.asdict(self.select),
                "merge": dataclasses.asdict(self.merge),
            },
            "kernels": list(self._kernels()),
            "geometry": self.geometry(),
            "predicted_pruning": self._predicted_pruning(),
            "reason": self.reason,
            "compact": self.compact(),
        }

    def explain_str(self) -> str:
        e = self.explain()
        geo = dict(e["geometry"])
        merge = geo.pop("merge", None)
        g = ", ".join(f"{k}={v}" for k, v in geo.items())
        lines = [
            f"QueryPlan[{self.compact()}]",
            f"  shape: N={self.n} d={self.d} W={self.w} Q={self.q} k={self.k}",
            f"  kernels: {'; '.join(e['kernels'])}",
            f"  geometry: {g}",
        ]
        if merge is not None:
            lines.append(
                f"  merge: {merge['strategy']} over {merge['n_shards']} "
                f"shards, predicted traffic {merge['merge_bytes']} B "
                f"(hist_merge {merge['hist_merge_bytes']} B vs concat_sort "
                f"{merge['concat_sort_bytes']} B)")
            if merge["strategy"] == "hist_tree":
                lines.append(
                    f"  merge levels: fanout={merge['fanout']} "
                    f"levels={merge['tree_levels']} — intra "
                    f"{merge['hist_tree_intra_bytes']} B, inter "
                    f"{merge['hist_tree_inter_bytes']} B")
        lines += [
            f"  pruning: {e['predicted_pruning']}",
            f"  reason: {self.reason}",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# legacy-knob deprecation (forced-plan overrides)
# ---------------------------------------------------------------------------

_WARNED: set = set()


def _warn_legacy(api: str, knob: str, value) -> None:
    """Once-per-process deprecation nudge for the forced-path knobs."""
    key = (api, knob, str(value))
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"{api}({knob}={value!r}) is a legacy forced-path knob; it now "
        f"routes through repro_torch.core.plan as a forced-plan override "
        f"(bit-identical). Prefer the plan API.", DeprecationWarning,
        stacklevel=3)


def parse_force(spec: str) -> dict:
    """Parse a forced-plan override string: comma-separated ``key=value``
    pairs, e.g. ``"select=fused_scan,chunk=4096,layout=off"``. Keys:
    select, method, chunk, layout (off|prebuilt|local_sort), k_local,
    reorder_local (0/1), candidates (full|block_mask|gather),
    merge (hist_merge|hist_tree|concat_sort — sharded plans only),
    fanout (hist_tree group width), recall_target (approx only)."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, eq, val = part.partition("=")
        if not eq:
            raise ValueError(f"force_plan entry {part!r} is not key=value")
        out[key.strip()] = val.strip()
    return out


_FORCE_KEYS = {"select", "method", "chunk", "layout", "candidates", "k_local",
               "reorder_local", "merge", "recall_target", "fanout"}


def _apply_force(plan: QueryPlan, force) -> QueryPlan:
    """Apply a forced-plan override (``repro``'s rules, reason strings
    included)."""
    if not force:
        return plan
    f = parse_force(force) if isinstance(force, str) else dict(force)
    sel, cand, merge = plan.select, plan.candidates, plan.merge
    reason = plan.reason
    if "select" in f:
        path = _SELECT_ALIASES.get(f["select"], f["select"])
        if path == "auto" or path not in SELECT_PATHS:
            raise ValueError(f"force_plan select={f['select']!r}")
        if cand.kind == "block_mask" and path not in ("fused", "approx"):
            # the masked candidate stage runs the fused kernels or the
            # approx partial reduce (both consume the per-tile mask); any
            # other select cannot — record the drop instead of lying
            reason += f"; forced select={path} ignored (block_mask runs fused)"
        else:
            sel = dataclasses.replace(sel, path=path)
            reason += f"; forced select={path}"
    if "method" in f:
        sel = dataclasses.replace(sel, method=f["method"])
    if "chunk" in f:
        sel = dataclasses.replace(sel, chunk=int(f["chunk"]))
    if "recall_target" in f:
        rt = float(f["recall_target"])
        if not 0.0 < rt <= 1.0:
            raise ValueError(f"force_plan recall_target={f['recall_target']!r}"
                             f" (must be in (0, 1])")
        if sel.path == "approx":
            sel = dataclasses.replace(sel, recall_target=rt)
            reason += f"; forced recall_target={rt:g}"
        else:
            reason += (f"; forced recall_target ignored "
                       f"(select={sel.path} is exact)")
    if "layout" in f:
        lay = {"off": "none", "on": "prebuilt"}.get(f["layout"], f["layout"])
        if lay not in ("none", "prebuilt", "local_sort"):
            raise ValueError(f"force_plan layout={f['layout']!r}")
        if cand.kind == "block_mask":
            # the masked stage streams the layout by construction; to drop
            # it force candidates=gather instead
            reason += "; forced layout ignored (block_mask streams it)"
        else:
            cand = dataclasses.replace(cand, layout=lay)
            reason = _scrub_layout_notes(reason) + f"; forced layout={lay}"
    if "candidates" in f:
        ck = f["candidates"]
        if ck not in ("full", "block_mask", "gather"):
            raise ValueError(f"force_plan candidates={ck!r}")
        if cand.kind == "block_mask" and ck == "gather":
            # the one honoured transition: index call sites build gather
            # operands whenever the plan says gather (= use_layout=False)
            cand = dataclasses.replace(cand, kind="gather", layout="none")
            sel = dataclasses.replace(sel, path="counting")
            reason += "; forced candidates=gather"
        elif ck != cand.kind:
            # any other rebinding needs operands the call site did not
            # build (a mask needs a layout, gather needs id lists) —
            # record the drop instead of crashing in the executor
            reason += (f"; forced candidates={ck} ignored "
                       f"(no operands for it on a {cand.kind} plan)")
    if "k_local" in f:
        if merge.kind == "sharded":
            merge = dataclasses.replace(merge, k_local=int(f["k_local"]))
            if merge.k_local < plan.k and merge.strategy in HIST_STRATEGIES:
                # the hist family is exact by construction; k' < k asked for
                # the statistical reduction, which only the concat merge runs
                demoted = merge.strategy
                merge = dataclasses.replace(merge, strategy="concat_sort",
                                            fanout=0)
                reason += (f"; {demoted} demoted to concat_sort "
                           "(k_local < k is the statistical reduction)")
        else:
            # inapplicable != unknown: record the drop instead of silently
            # letting the user believe the reduction applied
            reason += "; forced k_local ignored (local plan has no merge)"
    if "reorder_local" in f:
        if merge.kind == "sharded":
            rl = f["reorder_local"] not in ("0", "false", "off")
            merge = dataclasses.replace(merge, reorder_local=rl)
            cand = dataclasses.replace(cand,
                                       layout="local_sort" if rl else "none")
        else:
            reason += "; forced reorder_local ignored (local plan)"
    if "merge" in f:
        mv = f["merge"]
        if mv not in HIST_STRATEGIES + ("concat_sort",):
            raise ValueError(f"force_plan merge={mv!r}")
        if merge.kind != "sharded":
            reason += "; forced merge ignored (local plan has no merge)"
        elif mv in HIST_STRATEGIES and sel.path not in ("fused", "approx"):
            reason += (f"; forced merge={mv} ignored "
                       "(needs the fused or approx select)")
        elif mv in HIST_STRATEGIES and merge.k_local < plan.k:
            reason += (f"; forced merge={mv} ignored "
                       "(k_local < k is the statistical concat merge)")
        elif mv != merge.strategy:
            merge = dataclasses.replace(merge, strategy=mv)
            if mv != "hist_tree":
                merge = dataclasses.replace(merge, fanout=0)
            reason += f"; forced merge={mv}"
    if "fanout" in f:
        fv = int(f["fanout"])
        if merge.kind == "sharded" and merge.strategy == "hist_tree":
            if fv < 2:
                raise ValueError(f"force_plan fanout={fv} (hist_tree needs "
                                 f"fanout >= 2)")
            merge = dataclasses.replace(merge, fanout=fv)
            reason += f"; forced fanout={fv}"
        else:
            reason += ("; forced fanout ignored (only hist_tree merges "
                       "have one)")
    unknown = set(f) - _FORCE_KEYS
    if unknown:
        raise ValueError(f"unknown force_plan keys: {sorted(unknown)}")
    # re-enforce the planner's invariants the overrides may have broken:
    # the hist family races histograms — of per-shard rows (fused) or
    # per-shard candidate pools (approx); any other forced select demotes
    # the sharded merge back to the concat/sort fallback
    if (merge.strategy in HIST_STRATEGIES
            and sel.path not in ("fused", "approx")):
        demoted = merge.strategy
        merge = dataclasses.replace(merge, strategy="concat_sort", fanout=0)
        reason += (f"; {demoted} demoted to concat_sort "
                   f"(select={sel.path} cannot race histograms)")
    # a hist_tree merge always carries a concrete fanout (the executor and
    # shard_hints both consume it); default from the tuning heuristic
    if merge.strategy == "hist_tree" and merge.fanout < 2:
        from repro_torch.kernels import tuning as _tuning
        merge = dataclasses.replace(
            merge, fanout=_tuning.merge_fanout(max(plan.n_shards, 1)) or 2)
    # only the fused/approx selects consume a layout (materializing selects
    # must scan the original order, or tie ids drift from the legacy paths)
    if (cand.kind == "full" and sel.path not in ("fused", "approx")
            and cand.layout != "none"):
        cand = dataclasses.replace(cand, layout="none")
        if merge.reorder_local:
            merge = dataclasses.replace(merge, reorder_local=False)
        reason = (_scrub_layout_notes(reason)
                  + f"; layout dropped (select={sel.path} never consumes one)")
    return dataclasses.replace(plan, select=sel, candidates=cand,
                               merge=merge, reason=reason)


def _scrub_layout_notes(reason: str) -> str:
    """Remove the planner's layout notes from a reason string whose layout
    decision an override just replaced."""
    for note in ("; streams the prebuilt BucketLayout",
                 "; per-call local_sort (no prebuilt layout)",
                 "; per-shard local_sort before the scan"):
        reason = reason.replace(note, "")
    return reason


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def resolve_select(select: Optional[str], stats: StoreStats,
                   layout_policy: str = "auto") -> Tuple[str, str]:
    """THE select-resolution rule. ``"auto"`` becomes "fused" whenever a
    layout is available (prebuilt) or demanded by config
    (``layout_policy="require"``): only the fused kernels consume a layout.
    Without a layout, "auto" stays on the composite-key path. Any concrete
    name is a forced path, passed through untouched.
    Returns (path, reason)."""
    req = "auto" if select is None else select
    if req not in _SELECT_ALIASES:
        raise ValueError(
            f"unknown select {select!r}; known: auto|{'|'.join(SELECT_PATHS)}")
    req = _SELECT_ALIASES[req]
    if req != "auto":
        return req, f"forced select={req}"
    if stats.has_layout:
        return "fused", ("auto->fused: prebuilt layout present, block-min "
                         "pruning + permutation mapping apply")
    if layout_policy == "require":
        return "fused", ("auto->fused: config demands a layout; only the "
                         "fused select consumes one")
    return "composite", ("auto->composite: no layout; top_k over the "
                         "f32 composite key is the best materializing path")


def _resolve_layout(path: str, stats: StoreStats, layout_policy: str
                    ) -> Tuple[str, str]:
    """Which physical layout the full-scan candidate stage streams."""
    if path not in ("fused", "approx") or layout_policy == "off":
        return "none", ""
    if stats.has_layout:
        return "prebuilt", "streams the prebuilt BucketLayout"
    if layout_policy == "require":
        warnings.warn(
            "layout required but no prebuilt layout exists: re-sorting the "
            "datastore per call; prebuild it (KNNEngine.with_layout) to "
            "amortize", stacklevel=4)
        return "local_sort", "per-call local_sort (no prebuilt layout)"
    return "none", ""


def plan_local(stats: StoreStats, k: int, select: Optional[str] = "auto",
               method: str = DistanceMethod.XOR, chunk: int = DEFAULT_CHUNK,
               layout_policy: str = "auto", recall_target: float = 1.0,
               force=None) -> QueryPlan:
    """Plan a single-device full scan (the ``search_chunked`` /
    ``KNNEngine.search`` shape).

    ``layout_policy``: "auto" uses a prebuilt layout when present;
    "require" falls back to a per-call local_sort; "off" never streams a
    layout."""
    path, reason = resolve_select(select, stats, layout_policy)
    lay, lay_note = _resolve_layout(path, stats, layout_policy)
    if lay_note:
        reason += "; " + lay_note
    if path == "approx" and recall_target >= 1.0:
        reason += "; recall_target=1 keeps the full block (exact pool)"
    plan = QueryPlan(
        probe=ProbeStage(), candidates=CandidateStage(kind="full", layout=lay),
        select=SelectStage(path=path, method=method, chunk=chunk,
                           recall_target=recall_target),
        merge=MergeStage(), n=stats.n, d=stats.d, w=stats.w, q=stats.q, k=k,
        mean_bucket_rows=stats.mean_bucket_rows,
        backend=stats.backend, reason=reason)
    return _apply_force(plan, force)


def plan_sharded(stats: StoreStats, k: int, axes: Sequence[str],
                 k_local: Optional[int] = None, select: Optional[str] = "auto",
                 method: str = DistanceMethod.XOR, chunk: int = DEFAULT_CHUNK,
                 reorder_local: bool = False, layout_policy: str = "auto",
                 merge: Optional[str] = None, uneven: bool = False,
                 recall_target: float = 1.0, fanout: int = 0,
                 force=None) -> QueryPlan:
    """Plan a mesh-sharded search.

    Merge strategy: the default for an exact sharded search (k_local == k)
    is the **distributed counting select** (``hist_merge``): per-shard
    pass-1 histograms ``psum`` into one global per-query r*, each shard
    emits into disjoint slots of the global output — no per-shard top-k
    materialization, no concat/sort, O(Q·bins) cross-device counts instead
    of O(n_shards·Q·k) candidates. Because it races histograms it needs
    the fused select, so sharded ``"auto"`` now resolves to "fused";
    ``merge="concat_sort"`` forces the legacy hierarchical merge, and
    k_local < k (the statistical reduction of core/hierarchy.py, inexact
    by design) always takes it. Past 8 shards auto upgrades the flat psum
    to ``"hist_tree"`` — the SAME counting select with the histogram and
    output reductions tree-scheduled (``ops._tree_psum``, fanout from
    ``tuning.merge_fanout`` unless ``fanout`` pins it) — bit-identical
    results, per-hop traffic bounded by the fanout instead of the shard
    count; ``merge="hist_tree"`` forces it at any shard count. A prebuilt
    GLOBAL layout cannot follow the
    shard slicing, so the only layout option is the per-shard
    ``local_sort`` — taken when the caller asks (``reorder_local``) or
    config demands a layout, and only for the fused path (no other select
    consumes it); it composes with either merge strategy.

    ``uneven=True`` declares that the executor will receive per-shard
    ``shard_n_valid`` counts (shards padded to a common slice): only the
    two-pass kernels mask that padding exactly, so "auto" resolves to
    "fused" whatever the merge strategy."""
    k_local = k if k_local is None else k_local
    req = "auto" if select is None else select
    if (_SELECT_ALIASES.get(req) == "auto"
            and (uneven or (k_local >= k and merge != "concat_sort"))):
        # sharded auto lands on the fused kernels: the hist_merge "merge"
        # IS a histogram psum only they produce, and per-shard n_valid
        # padding is only masked exactly inside them
        path = "fused"
        reason = ("auto->fused: sharded store, the hist_merge distributed "
                  "counting select races per-shard histograms through one "
                  "psum") if (k_local >= k and merge != "concat_sort") else (
            "auto->fused: per-shard n_valid (uneven shards) is masked "
            "exactly only inside the two-pass kernels")
    else:
        path, reason = resolve_select(select, stats, layout_policy)
    want_rl = reorder_local or layout_policy == "require"
    rl = want_rl and path in ("fused", "approx")
    if want_rl and not rl:
        reason += "; reorder_local ignored (only the fused select consumes it)"
    elif rl:
        reason += "; per-shard local_sort before the scan"
    if k_local < k:
        reason += f"; statistical reduction k'={k_local} (inexact, bounded)"
    # the hist family races histograms of rows (fused) or candidate pools
    # (approx) — both produce the psum-able (Q, bins) counts; past 8
    # shards the flat psum upgrades to the tree schedule (same sums)
    n_sh = max(stats.n_shards, 1)
    if path in ("fused", "approx") and k_local >= k:
        strategy = "hist_tree" if n_sh > 8 else "hist_merge"
    else:
        strategy = "concat_sort"
    auto_strategy = strategy
    if merge is not None:
        if merge not in HIST_STRATEGIES + ("concat_sort",):
            raise ValueError(f"unknown merge strategy {merge!r}; "
                             f"known: hist_merge|hist_tree|concat_sort")
        if merge in HIST_STRATEGIES and strategy == "concat_sort":
            reason += (f"; merge={merge} ignored ("
                       + ("k_local < k is the statistical concat merge"
                          if k_local < k else "needs the fused or approx "
                          "select") + ")")
        elif merge != strategy:
            strategy = merge
            reason += f"; forced merge={merge}"
    if strategy == "hist_tree" and strategy == auto_strategy:
        reason += (f"; hist_tree over {n_sh} shards (per-hop traffic "
                   f"bounded by the fanout, not the shard count)")
    eff_fanout = 0
    if strategy == "hist_tree":
        from repro_torch.kernels import tuning as _tuning
        eff_fanout = fanout if fanout >= 2 else (_tuning.merge_fanout(n_sh)
                                                 or 2)
    elif fanout:
        reason += "; fanout ignored (only hist_tree merges have one)"
    plan = QueryPlan(
        probe=ProbeStage(),
        candidates=CandidateStage(kind="full",
                                  layout="local_sort" if rl else "none"),
        select=SelectStage(path=path, method=method, chunk=chunk,
                           recall_target=recall_target),
        merge=MergeStage(kind="sharded", k_local=k_local, axes=tuple(axes),
                         reorder_local=rl, strategy=strategy,
                         fanout=eff_fanout),
        n=stats.n, d=stats.d, w=stats.w, q=stats.q, k=k,
        n_shards=max(stats.n_shards, 1), backend=stats.backend, reason=reason)
    return _apply_force(plan, force)


def plan_index(stats: StoreStats, k: int, kind: str, nprobe: int = 0,
               n_tables: int = 0, use_layout: Optional[bool] = None,
               select: Optional[str] = None, recall_target: float = 1.0,
               force=None) -> QueryPlan:
    """Plan an index-probed search (kmeans/lsh/kdtree/hamming_prefix
    traversal feeds the candidate stage). Default: bucket-contiguous
    indexes drive the MASKED fused kernels (probed buckets -> per-tile
    enable mask, full buckets, so recall >= gather); indexes built with
    ``reorder=False`` — and the host-traversed kd-trees, whose leaves are
    not layout-contiguous — fall back to the gather scan."""
    if use_layout is None:
        use_layout = stats.has_layout and kind != "kdtree"
    if use_layout:
        if not stats.has_layout:
            raise ValueError("index built with reorder=False has no layout "
                             "to mask")
        cand = CandidateStage(kind="block_mask", layout="prebuilt")
        if select == "approx":
            sel = SelectStage(path="approx", chunk=0,
                              recall_target=recall_target)
            reason = ("masked approx tier over the bucket-contiguous "
                      "layout: probed buckets gate the score matmul at "
                      "per-query block granularity")
        else:
            sel = SelectStage(path="fused", chunk=0)
            reason = ("masked fused kernels over the bucket-contiguous "
                      "layout: probed buckets become the pass-1 enable mask")
    else:
        cand = CandidateStage(kind="gather", layout="none")
        sel = SelectStage(path="counting", chunk=0)
        reason = ("gather scan: candidate id lists -> xor+popcount + "
                  "counting select"
                  + ("" if stats.has_layout or kind == "kdtree"
                     else " (index has no layout)"))
    plan = QueryPlan(
        probe=ProbeStage(kind=kind, nprobe=nprobe, n_tables=n_tables),
        candidates=cand, select=sel, merge=MergeStage(),
        n=stats.n, d=stats.d, w=stats.w, q=stats.q, k=k,
        mean_bucket_rows=stats.mean_bucket_rows,
        backend=stats.backend, reason=reason)
    return _apply_force(plan, force)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _distances(q_packed: torch.Tensor, chunk_codes: torch.Tensor, d: int,
               method: str) -> torch.Tensor:
    if method == DistanceMethod.XOR:
        return binary.hamming_xor(q_packed, chunk_codes)
    if method == DistanceMethod.MXU:
        qb = binary.unpack_bits(q_packed, d)
        xb = binary.unpack_bits(chunk_codes, d)
        return binary.hamming_mxu(qb, xb, d)
    if method == DistanceMethod.PALLAS:
        from repro_torch.kernels import ops
        return ops.hamming_distance(q_packed, chunk_codes)
    raise ValueError(method)


def _auto_chunk(chunk: int, d: int) -> int:
    """Composite-key representability guard — the composite select only:
    the f32 key ``dist * chunk + idx`` is exact only while
    (d + 1) * chunk < 2^24."""
    if (d + 1) * chunk < (1 << 24):
        return chunk
    return max(1024, ((1 << 24) // (d + 1)) // 1024 * 1024)


def _scan_select(codes_packed: torch.Tensor, q_packed: torch.Tensor, k: int,
                 plan: QueryPlan, id_offset=0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-scan select stage.

    codes: (N, W) int32, q: (Q, W); returns (dists (Q, k) ascending,
    global ids (Q, k)). All select paths are bit-identical at any chunk."""
    sel = plan.select
    N, W = codes_packed.shape
    Q = q_packed.shape[0]
    d = plan.d
    dev = codes_packed.device

    if sel.path == "fused":
        from repro_torch.kernels import ops

        bd, bi = ops.hamming_topk(q_packed, codes_packed, k, d + 1)
        return bd, bi + id_offset
    if sel.path == "approx":
        from repro_torch.kernels import approx_select

        bd, bi = approx_select.approx_topk(
            q_packed, codes_packed, k, d + 1,
            recall_target=sel.recall_target)
        return bd, bi + id_offset

    chunk = min(sel.chunk or DEFAULT_CHUNK, N)
    if sel.path == "composite":
        chunk = _auto_chunk(chunk, d)
    n_chunks = (N + chunk - 1) // chunk
    if N % chunk:
        # pad with all-ones codes; ids beyond N rank last (materializing
        # paths) or are masked by n_valid (fused_scan)
        codes_packed = torch.cat([codes_packed, torch.full(
            (n_chunks * chunk - N, W), -1, dtype=codes_packed.dtype,
            device=dev)])
    chunks = codes_packed.reshape(n_chunks, chunk, W)

    best_d = torch.full((Q, k), d + 1, dtype=torch.int32, device=dev)
    best_i = torch.full((Q, k), N, dtype=torch.int32, device=dev)
    if sel.path == "fused_scan":
        from repro_torch.kernels import ops

        for ci in range(n_chunks):
            n_valid = min(max(N - ci * chunk, 0), chunk)
            cd, cidx = ops.hamming_topk(q_packed, chunks[ci], min(k, chunk),
                                        d + 1, n_valid=n_valid)
            best_d, best_i = topk.merge_topk(best_d, best_i, cd,
                                             cidx + ci * chunk, k)
        return best_d, best_i + id_offset

    select_fn = {"composite": topk.composite_topk,
                 "counting": topk.counting_topk,
                 "bisect": topk.counting_topk_bisect}[sel.path]
    for ci in range(n_chunks):
        dist = _distances(q_packed, chunks[ci], d, sel.method)
        # padding rows (global id >= N) must rank strictly last
        gids = ci * chunk + torch.arange(chunk, device=dev)
        dist = torch.where(gids[None, :] < N, torch.clamp(dist, max=d), d + 1)
        cd, cidx = select_fn(dist, min(k, chunk), d + 1)
        best_d, best_i = topk.merge_topk(best_d, best_i, cd,
                                         cidx + ci * chunk, k)
    return best_d, best_i + id_offset


def gather_scan(codes: torch.Tensor, q_packed: torch.Tensor,
                cand: torch.Tensor, k: int, d: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force scan of per-query candidate lists (the gather stage).

    codes: (N, W); cand: (Q, C) int32 with -1 padding -> (dists, ids), -1
    in sentinel slots. The (Q, C) distances are summed one word at a time,
    so the gathered (Q, C, W) codes never exist."""
    cand = cand.to(device=codes.device, dtype=torch.int32)
    safe = torch.clamp(cand, min=0).long()
    q = q_packed.to(torch.int32)
    dist = torch.zeros(cand.shape, dtype=torch.int32, device=codes.device)
    for w in range(codes.shape[1]):
        dist += binary.popcount32(q[:, w, None] ^ codes[:, w][safe])
    dist = torch.where(cand < 0, d + 1, dist)
    dd, ii = topk.counting_topk(dist, k, d + 1)
    ids = torch.gather(cand, 1, torch.clamp(ii, max=cand.shape[1] - 1).long())
    return dd, torch.where(dd > d, -1, ids)


def _execute_sharded(plan: QueryPlan, q_packed: torch.Tensor,
                     codes: torch.Tensor, mesh, shard_n_valid=None,
                     shard_participate=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded merge stage, run by every rank of ``mesh`` over its own
    slice ``codes`` (n_loc, W) of the store (``engine.shard_datastore``);
    the result is replicated.

    ``strategy in HIST_STRATEGIES``: the distributed counting select
    (``ops.hamming_topk_sharded``, or ``approx_select.approx_topk_sharded``
    on the approx tier) — per-shard pass-1 histograms psum into one global
    r*, each shard's pass 2 writes disjoint slots of the global (Q, k)
    output ("hist_tree" reduces through the ``fanout``-wide tree schedule,
    bit-identically). Exact; composes with the per-shard local_sort
    layout. Otherwise the legacy hierarchical merge: per-shard local top-k',
    an all-gather of (k' dists, ids) per shard, one sorted cut.

    ``shard_n_valid``: optional (n_shards,) per-shard valid-row counts for
    uneven shards padded to a common slice size (fused or approx select
    only; ids are reported in the UNPADDED global space — bit-identical to
    a single-device search over the concatenation of the valid rows).

    ``shard_participate``: optional (n_shards,) 0/1 mask — shard fault
    tolerance. A zero (dead) shard contributes no rows: its n_valid is
    zeroed inside the kernels and ids renumber over the survivors, so the
    result is bit-identical to a from-scratch search over a store holding
    only the surviving shards' valid rows (hist-family strategies only;
    composes with ``shard_n_valid``)."""
    from repro_torch.kernels import ops

    axes = plan.merge.axes
    k, k_local = plan.k, plan.merge.k_local
    n_dev = ops.n_shards_of(mesh, axes)
    n_loc = codes.shape[0]
    hist_fam = plan.merge.strategy in HIST_STRATEGIES
    tree_fanout = (plan.merge.fanout
                   if plan.merge.strategy == "hist_tree" else 0)
    nv_all = None
    if shard_n_valid is not None:
        nv_all = [int(v) for v in torch.as_tensor(shard_n_valid).reshape(
            -1).tolist()]
        if len(nv_all) != n_dev:
            raise ValueError(f"shard_n_valid has {len(nv_all)} counts for "
                             f"{n_dev} shards")
        if plan.select.path not in ("fused", "approx"):
            # only the two-pass kernels and the approx partial reduce mask
            # per-shard padding exactly (by row id); refuse up front
            # rather than silently running a select the plan did not promise
            raise ValueError(
                f"shard_n_valid (uneven shards) needs the fused or approx "
                f"select; this plan resolved select={plan.select.path!r} — "
                f"leave select='auto' (plan_sharded resolves it to 'fused' "
                f"when shard_n_valid is coming) or force select='fused'")
    part_all = None
    if shard_participate is not None:
        part_all = [int(v) for v in torch.as_tensor(
            shard_participate).reshape(-1).tolist()]
        if len(part_all) != n_dev:
            raise ValueError(f"shard_participate has {len(part_all)} flags "
                             f"for {n_dev} shards")
        if not hist_fam:
            # the concat merge all-gathers fixed per-shard candidate lists;
            # it has no slot renumbering to exclude a shard exactly
            raise ValueError(
                f"shard_participate (degraded search) needs a hist-family "
                f"merge; this plan resolved "
                f"merge={plan.merge.strategy!r} — leave merge unset or "
                f"force merge='hist_merge'/'hist_tree'")

    flat = ops.flat_index(mesh, axes)
    q = q_packed.to(device=codes.device, dtype=torch.int32)
    nv = ib = nt = None
    if nv_all is not None:
        nv = nv_all[flat]
        # the kernels renumber over the masked counts; hand them the
        # replicated (masked) scan instead of gathering it
        nv_eff = ([a * p for a, p in zip(nv_all, part_all)]
                  if part_all is not None else nv_all)
        ib, nt = sum(nv_eff[:flat]), sum(nv_eff)
    perm_l = None
    codes_l = codes
    if plan.candidates.layout == "local_sort":
        codes_l, perm_l = layout_mod.local_sort(codes, plan.d, n_valid=nv)
    approx = plan.select.path == "approx"
    if hist_fam:
        if approx:
            from repro_torch.kernels import approx_select

            return approx_select.approx_topk_sharded(
                q, codes_l, k, plan.d + 1, axes, mesh=mesh, n_shards=n_dev,
                recall_target=plan.select.recall_target, n_valid=nv,
                id_base=ib, n_total=nt, perm=perm_l, participate=part_all,
                tree_fanout=tree_fanout)
        return ops.hamming_topk_sharded(
            q, codes_l, k, plan.d + 1, axes, mesh=mesh, n_shards=n_dev,
            n_valid=nv, id_base=ib, n_total=nt, perm=perm_l,
            participate=part_all, tree_fanout=tree_fanout)
    if nv is not None:
        # uneven shards on the legacy merge: mask padding in-kernel,
        # report ids in the unpadded global space, sentinels at the
        # global total so the sorted cut ranks them last everywhere
        if approx:
            from repro_torch.kernels import approx_select

            ld, li = approx_select.approx_topk(
                q, codes_l, k_local, plan.d + 1,
                recall_target=plan.select.recall_target, n_valid=nv)
        else:
            ld, li = ops.hamming_topk(q, codes_l, k_local, plan.d + 1,
                                      n_valid=nv)
        if perm_l is not None:
            li = torch.where(li < nv, perm_l[torch.clamp(
                li, max=n_loc - 1).long()], li)
        li = torch.where(li < nv, li + ib, nt)
    elif perm_l is not None:
        ld, li = _scan_select(codes_l, q, k_local, plan)
        # local positions -> local ids -> global ids; local sentinels
        # (pos == n_loc) become this shard's global sentinel
        li = layout_mod.to_original_ids(perm_l, li) + flat * n_loc
    else:
        ld, li = _scan_select(codes_l, q, k_local, plan,
                              id_offset=flat * n_loc)
    # hierarchical merge: gather only k' candidates per shard
    Q = q.shape[0]
    g = ops._all_gather(torch.stack([ld.to(torch.int32),
                                     li.to(torch.int32)]), mesh, axes,
                        n_dev, flat)                    # (n_dev, 2, Q, k')
    gd = g[:, 0].permute(1, 0, 2).reshape(Q, n_dev * k_local)
    gi = g[:, 1].permute(1, 0, 2).reshape(Q, n_dev * k_local)
    sd, order = topk.sort_key_val(gd, gi)
    if n_dev * k_local < k:
        # fewer gathered candidates than requested: pad to the (Q, k)
        # contract with (d+1, sentinel); the id sentinel follows the
        # result's id space — the unpadded valid total on uneven shards,
        # the global row count else
        pad = k - n_dev * k_local
        sent = nt if nt is not None else n_loc * n_dev
        sd = torch.cat([sd, torch.full((Q, pad), plan.d + 1,
                                       dtype=torch.int32, device=q.device)],
                       dim=1)
        order = torch.cat([order, torch.full((Q, pad), sent,
                                             dtype=torch.int32,
                                             device=q.device)], dim=1)
    return sd[:, :k], order[:, :k]


def execute(plan: QueryPlan, q_packed: torch.Tensor, *,
            codes: Optional[torch.Tensor] = None,
            layout: Optional[layout_mod.BucketLayout] = None,
            probe: Optional[torch.Tensor] = None,
            cand_ids: Optional[torch.Tensor] = None,
            cand: Optional[torch.Tensor] = None,
            mesh=None, id_offset=0, shard_n_valid=None,
            shard_participate=None, return_stats: bool = False):
    """Run a plan over concrete tensors.

    Operands per stage: a sharded merge needs ``codes`` — this rank's slice
    — and ``mesh`` (+ optional ``shard_n_valid`` (n_shards,) valid-row
    counts for uneven shards padded to a common slice, and/or
    ``shard_participate`` (n_shards,) 0/1 liveness: dead shards' rows are
    excluded exactly, hist-family merges only), and every rank of the mesh
    runs it; block_mask candidates need ``layout`` (+ ``probe`` (Q, P)
    bucket ids and/or ``cand_ids`` (Q, C) original ids, -1 padded;
    core/layout.py semantics); gather needs ``codes`` + ``cand`` ((Q, C)
    int32, -1 padded); full scans need ``codes`` (plus ``layout`` when the
    plan streams a prebuilt one). ``return_stats`` (masked plans only)
    appends the pruning telemetry. Every route runs inside the span
    ``spans.EXECUTE``."""
    with spans.span(spans.EXECUTE):
        if plan.merge.kind == "sharded":
            if mesh is None or codes is None:
                raise ValueError("a sharded plan needs the mesh and this "
                                 "rank's codes")
            return _execute_sharded(plan, q_packed, codes, mesh,
                                    shard_n_valid=shard_n_valid,
                                    shard_participate=shard_participate)
        if plan.candidates.kind == "block_mask":
            if layout is None:
                raise ValueError("a block_mask plan needs the layout")
            if plan.select.path == "approx":
                from repro_torch.kernels import approx_select

                if return_stats:
                    raise ValueError("pruning stats only exist on the fused "
                                     "masked path")
                return approx_select.masked_approx_topk(
                    layout, q_packed, plan.k, plan.d, probe=probe,
                    cand_ids=cand_ids,
                    recall_target=plan.select.recall_target)
            return layout_mod.masked_topk(layout, q_packed, plan.k, plan.d,
                                          probe=probe, cand_ids=cand_ids,
                                          return_stats=return_stats)
        if return_stats:
            raise ValueError("pruning stats only exist on the masked path")
        if plan.candidates.kind == "gather":
            if codes is None or cand is None:
                raise ValueError("a gather plan needs the codes and cand")
            return gather_scan(codes, q_packed, cand, plan.k, plan.d)
        if plan.candidates.layout == "prebuilt":
            if layout is None:
                raise ValueError("the plan streams a prebuilt layout; "
                                 "pass it")
            dd, ii = _scan_select(layout.codes, q_packed, plan.k, plan)
            return dd, layout_mod.to_original_ids(layout.perm, ii)
        if codes is None:
            raise ValueError("a full-scan plan needs the codes")
        if plan.candidates.layout == "local_sort":
            codes_l, perm = layout_mod.local_sort(codes, plan.d)
            dd, ii = _scan_select(codes_l, q_packed, plan.k, plan)
            return dd, layout_mod.to_original_ids(perm, ii)
        return _scan_select(codes, q_packed, plan.k, plan,
                            id_offset=id_offset)
