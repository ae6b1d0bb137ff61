"""Placement of the model, its decode state and the retrieval datastore,
and row-range replication (port of ``repro.dist.sharding``).

``param_specs``, ``decode_state_specs`` and ``datastore_specs`` are the
counterparts of ``repro``'s spec trees: every leaf placed ``Replicate()``
(the DTensor placement ``repro``'s ``P()`` names), over the port's own
structures — the model's parameters keyed by their ``named_parameters()``
names, the decode state's ``{"pos", "cache": KVCache}`` and the store's
tree. The sharded search re-shards the codes explicitly
(``engine.shard_datastore`` hands each rank its contiguous slice of rows),
so the specs only describe where a whole structure lives, and they take
no mesh: on any mesh every placement is ``Replicate()``.

Row-range replication (``ReplicaMap``) lives here too, copied whole: the
pure placement arithmetic of the shard-fault-tolerance layer — which unit
holds which contiguous global row range, at replication factor R, and who
serves / re-replicates what when units die. dist/search.py executes the
placement; this class only decides it (host-side, dependency-free).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ModelConfig


def replicated_like(tree: Any) -> Any:
    """``tree`` with every tensor leaf (and None kept as None) replaced by
    ``Replicate()``; NamedTuples keep their type."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicated_like(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicated_like(v) for v in tree)
    if isinstance(tree, dict):
        return {k: replicated_like(v) for k, v in tree.items()}
    return Replicate()


def param_specs(cfg: ModelConfig) -> Any:
    """Placements for the model of ``cfg``, keyed like its
    ``named_parameters()`` (the structure from a meta-device build)."""
    from repro_torch.models import lm

    return replicated_like(dict(lm._build(cfg, "meta").named_parameters()))


def decode_state_specs(cfg: ModelConfig) -> Any:
    """Placements for ``lm.init_decode_state`` (batch/len-free
    structure)."""
    from repro_torch.models import lm

    return replicated_like(lm.init_decode_state(cfg, 1, 2, device="meta"))


def datastore_specs(store=None) -> Any:
    """Placements matching a ``retrieval.DataStore``.

    Without ``store``, assumes the common ``layout=None`` store; pass the
    concrete store to match a layout-carrying structure."""
    from repro_torch.core import quantize, retrieval as retrieval_mod

    if store is not None:
        return replicated_like(store)
    return retrieval_mod.DataStore(
        codes=Replicate(), values=Replicate(),
        itq=quantize.ITQParams(mean=Replicate(), proj=Replicate(),
                               rot=Replicate()),
        layout=None)


# ---------------------------------------------------------------------------
# row-range replication placement (shard fault tolerance)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaMap:
    """Who holds which contiguous global row range, at factor R.

    The global row space [0, sum(counts)) splits into ``len(counts)``
    contiguous ranges — range i is the PRIMARY of unit i. At replication
    factor R, range i is additionally held by the next R-1 units in ring
    order (``units[(i + j) % n]``), the classic chained placement: any
    single-unit loss leaves every range with R-1 surviving holders, and R
    consecutive losses are needed to lose data.

    Everything here is pure placement arithmetic over an ``alive`` set —
    no I/O, no arrays — so dist/search.py (execution) and the tests
    (properties) consume the same single source of truth:

    - ``owner(i, alive)``: the unit that SERVES range i — the first alive
      holder in ring order, primary-first, so a healthy fleet serves every
      range from its primary (replicas are pure standby capacity).
    - ``assignment(alive)``: range index -> serving unit, covered only.
    - ``uncovered(alive)``: ranges with NO alive holder — these rows drop
      out of coverage (the CoverageReport names the lost primaries).
    - ``rebuild_targets(alive)``: the background re-replication work list
      — (range, source, target) triples restoring factor R among the
      alive units, fewest-held-ranges targets first (balance).
    """

    counts: Tuple[int, ...]
    units: Tuple[str, ...]
    factor: int = 1

    def __post_init__(self):
        if len(self.counts) != len(self.units):
            raise ValueError(f"{len(self.counts)} ranges vs "
                             f"{len(self.units)} units")
        if not 1 <= self.factor <= max(len(self.units), 1):
            raise ValueError(f"replication factor {self.factor} needs "
                             f"1 <= R <= n_units ({len(self.units)})")
        if any(c < 0 for c in self.counts):
            raise ValueError(f"negative range size in {self.counts}")
        object.__setattr__(self, "counts", tuple(int(c) for c in self.counts))
        object.__setattr__(self, "units", tuple(str(u) for u in self.units))

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def total_rows(self) -> int:
        return sum(self.counts)

    def range_bounds(self, i: int) -> Tuple[int, int]:
        """Range i's [start, stop) in the global row space."""
        start = sum(self.counts[:i])
        return start, start + self.counts[i]

    def holders(self, i: int) -> Tuple[str, ...]:
        """Units holding a copy of range i, primary first (ring order)."""
        n = self.n_units
        return tuple(self.units[(i + j) % n] for j in range(self.factor))

    def held_by(self, unit: str) -> Tuple[int, ...]:
        """Range indices ``unit`` holds (primary or replica)."""
        return tuple(i for i in range(self.n_units)
                     if unit in self.holders(i))

    def _live(self, i: int, alive_set: set,
              held: Optional[Dict[str, set]]) -> List[str]:
        """Alive units actually holding a copy of range i, ring order.
        ``held`` (unit -> set of range indices it REALLY has) overrides
        the nominal placement — a revived-empty unit nominally holds its
        ring ranges but possesses none until re-replication refills it."""
        return [u for u in self.holders(i)
                if u in alive_set and (held is None or i in held.get(u, ()))]

    def owner(self, i: int, alive: Sequence[str],
              held: Optional[Dict[str, set]] = None) -> Optional[str]:
        """The unit serving range i given the alive set (primary-first
        failover), or None when every holder is gone."""
        live = self._live(i, set(alive), held)
        return live[0] if live else None

    def assignment(self, alive: Sequence[str],
                   held: Optional[Dict[str, set]] = None) -> Dict[int, str]:
        """range index -> serving unit, for every range still covered."""
        alive_set = set(alive)
        out: Dict[int, str] = {}
        for i in range(self.n_units):
            live = self._live(i, alive_set, held)
            if live:
                out[i] = live[0]
        return out

    def uncovered(self, alive: Sequence[str],
                  held: Optional[Dict[str, set]] = None) -> List[int]:
        """Ranges with no alive holder: their rows drop out of coverage."""
        alive_set = set(alive)
        return [i for i in range(self.n_units)
                if not self._live(i, alive_set, held)]

    def covered_rows(self, alive: Sequence[str],
                     held: Optional[Dict[str, set]] = None) -> int:
        gone = set(self.uncovered(alive, held))
        return sum(c for i, c in enumerate(self.counts) if i not in gone)

    def rebuild_targets(self, alive: Sequence[str],
                        held: Optional[Dict[str, set]] = None
                        ) -> List[Tuple[int, str, str]]:
        """The re-replication work list: for every range with fewer than
        ``factor`` ALIVE copies (and at least one — lost ranges cannot be
        rebuilt from thin air), (range, alive source, alive target) triples
        that restore the factor. Nominal holders refill first (a revived
        unit gets its own ranges back), then fewest-copies-first targets
        so a refill never hot-spots one donor."""
        alive_set = set(alive)
        holds: Dict[str, set] = {
            u: (set(held.get(u, ())) if held is not None
                else set(self.held_by(u)))
            for u in alive_set}
        work: List[Tuple[int, str, str]] = []
        for i in range(self.n_units):
            live = [u for u in self.holders(i)
                    if u in alive_set and i in holds[u]]
            if not live or len(live) >= self.factor:
                continue
            need = self.factor - len(live)
            src = live[0]
            nominal = set(self.holders(i))
            candidates = sorted(
                (u for u in alive_set if i not in holds[u]),
                key=lambda u: (0 if u in nominal else 1, len(holds[u]), u))
            for tgt in candidates[:need]:
                holds[tgt].add(i)
                work.append((i, src, tgt))
        return work
