"""The engine of a configuration whose ``layout`` is ``"hamming_prefix"``:
``KNNEngine(codes, d).with_layout()``, the pure-Hamming prefix buckets.

* ``build(codes, cfg)``: the engine, built once in set-up.
* ``search(eng, k)``: the timed call, ``KNNEngine.search`` with the
  planner's own select.
* ``control(eng, k)``: the control of the comparison, the program's
  approximate tier (``select="approx"``, bucketed partial-reduce top-k over
  ±1 int8 plane products) at ``RECALL_TARGET`` below 1, through the same
  planner, executor and layout as the timed call.
"""
from __future__ import annotations

RECALL_TARGET = 0.9


def build(codes, cfg: dict):
    from repro_torch.core.engine import KNNEngine

    return KNNEngine(codes, cfg["d"]).with_layout()


def search(eng, k: int):
    return lambda q: eng.search(q, k)


def control(eng, k: int, recall_target: float = RECALL_TARGET):
    from repro_torch.core import plan

    def approx(q):
        q = q.to(device=eng.device)
        p = plan.plan_local(
            plan.stats_of(eng.codes, q, eng.d, layout=eng.layout), k,
            select="approx", recall_target=recall_target)
        return plan.execute(p, q, codes=eng.codes, layout=eng.layout)
    return approx
