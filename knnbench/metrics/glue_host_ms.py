"""glue_host_ms: host time a search spends in the planner, the executor and
the select glue around the kernels (pad to the tile, radius, run bases,
finalize): the program's ``repro_torch.plan`` and ``repro_torch.execute``
spans, inclusive, less the K1, K2 and layout id-map spans inside them, per
search recorded in the traced window."""
from knnbench import program_spans as ps


def read(run):
    rec = ps.recorded(run)
    if rec is None:
        return None
    return (rec.inclusive_ms(ps.PLAN, ps.EXECUTE)
            - rec.inclusive_ms(ps.K1, ps.K2, ps.ORIGINAL_IDS))
