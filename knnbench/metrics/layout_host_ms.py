"""layout_host_ms: host time a search spends mapping layout positions back
to original ids: the program's ``repro_torch.layout.original_ids`` span,
inclusive, per search recorded in the traced window."""
from knnbench import program_spans


def read(run):
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    return rec.inclusive_ms(program_spans.ORIGINAL_IDS)
