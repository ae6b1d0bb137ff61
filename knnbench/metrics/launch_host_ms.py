"""launch_host_ms: host time a search spends in the K1 and K2 wrappers
(argument preparation, the operators' dispatch, the launches): the
program's ``repro_torch.k1`` and ``repro_torch.k2`` spans, inclusive, per
search recorded in the traced window."""
from knnbench import program_spans


def read(run):
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    return rec.inclusive_ms(program_spans.K1, program_spans.K2)
