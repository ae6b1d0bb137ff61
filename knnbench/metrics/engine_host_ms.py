"""engine_host_ms: host time a search spends in ``KNNEngine.search`` itself
(the queries moved to the card, the calls into the planner and the
executor): the self time of the program's ``repro_torch.search`` span, per
search recorded in the traced window."""
from knnbench import program_spans


def read(run):
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    return rec.self_ms(program_spans.SEARCH)
