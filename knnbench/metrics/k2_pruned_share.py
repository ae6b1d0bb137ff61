"""k2_pruned_share: the share of K2's tiles that its block-min guard
skipped in the traced window: the program's ``k2.tiles_pruned`` counter
(added on the card by K2 itself) over ``k2.tiles`` (the tiles of every K2
pass), in percent."""
from knnbench import program_spans


def read(run):
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    tiles = rec.counters.get(program_spans.K2_TILES)
    pruned = rec.counters.get(program_spans.K2_TILES_PRUNED)
    if not tiles or pruned is None:
        return None
    return 100.0 * pruned / tiles
