"""cudacore_tile_share: the share of K1's and K2's tiles in the traced
window that the CUDA-core kernels scored, in percent: the program's
``k1.tiles_cudacore`` + ``k2.tiles_cudacore`` over ``k1.tiles`` +
``k2.tiles``. Each launch on the card adds its tiles to its pass's
``_cudacore`` counter when the launcher's own route gave it the CUDA-core
kernels, and 0 when the tensor-core ones: 100 where every launch took the
CUDA cores, 0.0 where none did. A program that counts no K1 tiles (one
without these counters) gives no reading."""
from knnbench import program_spans

K1_TILES = "k1.tiles"
K1_TILES_CUDACORE = "k1.tiles_cudacore"
K2_TILES_CUDACORE = "k2.tiles_cudacore"


def read(run):
    rec = program_spans.recorded(run)
    if rec is None:
        return None
    c = rec.counters
    if not c.get(K1_TILES):
        return None
    tiles = c[K1_TILES] + c.get(program_spans.K2_TILES, 0)
    cudacore = c.get(K1_TILES_CUDACORE, 0) + c.get(K2_TILES_CUDACORE, 0)
    return 100.0 * cudacore / tiles
