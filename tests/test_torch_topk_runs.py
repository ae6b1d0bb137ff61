"""The two-pass select split over runs of N tiles (port only, plus parity).

K1 can return the histogram of each run of N tiles; ``ops._run_bases``
turns it into each (query, run)'s first below-r* and tie slot; K2 given
those bases emits each run on its own. On CPU tensors the wrappers run
their plain versions, so these tests hold the run split of the plain K1
and K2 against the single-run ones bit for bit on the cases that stress
slot numbering (heavy ties at r*, k > N, n_valid < N, disabled tiles,
nonzero slot and id bases, runs that end in a ragged tile), and the whole
select against ``repro``'s at several run counts."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import binary as jbin
from repro.kernels import ops as jops
from repro.kernels.topk_select import hamming_emit_pallas
from repro_torch import carry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_select as tsel

RUNS = [1, 2, 3, 7]

# name -> (seed, Q, N, d, k, extra): bq, bn, n_valid, mask_p, shard row
CASES = {
    "heavy ties d=8 k=3": (1, 4, 4096, 8, 3, {"bn": 256}),
    "heavy ties d=8 k=512": (1, 4, 4096, 8, 512, {"bn": 256}),
    "k > N": (2, 3, 37, 64, 50, {"bn": 8}),
    "n_valid < N": (3, 16, 1000, 64, 16, {"bn": 64, "n_valid": 611}),
    "block_mask with zeros": (4, 24, 1500, 96, 12,
                              {"bq": 8, "bn": 100, "mask_p": 0.5}),
    "slot_base/id_base (shard 2 of 2)": (5, 16, 2048, 64, 24,
                                         {"bn": 128, "shard": 1024}),
    "runs end in a ragged tile": (6, 8, 999, 32, 40, {"bn": 64}),
}


def _codes(rng, n, d):
    return carry.codes(rng.integers(0, 1 << 32, (n, -(-d // 32)),
                                    dtype=np.uint32), "cpu")


def _case(name):
    """Padded, tiled inputs of one case and the single-run K2 arguments
    that the run split must reproduce."""
    seed, Q, N, d, k, kw = CASES[name]
    rng = np.random.default_rng(seed)
    q, x = _codes(rng, Q, d), _codes(rng, N, d)
    if d < 32:
        q, x = q & ((1 << d) - 1), x & ((1 << d) - 1)
    bins = d + 1
    qp, xp, bq, bn = tops._topk_blocked(q, x, max(bins, min(k, N)),
                                        kw.get("bq"), kw.get("bn"))
    nv = kw.get("n_valid", N)
    tiles = (qp.shape[0] // bq, xp.shape[0] // bn)
    mask = None
    if "mask_p" in kw:
        mask = torch.from_numpy(
            (rng.random(tiles) < kw["mask_p"]).astype(np.int32))
        assert 0 < int(mask.sum()) < mask.numel()
    hist, bmin = tsel.hamming_hist_kernel(qp, xp, bins, nv, mask, bq=bq,
                                          bn=bn)
    _, r, n_lt, _ = tops._radius_from_cum(
        torch.cumsum(hist, dim=-1, dtype=torch.int32), min(k, nv))
    r = torch.where(torch.arange(qp.shape[0]) < Q, r, -1).to(torch.int32)
    sb, ib, lo = torch.zeros_like(r), 0, 0
    if "shard" in kw:                    # pass 2 over rows [lo, N) only
        lo = kw["shard"]
        h0, _ = tsel.hamming_hist_kernel(qp, xp[:lo], bins, lo, bq=bq, bn=bn)
        c0 = torch.cumsum(h0, dim=-1, dtype=torch.int32)
        rc = r.clamp(min=0).long()[:, None]
        sb = torch.where(r > 0, torch.gather(c0, 1, (rc - 1).clamp(min=0))
                         [:, 0], 0).to(torch.int32)
        n_lt = n_lt + torch.gather(h0, 1, rc)[:, 0]
        assert int(sb.max()) > 0
        ib, nv = lo, nv - lo
        bmin = bmin[:, lo // bn:].contiguous()
        mask = None if mask is None else mask[:, lo // bn:].contiguous()
    return dict(q=qp, x=xp[lo:], r=r, n_lt=n_lt, bins=bins, k=k, nv=nv,
                bmin=bmin, mask=mask, sb=sb, ib=ib, bq=bq, bn=bn)


def _emit(c, run_bases=None):
    return tsel.hamming_emit_kernel(
        c["q"], c["x"], c["r"], c["n_lt"], c["bins"], c["k"], c["nv"],
        block_min=c["bmin"], block_mask=c["mask"], slot_base=c["sb"],
        id_base=c["ib"], bq=c["bq"], bn=c["bn"], run_bases=run_bases)


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("name", list(CASES))
def test_run_histograms_sum_to_the_histogram(name, runs):
    c = _case(name)
    hist, bmin, run_hist = tsel.hamming_hist_kernel(
        c["q"], c["x"], c["bins"], c["nv"], c["mask"], bq=c["bq"],
        bn=c["bn"], runs=runs)
    ref_hist, ref_bmin = tsel.hamming_hist_kernel(
        c["q"], c["x"], c["bins"], c["nv"], c["mask"], bq=c["bq"],
        bn=c["bn"])
    assert run_hist.shape == (c["q"].shape[0], runs, c["bins"])
    assert run_hist.dtype == torch.int32
    assert torch.equal(run_hist.sum(dim=1, dtype=torch.int32), hist)
    assert torch.equal(hist, ref_hist) and torch.equal(bmin, ref_bmin)
    # each run counts only its own tiles' rows
    span = -(-(c["x"].shape[0] // c["bn"]) // runs)
    for j in range(runs):
        rows = slice(j * span * c["bn"], (j + 1) * span * c["bn"])
        if rows.start >= c["x"].shape[0]:
            assert int(run_hist[:, j].abs().sum()) == 0
            continue
        nv = max(0, min(c["nv"], rows.stop) - rows.start)
        h, _ = tsel.hamming_hist_kernel(c["q"], c["x"][rows], c["bins"], nv,
                                        None if c["mask"] is None else
                                        c["mask"][:, j * span:(j + 1) * span]
                                        .contiguous(), bq=c["bq"],
                                        bn=c["bn"])
        assert torch.equal(run_hist[:, j], h)


@pytest.mark.parametrize("runs", RUNS)
@pytest.mark.parametrize("name", list(CASES))
def test_run_split_emit_equals_single_run(name, runs):
    c = _case(name)
    _, _, run_hist = tsel.hamming_hist_kernel(
        c["q"], c["x"], c["bins"], c["nv"], c["mask"], bq=c["bq"],
        bn=c["bn"], runs=runs)
    bases = tops._run_bases(run_hist, c["r"], c["n_lt"], c["sb"])
    assert bases[0].shape == bases[1].shape == (c["q"].shape[0], runs)
    d1, i1 = _emit(c)
    dr, ir = _emit(c, bases)
    assert torch.equal(d1, dr) and torch.equal(i1, ir)
    assert int((i1 != 0).sum()) > 0
    assert tsel.hamming_emit_kernel.launches == 0      # plain path on CPU


def test_single_run_emit_matches_reference_on_the_shard_case():
    """The single-run emit that the run split is held to, against
    ``hamming_emit_pallas`` (interpret mode) on the shard case, its
    in-tile sub-step a whole tile."""
    c = _case("slot_base/id_base (shard 2 of 2)")
    j = lambda t: jnp.asarray(t.numpy())
    jd, ji = hamming_emit_pallas(
        j(c["q"]), j(c["x"]), j(c["r"]), j(c["n_lt"]), c["bins"], c["k"],
        n_valid=jnp.int32(c["nv"]), block_min=j(c["bmin"]),
        slot_base=j(c["sb"]), id_base=jnp.int32(c["ib"]), bq=c["bq"],
        bn=c["bn"], sub=c["bn"], interpret=True)
    td, ti = _emit(c)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_run_bases_are_exclusive_scans():
    rng = np.random.default_rng(9)
    run_hist = torch.from_numpy(rng.integers(0, 3, (5, 4, 9)).astype(np.int32))
    r = torch.tensor([0, 3, 8, -1, 5], dtype=torch.int32)
    n_lt = torch.tensor([0, 7, 2, 0, 11], dtype=torch.int32)
    sb = torch.tensor([1, 0, 4, 0, 2], dtype=torch.int32)
    lt_b, tie_b = tops._run_bases(run_hist, r, n_lt, sb)
    for qi in (0, 1, 2, 4):
        rq = int(r[qi])
        lt = run_hist[qi, :, :rq].sum(dim=1)
        tie = run_hist[qi, :, rq]
        assert lt_b[qi].tolist() == (int(sb[qi]) + torch.cumsum(lt, 0)
                                     - lt).tolist()
        assert tie_b[qi].tolist() == (int(n_lt[qi]) + torch.cumsum(tie, 0)
                                      - tie).tolist()
    assert lt_b.dtype == tie_b.dtype == torch.int32


def test_emit_refuses_run_bases_of_the_wrong_shape():
    c = _case("k > N")
    bad = torch.zeros((c["q"].shape[0] + 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="run_bases"):
        _emit(c, (bad, bad))


def test_default_runs_leave_no_run_empty():
    for nqb in (1, 3, 128, 5000):
        for nnb in (1, 2, 17, 1017, 4096):
            runs = tsel.default_runs(nqb, nnb)
            span = -(-nnb // runs)
            assert 1 <= runs <= nnb and (runs - 1) * span < nnb
    assert tsel.default_runs(128, 1017) == 16        # the main path's split


@pytest.mark.parametrize("target,runs", [(1, 1), (2, 2), (3, 3), (7, 6)])
def test_hamming_topk_over_runs_matches_reference(monkeypatch, target, runs):
    """The whole select with K2 split over runs (the run count set by the
    CTA target; 12 tiles in runs of 2 at a target of 7) against
    ``repro.kernels.ops.hamming_topk``."""
    monkeypatch.setattr(tsel, "_TARGET_CTAS", target)
    rng = np.random.default_rng(10 + target)
    d, n, nq, k = 64, 3000, 8, 20
    xj = jbin.pack_bits(jnp.asarray(rng.integers(0, 2, (n, d)), jnp.uint8))
    qj = jbin.pack_bits(jnp.asarray(rng.integers(0, 2, (nq, d)), jnp.uint8))
    bq, bn, sub, _, _ = jops.topk_geometry(nq, n, qj.shape[1], d + 1,
                                           None, 256)
    assert tsel.default_runs(1, -(-n // bn)) == runs
    jd, ji = jops.hamming_topk(qj, xj, k, d + 1, n_valid=2900, bq=bq, bn=bn,
                               sub=sub)
    td, ti = tops.hamming_topk(carry.codes(np.asarray(qj), "cpu"),
                               carry.codes(np.asarray(xj), "cpu"), k, d + 1,
                               n_valid=2900, bq=bq, bn=bn)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_launcher_argtypes_match_the_c_entry_points():
    """The ctypes argument table against the extern "C" signatures of
    csrc/topk_select.cu: a pointer for every ``*`` (and the stream), an int
    for every other parameter, in order. A mismatch would only show on the
    card."""
    import ctypes
    import re
    from repro_torch.kernels import _build

    src = (_build.CSRC / tsel._SOURCE).read_text()
    for name, argtypes in tsel.ARGTYPES.items():
        m = re.search(rf"\bint {name}\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert argtypes == want, name


# ---------------------------------------------------------------------------
# the d = 256 and d = 128 tensor-core distance tiles, emulated lane by lane
# ---------------------------------------------------------------------------

def _bits(w):
    """A 32-bit register as its 32 single-bit elements, bit i first."""
    return np.unpackbits(np.array([w], "<u4").view(np.uint8),
                         bitorder="little").astype(np.int64)


def _load_a(q_rows, bq, mb, w):
    """TcTile<MB, W>::load: each lane (g, t)'s a[m][0..3] for query rows
    16m+g (h = 0) and 16m+g+8 (h = 1), zero words past bq. W = 8: a[m][h]
    = word 2t, a[m][2 + h] = word 2t+1. W = 4: a[m][h] = word t, a[m][2 +
    h] its complement."""
    a = np.zeros((32, mb, 4), np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for m in range(mb):
            for h in range(2):
                row = 16 * m + g + 8 * h
                words = (q_rows[row] if row < bq
                         else np.zeros(q_rows.shape[1], np.uint32))
                if w == 8:
                    a[lane, m, h] = words[2 * t]
                    a[lane, m, 2 + h] = words[2 * t + 1]
                else:
                    a[lane, m, h] = words[t]
                    a[lane, m, 2 + h] = ~words[t]
    return a


def _load_chunk(x_rows, c, rows, w):
    """load_chunk<W>: each lane (g, t)'s int2 of chunk row c*8 + g, zeros
    past ``rows``: words 2t, 2t+1 at W = 8; word t and 0 at W = 4."""
    b = np.zeros((32, 2), np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        r = c * 8 + g
        if r < rows:
            b[lane] = x_rows[r, 2 * t:2 * t + 2] if w == 8 else (x_rows[r, t],
                                                                 0)
    return b


def _mma_b1(a, b):
    """mma.sync m16n8k256 .b1 AND-popc on per-lane registers, through
    PTX's fragment layout: A row g (a0, a2) or g+8 (a1, a3), k = 32t + i
    (a0, a1) or 128 + 32t + i (a2, a3); B column g, k = 32t + i (b0) or
    128 + 32t + i (b1); lane (g, t)'s c0, c1 are row g, columns 2t, 2t+1
    and c2, c3 the same of row g+8. -> (32, 4) accumulators."""
    A = np.zeros((16, 256), np.int64)
    B = np.zeros((256, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            k0 = 32 * t + 128 * (j >> 1)
            A[g + 8 * (j & 1), k0:k0 + 32] = _bits(a[lane, j])
        for j in range(2):
            k0 = 32 * t + 128 * j
            B[k0:k0 + 32, g] = _bits(b[lane, j])
    C = A @ B
    return np.array([[C[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)]
                      for i in range(4)] for lane in range(32)])


def _tile(q_rows, x_rows, bq, rows, w):
    """The kernels' distance tile for one warp and n8 chunk 0, lane by lane:
    the registers that TcTile<MB, W>::load and load_chunk<W> fill, the
    products of TcTile::dist (W = 8: a with ~b, then ~a with b; W = 4: one,
    a with (~b0, b0)), and each lane's d[m][2h + e] read back as query
    16m+g+8h, chunk row 2t+e -> (16 * MB, 8) distances."""
    mb = {1: 1, 2: 2, 3: 4, 4: 4}[-(-bq // 16)]     # DISPATCH_TC
    a = _load_a(q_rows, bq, mb, w)
    b = _load_chunk(x_rows, 0, rows, w)
    out = np.zeros((16 * mb, 8), np.int64)
    for m in range(mb):
        if w == 8:
            d = _mma_b1(a[:, m], ~b) + _mma_b1(~a[:, m], b)
        else:
            d = _mma_b1(a[:, m], np.stack([~b[:, 0], b[:, 0]], axis=1))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in range(2):
                for e in range(2):
                    out[16 * m + g + 8 * h, 2 * t + e] = d[lane, 2 * h + e]
    return out


TILE_CASES = [(8, 8), (16, 5), (24, 8), (32, 3), (48, 8), (64, 8)]


@pytest.mark.parametrize("bq,rows", TILE_CASES)
def test_tensor_core_tile_emulation_equals_hamming(bq, rows):
    """The d = 256 tensor-core tile (``_check_tile``)."""
    _check_tile(bq, rows, 8)


@pytest.mark.parametrize("bq,rows", TILE_CASES)
def test_tensor_core_tile_emulation_equals_hamming_d128(bq, rows):
    """The d = 128 tensor-core tile (``_check_tile``)."""
    _check_tile(bq, rows, 4)


def _check_tile(bq, rows, w):
    """The tensor-core tile at d = 32 * w, emulated lane by lane (each
    side's registers loaded as the kernel indexes them, the product taken
    through PTX's fragment layout, so a wrong index on either side fails),
    against ``binary.hamming_xor`` on zero-padded rows: random words with
    the top bit set half the time, zero-padded codes (d = 200 in 256 bits,
    72 in 128), identical rows (distance 0), complements (32 * w), query
    rows past bq and chunk rows past ``rows``, and the bins - 1 clamp."""
    from repro_torch.core.binary import hamming_xor

    rng = np.random.default_rng(20 + bq)
    q = rng.integers(0, 1 << 32, (64, w), dtype=np.uint32)
    x = rng.integers(0, 1 << 32, (8, w), dtype=np.uint32)
    q[::2, w - 1] |= np.uint32(1 << 31)
    for a in (q, x):                              # zero padding
        a[1, w - 2] &= np.uint32((1 << 8) - 1)
        a[1, w - 1] = 0
    x[2] = q[2]                                   # distance 0
    x[0] = ~q[0]                                  # distance 32 * w
    got = _tile(q, x, bq, rows, w)
    qz = np.where(np.arange(got.shape[0])[:, None] < bq, q[:got.shape[0]], 0)
    xz = np.where(np.arange(8)[:, None] < rows, x, 0)
    want = hamming_xor(torch.from_numpy(qz.astype(np.uint32).view(np.int32)),
                       torch.from_numpy(xz.astype(np.uint32).view(np.int32)))
    assert np.array_equal(got, want.numpy())
    j = lambda a: jnp.asarray(a.view(np.int32))
    assert np.array_equal(got[:bq, :rows], np.asarray(
        jbin.hamming_xor(j(q[:bq]), j(x[:rows]))))
    assert got[2, 2] == 0 and got[0, 0] == 32 * w
    for bins in (257, 129, 9):                    # the kernels' clamp
        assert np.array_equal(np.minimum(got, bins - 1),
                              np.minimum(want.numpy(), bins - 1))
