"""K4's bf16 kernel keeps Q, K and V in shared memory in wgmma's swizzled
canonical layouts. This file mirrors that arithmetic in Python (the lines
of ``csrc/flash_attention.cu`` pinned in ``PINNED``): at every head dim,
every 16-byte chunk the copies write is where the kernel's descriptors
make wgmma read it, each chunk once, and the 8 chunks a quarter-warp
writes fall in 8 different bank groups. The card checks the kernel itself
(``chip_smoke.py``, ``chip_k4_tiles.py``); this pins the layout's algebra
on the CPU."""
from pathlib import Path

import pytest

from repro_torch.kernels import flash_attention as tfa

SOURCE = (Path(tfa.__file__).resolve().with_name("csrc")
          / "flash_attention.cu")
# the kernel's lines this file mirrors; change both together
PINNED = (
    "constexpr int WG = 2;",
    "static constexpr int BK = 64;",
    "static constexpr int PW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;",
    "return r * PB + ((c ^ ((r * PB >> 7) & (CH - 1))) << 4);",
    "constexpr int RP = THREADS / CH;",
    "const int c = tid % CH, rt = tid / CH;",
    "cp_async16(d + (p * ROWS + rr * RP) * PB, row + p * PW, in ? 16 : 0);",
    "const unsigned qa = Qs + 64 * wg * PB;",
    "const unsigned p = kk * 16 / PW, col = kk * 16 % PW * 2;",
    "desc<HD>(qa + p * BQ * PB + col, 16, 8 * PB)",
    "desc<HD>(ka + p * BK * PB + col, 16, 8 * PB)",
    "desc<HD>(va + kt * 16 * PB, BK * PB, 8 * PB)",
)
WG, BK = 2, 64
BQ, THREADS = 64 * WG, 128 * WG


def panel(hd: int) -> int:
    """Tile<HD>::PW: elements in a panel row."""
    return 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else 16


def swizzle(addr: int, pb: int) -> int:
    """wgmma's 128-, 64- or 32-byte swizzle (rows of pb bytes): the 16-byte
    chunk bits of a shared address XORed with the bits from 7 up."""
    return addr ^ (((addr >> 7) & (pb // 16 - 1)) << 4)


def written(rows: int, hd: int):
    """load_tile for a rows x hd tile: {(row, chunk of the row): byte
    offset}, and the offsets each copy instruction's 256 threads write
    (None where a thread has no row)."""
    pw = panel(hd)
    pb, ch = 2 * pw, pw // 8
    rp = THREADS // ch
    where, issues = {}, []
    for rr in range(-(-rows // rp)):
        for p in range(hd // pw):
            offs = []
            for tid in range(THREADS):
                c, rt = tid % ch, tid // ch
                r = rt + rr * rp
                if r >= rows:
                    offs.append(None)
                    continue
                # swizzled(rt, c) + (p * ROWS + rr * RP) * PB
                off = (rt * pb + ((c ^ ((rt * pb >> 7) & (ch - 1))) << 4)
                       + (p * rows + rr * rp) * pb)
                assert (r, p * ch + c) not in where
                where[(r, p * ch + c)] = off
                offs.append(off)
            issues.append(offs)
    return where, issues


def desc_fields(addr: int, lbo: int, sbo: int):
    """desc<HD>'s fields as wgmma decodes them (16-byte units, 14 bits)."""
    for x in (addr, lbo, sbo):
        assert x % 16 == 0 and x >> 4 < 1 << 14
    return addr, lbo, sbo


def read_k_major(desc, pb: int, row: int, kc: int) -> int:
    """The byte a K-major operand's chunk kc (of the k16 slice) of row
    `row` is read from: rows pb bytes apart in groups of 8 that are SBO
    apart; the leading offset is unused under a swizzle."""
    start, _, sbo = desc
    return swizzle(start + row // 8 * sbo + row % 8 * pb + 16 * kc, pb)


def read_mn_major(desc, pb: int, key: int, nc: int) -> int:
    """The byte an MN-major operand's chunk nc (along N) of k-row `key` is
    read from: each k-row holds one panel row of pb bytes, 8 k-rows make a
    group SBO apart, panels (pb / 16 chunks of N) are LBO apart."""
    start, lbo, sbo = desc
    ch = pb // 16
    return swizzle(start + key // 8 * sbo + key % 8 * pb + nc // ch * lbo
                   + nc % ch * 16, pb)


def test_the_mirror_pins_the_kernel_source():
    text = SOURCE.read_text()
    for line in PINNED:
        assert line in text, line


@pytest.mark.parametrize("hd", tfa._HEAD_DIMS)
def test_copies_write_where_wgmma_reads(hd):
    pw = panel(hd)
    pb = 2 * pw
    assert hd % pw == 0 and hd % 16 == 0
    q_at, q_issues = written(BQ, hd)
    kv_at, kv_issues = written(BK, hd)
    # every chunk of the tile written once, inside the tile
    for rows, at in ((BQ, q_at), (BK, kv_at)):
        assert len(at) == rows * hd // 8
        assert sorted(at.values()) == list(range(0, rows * hd * 2, 16))
    # a quarter-warp's 8 copies fall in 8 different 16-byte bank groups
    for offs in q_issues + kv_issues:
        for i in range(0, THREADS, 8):
            quarter = [o for o in offs[i:i + 8] if o is not None]
            assert len({o // 16 % 8 for o in quarter}) == len(quarter)
    # S = Q K^T: slice kk of hd, both operands K-major
    for kk in range(hd // 16):
        p, col = kk * 16 // pw, kk * 16 % pw * 2
        kd = desc_fields(p * BK * pb + col, 16, 8 * pb)
        for key in range(BK):
            for kc in range(2):
                assert read_k_major(kd, pb, key, kc) == kv_at[(key,
                                                               2 * kk + kc)]
        for wg in range(WG):
            qa = 64 * wg * pb
            qd = desc_fields(qa + p * BQ * pb + col, 16, 8 * pb)
            for row in range(64):
                for kc in range(2):
                    assert read_k_major(qd, pb, row, kc) == q_at[
                        (64 * wg + row, 2 * kk + kc)]
    # O += P V: V the MN-major B operand, N = hd, slice kt of the keys
    for kt in range(BK // 16):
        vd = desc_fields(kt * 16 * pb, BK * pb, 8 * pb)
        for key in range(16):
            for nc in range(hd // 8):
                assert read_mn_major(vd, pb, key, nc) == kv_at[
                    (16 * kt + key, nc)]
