"""The correlation kernel's tile map (csrc/correlation.cu), walked in numpy.

The CUDA kernel runs only on the card. Its index arithmetic is repeated
here, block by block and thread by thread, from the constants that
vid2vid_tpu_torch.ops.correlation mirrors (`TILE_*`, `correlation_plan`):
the staging map (which thread copies which f2 / f1 tap into which
shared-memory slot, zero-filled outside the image), the compute map (which
slots a thread reads for which output) and the store map (the shuffle
across parities, the pairs of columns). The walk checks that every output
is written exactly once, that every tap a thread reads is the staged value
of that tap or an out-of-image zero, and that the cost volume it computes
from the staged windows equals JAX's correlation_ref.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from vid2vid_tpu.ops.correlation import correlation_ref
from vid2vid_tpu_torch.ops import correlation as corr

Q, M, TX, CC = corr.TILE_ROWS, corr.TILE_DIAGS, corr.TILE_X, corr.TILE_CHUNK
RAD, MD = corr.KERNEL_RADIUS, corr.KERNEL_MAX_DISPLACEMENT
ND = 2 * RAD + 1
NT, WIN = corr.TILE_THREADS, corr.TILE_WINDOW
ODD2, ROW2 = corr.TILE_F2_ODD, corr.TILE_F2_ROW
ODD1, ROW1 = corr.TILE_F1_ODD, corr.TILE_F1_ROW
NDG = corr.TILE_DIAG_GROUPS
F2_STAGE = M * CC * ROW2
STAGE = F2_STAGE + Q * CC * ROW1
F2_ROWS_PER_PASS, F1_ROWS_PER_PASS = NT // WIN, NT // TX

# (B, C, H, W): C = 1 and C not a multiple of the chunk, H = W = 1, H and W
# below the tile, W odd, H not a multiple of 2 * TILE_ROWS, the training
# recipe's shape (split channel sum) and a split of 16
SHAPES = [(2, 17, 1, 1), (1, 3, 45, 130), (1, 256, 8, 16), (2, 256, 32, 64),
          (1, 1, 5, 20), (2, 9, 7, 33)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _stage_slots(x0, u0, n0, par):
    """Every copy the block's threads make for one chunk: arrays over the
    copies of (shared-memory slot, is f2, channel in the chunk, row, column)
    of the tap copied, as the kernel's `stage` computes them."""
    t = np.arange(NT)
    out = []
    p2, r2 = t % WIN, t // WIN
    stagers = r2 < F2_ROWS_PER_PASS
    p2, r2 = p2[stagers], r2[stagers]
    d2 = r2 * ROW2 + (p2 & 1) * ODD2 + (p2 >> 1)
    for n in range(M):
        for cc in range(0, CC, F2_ROWS_PER_PASS):
            out.append((d2 + (n * CC + cc) * ROW2, np.ones_like(p2, bool), r2 + cc,
                        np.full_like(p2, 2 * (u0 + n0 + n - RAD) + par), x0 - MD + p2))
    p1, r1 = t % TX, t // TX
    d1 = F2_STAGE + r1 * ROW1 + (p1 & 1) * ODD1 + (p1 >> 1)
    for q in range(Q):
        for cc in range(0, CC, F1_ROWS_PER_PASS):
            out.append((d1 + (q * CC + cc) * ROW1, np.zeros_like(p1, bool), r1 + cc,
                        np.full_like(p1, 2 * (u0 + q) + par), x0 + p1))
    return [np.concatenate(a) for a in zip(*out)]


def _compute_slots():
    """The slots a thread (warp nl, lane) reads for channel 0 of a chunk:
    f1 [nl, lane, q, e] and f2 [nl, lane, e, i] (the window word e + i);
    channel cc adds cc * ROW1 and cc * ROW2."""
    nl = np.arange(M)[:, None]
    lane = np.arange(32)[None, :]
    px, t16 = lane >> 4, lane & 15
    f2_read = nl * CC * ROW2 + px * ODD2 + 2 * t16
    f1_read = F2_STAGE + px * ODD1 + 2 * t16
    q, e, i = np.arange(Q), np.arange(2), np.arange(ND)
    a = f1_read[..., None, None] + (q * CC * ROW1)[:, None] + e
    w = f2_read[..., None, None] + e[:, None] + i
    return a, w, px, t16


@functools.cache
def walk(shape):
    """(cost volume, writes per output and part, f2 taps copied from
    global memory) of the kernel's map on seeded inputs of `shape`; raises
    AssertionError at the first slot or tap that is off."""
    b_n, c_n, h, w_n = shape
    rng = np.random.default_rng(sum(shape))
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    plan = corr.correlation_plan(*shape)
    chunks = -(-c_n // CC)
    parts = np.zeros((plan.split, b_n, ND * ND, h, w_n), np.float32)
    writes = np.zeros(parts.shape, np.int32)
    scale = np.float32(1.0 / c_n) if plan.split == 1 else np.float32(1.0)
    a_slot, w_slot, px, t16 = _compute_slots()
    f2_copied = 0
    gx, gy, gz = plan.grid
    for bz in range(gz):
        par, b, part = bz & 1, (bz >> 1) % b_n, (bz >> 1) // b_n
        hp = (h - par + 1) >> 1
        for by in range(gy):
            g, n0 = by // NDG, (by % NDG) * M
            u0 = g * Q
            if u0 >= hp:
                continue
            k0 = part * plan.chunks_per_part
            k1 = min(chunks, k0 + plan.chunks_per_part)
            for bx in range(gx):
                x0 = bx * TX
                # every copy lands in its own slot of the stage; the padding
                # slots between the halves are never written and never read
                slot, is_f2_c, cc_c, yy_c, xx_c = _stage_slots(x0, u0, n0, par)
                assert len(np.unique(slot)) == len(slot) and slot.min() >= 0
                assert slot.max() < STAGE
                written = np.zeros(STAGE, bool)
                written[slot] = True
                is_f2, cc, yy, xx = (np.zeros(STAGE, bool), *(np.full(STAGE, -10**6)
                                                                for _ in range(3)))
                is_f2[slot], cc[slot], yy[slot], xx[slot] = is_f2_c, cc_c, yy_c, xx_c
                for ch in range(CC):
                    assert written[a_slot + ch * ROW1].all()
                    assert written[w_slot + ch * ROW2].all()
                in_image = written & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w_n)
                # the compute map: thread (nl, lane), row q, pixel e, dx i
                x = x0 + 4 * t16 + px
                xe = x[..., None] + 2 * np.arange(2)                      # [nl, lane, e]
                y_q = 2 * (u0 + np.arange(Q)) + par                       # [q]
                assert not is_f2[a_slot].any() and is_f2[w_slot].all()
                for ch in range(CC):
                    assert (cc[a_slot + ch * ROW1] == ch).all()
                    assert (cc[w_slot + ch * ROW2] == ch).all()
                assert (yy[a_slot] == y_q[:, None]).all()
                assert (xx[a_slot] == xe[:, :, None, :]).all()
                # the f2 row of diagonal n0 + nl is y + 2(j - 10), j = n - q
                y2 = 2 * (u0 + n0 + np.arange(M) - RAD) + par
                assert (yy[w_slot] == y2[:, None, None, None]).all()
                assert (xx[w_slot] == xe[..., None] + 2 * (np.arange(ND) - RAD)).all()
                acc = np.zeros((M, 32, Q, 2, ND), np.float32)
                for k in range(k0, k1):
                    c = k * CC + cc
                    live = in_image & (c < c_n)
                    f2_copied += int((live & is_f2).sum())
                    vals = np.zeros(STAGE, np.float32)
                    vals[live & is_f2] = f2[b, c[live & is_f2], yy[live & is_f2],
                                            xx[live & is_f2]]
                    live1 = live & ~is_f2
                    vals[live1] = f1[b, c[live1], yy[live1], xx[live1]]
                    for ch in range(CC):
                        a = vals[a_slot + ch * ROW1]                      # [nl, lane, q, e]
                        wv = vals[w_slot + ch * ROW2]                     # [nl, lane, e, i]
                        acc += a[..., None] * wv[:, :, None]
                # the store map: shuffle across the parities, pairs of columns
                e0, e1 = acc[..., 0, :] * scale, acc[..., 1, :] * scale  # [nl, lane, q, i]
                send = np.where((px == 1)[..., None, None], e0, e1)
                got = send[:, np.arange(32) ^ 16]
                v0 = np.where((px == 1)[..., None, None], got, e0)
                v1 = np.where((px == 1)[..., None, None], e1, got)
                xs = x0 + 4 * t16 + 2 * px                                # [1, lane]
                for q in range(Q):
                    for nl in range(M):
                        u, j = u0 + q, n0 + nl - q
                        if not (u < hp and 0 <= j < ND):
                            continue
                        y = 2 * u + par
                        for d, v in ((0, v0), (1, v1)):
                            col = xs[0] + d
                            ok = col < w_n
                            ch = j * ND + np.arange(ND)
                            parts[part, b, ch[:, None], y, col[ok][None]] = v[nl, ok, q].T
                            np.add.at(writes, (part, b, ch[:, None], y, col[ok][None]), 1)
    # split > 1: the second pass adds the parts in order, then scales
    out = parts[0] if plan.split == 1 else (
        functools.reduce(np.add, parts) * np.float32(1.0 / c_n))
    return f1, f2, out, writes, f2_copied


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_output_is_written_exactly_once(shape):
    _, _, _, writes, _ = walk(shape)
    assert (writes == 1).all(), np.argwhere(writes != 1)[:5]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_walk_of_the_staged_windows_matches_correlation_ref(shape):
    """The cost volume from the staged windows (taps read where the map
    says, zero outside the image) against JAX's correlation_ref at 1e-6:
    only the order of the channel sum differs."""
    f1, f2, got, _, _ = walk(shape)
    want = correlation_ref(jnp.asarray(np.moveaxis(f1, 1, -1)),
                           jnp.asarray(np.moveaxis(f2, 1, -1)), MD, 2)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f2_stagings_count_the_walks_copies(shape):
    b, c, h, w = shape
    _, _, _, _, copied = walk(shape)
    assert copied == pytest.approx(corr.f2_stagings(h, w) * b * c * h * w)


def test_plan_fills_the_card_and_leaves_no_part_empty():
    for shape in SHAPES + [(2, 256, 128, 256), (2, 256, 64, 128)]:
        b, c, h, w = shape
        plan = corr.correlation_plan(*shape)
        chunks = -(-c // CC)
        assert (plan.split - 1) * plan.chunks_per_part < chunks  # the last part has work
        assert plan.split * plan.chunks_per_part >= chunks
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        assert blocks >= corr.H100_SMS * corr.TILE_BLOCKS_PER_SM or plan.split == chunks
    # the FlowNet2 shape is not split; the 512x256 training shape is
    assert corr.correlation_plan(2, 256, 128, 256).split == 1
    assert corr.correlation_plan(2, 256, 32, 64).split == 3


def test_f2_stagings_at_the_flownet2_shape():
    """Each f2 value is staged (TILE_ROWS + 20) / TILE_ROWS times by the row
    groups, times the window's overhead, less the taps outside the image:
    at most 15 (about 34 with one output row per block)."""
    assert corr.f2_stagings(128, 256) <= 15
    assert corr.f2_stagings(128, 256) == pytest.approx(7.986, abs=1e-3)


def test_staging_writes_and_compute_reads_are_free_of_bank_conflicts():
    """Each copy instruction of a warp (one row slot, 32 consecutive
    columns split by parity) writes 32 distinct banks, and each LDS.64 of
    a half-warp (16 lanes x 2 words) reads 32 distinct banks: the odd
    halves start at 16 (mod 32) past the even ones (TILE_F2_ODD,
    TILE_F1_ODD)."""
    for width, odd, row in ((WIN, ODD2, ROW2), (TX, ODD1, ROW1)):
        for slot_base in (0, row, 5 * row):
            for p0 in range(0, width, 32):
                p = np.arange(p0, min(p0 + 32, width))
                banks = (slot_base + (p & 1) * odd + (p >> 1)) % 32
                assert len(np.unique(banks)) == len(p), (width, slot_base, p0)
    t16 = np.arange(16)
    for odd, row in ((ODD2, ROW2), (ODD1, ROW1)):
        for px in (0, 1):
            for m in range(0, 22, 2):
                words = (row + px * odd + 2 * t16 + m)[:, None] + np.arange(2)
                assert len(np.unique(words % 32)) == 32
