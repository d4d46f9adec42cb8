"""The warp forward's plan (ops/warp.py::warp_forward_plan) and its staged
tiles (staged_tiles), on the CPU.

csrc/warp_blend.cu's forward takes 2-D tiles of the output; a block stages
its box of prev (the corners' bounding box, aligned to 16 bytes) in shared
memory where C planes of it fit the plan's budget, else gathers from device
memory. Here: the plan's launch limits at the paths' shapes and at edge
shapes, staged_tiles on hand-made flows, and a walk of the kernel's tiles in
torch (`walk`: each tile's box staged from the frame, every corner read from
it at the box's coordinates) held bit for bit to the plain versions, with
its staged count equal to staged_tiles's. A change to the kernel's box or
tile arithmetic must change the walk with it. The kernel itself is held to
the plain versions, and to staged_tiles, by tests/test_torch_cuda.py.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.ops.warp import (
    BOX_ALIGN_BYTES,
    FWD_THREADS,
    MAX_BOX_BYTES,
    STAGE_FROM_BYTES,
    WarpPlan,
    flow_warp_plain,
    plan_threads,
    staged_tiles,
    tile_plan,
    warp_blend_at_plain,
    warp_forward_plan,
)
from vid2vid_tpu_torch.tools.warp_plans import iid_flow, smooth_flow

DTYPES = [torch.float32, torch.bfloat16]
# (C, H, W, Wp) the paths give the forward: the flagship frame's three
# blends, FlowNet2's warps, the training, pose and face shapes, and the
# model axis's column shards
PATH_SHAPES = [(3, 256, 512, 512), (3, 512, 1024, 1024), (3, 1024, 2048, 2048),
               (3, 256, 192, 192), (3, 512, 448, 448), (3, 256, 224, 224),
               (3, 256, 256, 512), (3, 512, 512, 1024), (3, 1024, 1024, 2048)]
EDGE_SHAPES = [(1, 1, 1, 1), (3, 5, 7, 7), (17, 7, 9, 9), (3, 40, 150, 150),
               (3, 2, 2, 70000), (64, 2048, 4096, 4096)]


def _itemsize(dtype):
    return torch.tensor([], dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,h,w,wp", PATH_SHAPES + EDGE_SHAPES)
def test_the_plan_is_a_launch_the_kernel_takes(dtype, c, h, w, wp):
    """Whole warps of at most FWD_THREADS threads, each on 16 bytes of a
    row; a box budget within the 227 KB a block may hold (less the
    kernel's own words) and no more than the whole frame's C planes; the
    box aligned to 16 bytes; grid rows within CUDA's 65535."""
    plan = warp_forward_plan(c, dtype, h, w, wp)
    size = _itemsize(dtype)
    assert plan.align * size == BOX_ALIGN_BYTES
    threads = plan_threads(plan)
    assert 32 <= threads <= FWD_THREADS and threads % 32 == 0
    assert 0 <= plan.smem_bytes <= MAX_BOX_BYTES < 227 * 1024
    assert plan.smem_bytes <= c * h * math.ceil(wp / plan.align) * plan.align * size
    assert math.ceil(h / plan.rows) <= 65535


@pytest.mark.parametrize("rows,cols,staged,threads", [
    (32, 32, True, 256), (16, 64, True, 256), (8, 64, False, 256), (16, 32, False, 256),
    (1, 256, False, 128), (1, 64, False, 32), (2, 32, True, 0), (64, 32, True, 0),
    (16, 48, False, 0), (16, 24, True, 96), (8, 12, True, 0), (8, 50, True, 0),
    (16, 64, False, 0), (8, 33, False, 0), (0, 64, False, 0)])
def test_plan_threads_mirrors_the_entry(rows, cols, staged, threads):
    """The tiles the entry takes, in either dtype: 4 pixels a thread on a
    staged tile (a budget), 2 on a direct one, whole threads across the
    columns, 32 to 256 threads in whole warps."""
    budget = 32 * 1024 if staged else 0
    for align in (4, 8):
        plan = WarpPlan(rows, cols, budget, align)
        assert plan.pix == (4 if staged else 2)
        assert plan_threads(plan) == threads


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_rule_stages_only_large_frames(dtype):
    """Frames whose C planes of prev take less than STAGE_FROM_BYTES (every
    bf16 blend of the flagship frame, the training, pose and face shapes)
    take the direct tile: 512 pixels, 2 a thread, rows of 128 bytes, no
    budget; FlowNet2's f32 frames (3 x 1024 x 2048, 25 MB) the staged one:
    1024 pixels, 4 a thread, 32 KB."""
    size = _itemsize(dtype)
    for c, h, w, wp in PATH_SHAPES:
        plan = warp_forward_plan(c, dtype, h, w, wp)
        staged = c * h * wp * size >= STAGE_FROM_BYTES
        assert staged == (dtype == torch.float32 and (h, wp) == (1024, 2048))
        assert plan == tile_plan(dtype, staged)
        assert plan.cols * size == 128 and plan.rows * plan.cols == (1024 if staged else 512)
        assert (plan.pix, plan.smem_bytes) == ((4, 32 * 1024) if staged else (2, 0))
    # the threshold itself: one channel of 1024 rows of 16 KB stages, one
    # row less does not
    wp = 16 * 1024 // size
    assert warp_forward_plan(1, dtype, 1024, wp, wp).smem_bytes == 32 * 1024
    assert warp_forward_plan(1, dtype, 1023, wp, wp).smem_bytes == 0


def test_the_plan_is_a_pure_function_of_the_shape():
    assert warp_forward_plan(3, torch.float32, 1024, 2048, 2048) == warp_forward_plan(
        3, torch.float32, 1024, 2048, 2048)


def _flows(b, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    smooth = smooth_flow(b, h, w, g)
    return {"zero": torch.zeros(b, 2, h, w), "smooth": smooth, "iid": iid_flow(b, h, w, g),
            "far": iid_flow(b, h, w, g, scale=1e4)}


def test_staged_tiles_on_hand_made_flows():
    b, c, h, w = 2, 3, 40, 150  # ragged: 3 x 3 tiles of 16 x 64 an image
    # the box of an inner tile under a zero flow: 16 rows + 1, 64 columns + 1
    # aligned up to 68
    box = c * 17 * 68 * 4
    plan = WarpPlan(16, 64, box, 4)  # f32
    tiles = 2 * 3 * 3
    assert staged_tiles(torch.zeros(b, 2, h, w), plan, c) == tiles
    # a uniform shift moves every box, not its size
    assert staged_tiles(torch.full((b, 2, h, w), 7.25), plan, c) == tiles
    flow = torch.zeros(b, 2, h, w)
    flow[1, 0, 20, 70] = 60.0  # inside tile (1, 1)'s box: x1 = 131 < 64 + 68
    assert staged_tiles(flow, plan, c) == tiles
    flow[1, 0, 20, 70] = 70.0  # one pixel of tile (1, 1) of image 1 widens its box to 80
    assert staged_tiles(flow, plan, c) == tiles - 1
    flow[0, 1, 39, 10] = -30.0  # the ragged bottom tile of image 0: 31 rows x 68
    assert staged_tiles(flow, plan, c) == tiles - 2
    # a box that fits by one byte, and one past it: of a 32 x 128 frame's
    # four tiles only the top-left one's box reaches a row and a column past
    # the tile (the others' corners clamp at the border: 16 x 64 and less)
    assert staged_tiles(torch.zeros(1, 2, 32, 128), plan._replace(smem_bytes=box), c) == 4
    assert staged_tiles(torch.zeros(1, 2, 32, 128), plan._replace(smem_bytes=box - 1), c) == 3
    # the clamp: corners far past the border clamp to it, so the box stays small
    out = torch.full((1, 2, 32, 128), -1e6)
    assert staged_tiles(out, plan._replace(smem_bytes=c * 1 * 4 * 4), c) == 4
    # no budget, no staged tile
    assert staged_tiles(torch.zeros(b, 2, h, w), plan._replace(smem_bytes=0), c) == 0


def test_staged_tiles_at_a_column_offset():
    """A shard's corners lie in the whole frame's columns and clamp at its
    border: a flow of +60 columns from a shard of 64 columns of a frame 128
    wide stays inside the frame from x0 = 0 and 5 (a box 65 columns wide),
    and runs past its border from x0 = 64 (4 columns)."""
    plan = WarpPlan(16, 64, 3 * 17 * 8 * 4, 4)
    flow = torch.zeros(1, 2, 16, 64)
    flow[:, 0] = 60.0
    assert [staged_tiles(flow, plan, 3, wp=128, x0=x0) for x0 in (0, 5, 64)] == [0, 0, 1]


def walk(prev, flow, plan, raw=None, weight=None, x0=0):
    """The forward kernel's tiles in torch: (out, staged tiles). Each tile's
    corners, its box (left edge aligned down, width rounded up to
    plan.align columns), staged where C planes of it fit the budget, then
    every corner read from the box at its coordinates in it; a direct tile
    reads the frame. The corner and sample arithmetic is
    flow_warp_plain's."""
    b, c, h, wp = prev.shape
    w = flow.shape[3]
    f = flow.float()
    sx = torch.arange(x0, x0 + w, dtype=torch.float32).view(1, 1, w) + f[:, 0]
    sy = torch.arange(h, dtype=torch.float32).view(1, h, 1) + f[:, 1]
    fx, fy = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - fx).unsqueeze(1), (sy - fy).unsqueeze(1)
    xi, yi = fx.clamp(-1, wp).long(), fy.clamp(-1, h).long()
    xa, xb = xi.clamp(0, wp - 1), (xi + 1).clamp(0, wp - 1)
    ya, yb = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    size, a = BOX_ALIGN_BYTES // plan.align, plan.align
    # the frame padded to whole groups of 16 bytes: the box's last group may
    # run past Wp (the kernel copies only columns < Wp; the padding is never read)
    frame = F.pad(prev, (0, math.ceil(wp / a) * a - wp), value=float("nan"))
    out = torch.empty(b, c, h, w, dtype=prev.dtype)
    staged = 0
    for i in range(b):
        for y0 in range(0, h, plan.rows):
            for c0 in range(0, w, plan.cols):
                t = (i, slice(y0, y0 + plan.rows), slice(c0, c0 + plan.cols))
                bx0 = int(xa[t].min()) // a * a
                sw = (int(xb[t].max()) + 1 - bx0 + a - 1) // a * a
                by0, sh = int(ya[t].min()), int(yb[t].max()) + 1 - int(ya[t].min())
                if c * sh * sw * size <= plan.smem_bytes:
                    staged += 1
                    src, ox, oy = frame[i, :, by0 : by0 + sh, bx0 : bx0 + sw], bx0, by0
                else:
                    src, ox, oy = prev[i], 0, 0
                rows = src.reshape(c, -1)

                def tap(yy, xx):
                    idx = ((yy[t] - oy) * src.shape[2] + (xx[t] - ox)).reshape(-1)
                    return rows[:, idx].view(c, *yy[t].shape)

                twx, twy = wx[i, :, t[1], t[2]], wy[i, :, t[1], t[2]]
                top = tap(ya, xa) * (1.0 - twx) + tap(ya, xb) * twx
                bot = tap(yb, xa) * (1.0 - twx) + tap(yb, xb) * twx
                out[i, :, t[1], t[2]] = top * (1.0 - twy) + bot * twy
    if raw is not None:
        out = raw * weight + out * (1.0 - weight)
    return out, staged


@pytest.mark.parametrize("kind", ["zero", "mix", "far"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_the_tile_walk_equals_flow_warp_plain(kind, dtype):
    """Staged and direct tiles (a budget of 16 KB) give flow_warp_plain's
    values bit for bit, ragged tiles included: a zero flow stages every
    tile, a flow far past the borders none (its corners clamp to the four
    edges), and the mix (a smooth flow on top, an i.i.d. one below) some;
    the walk stages staged_tiles's count."""
    b, c, h, w = 1, 3, 40, 200
    g = torch.Generator().manual_seed(1)
    prev = torch.randn((b, c, h, w), generator=g).to(dtype).float()
    flows = _flows(b, h, w, 2)
    flows["mix"] = torch.cat([flows["smooth"][:, :, :16], flows["iid"][:, :, 16:]], 2)
    flow = flows[kind].to(dtype).float()
    plan = warp_forward_plan(c, dtype, h, w, w)._replace(smem_bytes=16 * 1024)
    got, staged = walk(prev, flow, plan)
    assert torch.equal(got, flow_warp_plain(prev, flow))
    assert staged == staged_tiles(flow, plan, c)
    tiles = math.ceil(h / plan.rows) * math.ceil(w / plan.cols)
    assert {"zero": staged == tiles, "far": staged == 0, "mix": 0 < staged < tiles}[kind]


@pytest.mark.parametrize("x0", [0, 5, 64])
def test_the_tile_walk_at_a_column_offset_equals_the_plain_blend(x0):
    """The model axis's blend: a shard's W = 128 columns from column x0 of a
    frame Wp = 260 wide (not a whole number of 16-byte groups), the box
    aligned in the frame's columns."""
    b, c, h, w, wp = 1, 3, 33, 128, 260
    g = torch.Generator().manual_seed(x0)
    prev = torch.randn((b, c, h, wp), generator=g)
    raw = torch.randn((b, c, h, w), generator=g)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g))
    flow = torch.cat([_flows(b, h, w, 3)["smooth"][:, :, : h // 2],
                      _flows(b, h, w, 4)["iid"][:, :, h // 2 :]], 2)  # a mix
    plan = warp_forward_plan(c, torch.float32, h, w, wp)._replace(smem_bytes=24 * 1024)
    got, staged = walk(prev, flow, plan, raw, weight, x0)
    assert torch.equal(got, warp_blend_at_plain(raw, prev, flow, weight, x0))
    assert staged == staged_tiles(flow, plan, c, wp, x0)
    assert 0 < staged < math.ceil(h / plan.rows) * math.ceil(w / plan.cols)
