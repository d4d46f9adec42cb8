"""Seeded street-like label sequences: the traffic's inputs.

An extension of the program's one-square clip (data/synthetic.py::
moving_square_clip) towards Cityscapes' label maps: per frame a sky, a
skyline of buildings, walls and vegetation, a road in perspective with
sidewalks and terrain, poles with signs, people on the sidewalks, a dozen
cars (the foreground class 26) on the road and the ego vehicle's bonnet.
Each class is a piecewise-constant region, with Cityscapes' ids; the
instance map gives each car and person its own id (label * 1000 + k) and
every other pixel its label, as Cityscapes' instanceIds do. Across a
sequence the skyline and poles pan by a few pixels a frame and each car
and person moves by its own few pixels.

The layout is drawn from the seed with numpy and rasterised with torch on
the given device, every frame of a sequence in one pass; the work a frame
takes from the program does not depend on what is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

SKY, BUILDING, WALL, VEGETATION, TERRAIN = 23, 11, 12, 21, 22
ROAD, SIDEWALK, POLE, SIGN, PERSON, CAR, EGO = 7, 8, 17, 20, 24, 26, 1


def _paint(label, inst, mask, cls, ident=None):
    label.masked_fill_(mask, cls)
    inst.masked_fill_(mask, cls if ident is None else ident)


def street_sequence(rng: np.random.Generator, n_frames: int, height: int, width: int,
                    motion_px: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence: (labels, instance ids), each (n_frames, H, W) int32."""
    h, w = height, width
    t = torch.arange(n_frames, device=device, dtype=torch.float32).view(-1, 1, 1)
    y = torch.arange(h, device=device, dtype=torch.float32).view(1, -1, 1)
    x = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, -1)
    shape = (n_frames, h, w)
    label = torch.full(shape, SKY, dtype=torch.int32, device=device)
    inst = torch.full(shape, SKY, dtype=torch.int32, device=device)

    horizon = h * rng.uniform(0.42, 0.5)
    pan = rng.uniform(0.5, 1.0) * motion_px * rng.choice([-1.0, 1.0])
    xs = x + pan * t  # the world's column under each pixel
    # skyline: segments of building, wall or vegetation of random heights
    edges = np.sort(rng.uniform(-0.2 * w, 1.2 * w + abs(pan) * n_frames, 18))
    for a, b in zip(edges[:-1], edges[1:]):
        top = horizon - h * rng.uniform(0.08, 0.4)
        cls = int(rng.choice([BUILDING, BUILDING, WALL, VEGETATION]))
        _paint(label, inst, (xs >= a) & (xs < b) & (y >= top) & (y < horizon + 1), cls)
    # road in perspective, sidewalks, terrain
    below = (y >= horizon).expand(shape)
    depth = ((y - horizon) / (h - horizon)).clamp_min(0)
    vanish = w * rng.uniform(0.4, 0.6)
    half = w * rng.uniform(0.5, 0.8) * depth
    off = (x - vanish).abs()
    _paint(label, inst, below & (off >= 1.3 * half), TERRAIN)
    _paint(label, inst, below & (off < 1.3 * half), SIDEWALK)
    _paint(label, inst, below & (off < half), ROAD)
    # poles with signs, which pan with the skyline
    for px in rng.uniform(-0.1 * w, 1.1 * w + abs(pan) * n_frames, 8):
        pw = max(2.0, w * rng.uniform(0.003, 0.008))
        top = horizon - h * rng.uniform(0.1, 0.3)
        foot = horizon + h * rng.uniform(0.02, 0.12)
        _paint(label, inst, (xs >= px) & (xs < px + pw) & (y >= top) & (y < foot), POLE)
        if rng.uniform() < 0.6:
            sw = pw * rng.uniform(3, 6)
            _paint(label, inst, (xs >= px - sw / 2) & (xs < px + sw / 2) & (y >= top)
                   & (y < top + sw), SIGN)
    # people on the sidewalks and cars on the road, far ones first
    things = [(PERSON, k) for k in range(5)] + [(CAR, k) for k in range(12)]
    rows = rng.uniform(0.08, 0.9, len(things))
    for i in np.argsort(rows):
        cls, k = things[i]
        d = rows[i]
        cy = horizon + d * (h - horizon)
        if cls == CAR:
            bw, bh = w * 0.12 * d + 4, w * 0.06 * d + 3
            cx = vanish + rng.uniform(-0.9, 0.9) * w * 0.6 * d
        else:
            bw, bh = w * 0.015 * d + 2, h * 0.2 * d + 4
            cx = vanish + rng.choice([-1.0, 1.0]) * rng.uniform(1.05, 1.25) * w * 0.65 * d
        vx, vy = rng.uniform(-1, 1) * motion_px, rng.uniform(-0.3, 0.3) * motion_px
        x0, y0 = cx - bw / 2 + vx * t, cy - bh + vy * t
        body = (x >= x0) & (x < x0 + bw) & (y >= y0) & (y < y0 + bh)
        if cls == CAR:  # a narrower cab on the body
            body |= ((x >= x0 + 0.2 * bw) & (x < x0 + 0.8 * bw) & (y >= y0 - 0.4 * bh)
                     & (y < y0))
        _paint(label, inst, body, cls, cls * 1000 + k)
    _paint(label, inst, (y >= h * rng.uniform(0.92, 0.96)).expand(shape), EGO)
    return label, inst


def street_pool(seed: int, n_sequences: int, n_frames: int, height: int, width: int,
                motion_px: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`n_sequences` sequences drawn from `seed`, rasterised on `device`:
    (labels, instance ids), each (n_sequences, n_frames, H, W) int32."""
    rng = np.random.default_rng(seed)
    seqs = [street_sequence(rng, n_frames, height, width, motion_px, device)
            for _ in range(n_sequences)]
    return torch.stack([s[0] for s in seqs]), torch.stack([s[1] for s in seqs])
