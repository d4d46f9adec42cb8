"""The comparison that decides `correct`: served frames against the plain
reference's, each frame of each batch element on its own.

Two numbers, each the worst over the compared frames: the relative L2
gap ||served - reference|| / ||reference|| of a frame, and the widest
gap of one pixel value, max |served - reference|. Each is held to its
limit (limits/<cell>.json); a number that is not finite fails.
"""

from __future__ import annotations

import math


def frames(served: list, reference: list, limits: dict) -> dict:
    """served, reference: lists of (B, 3, H, W) frames in the same order.
    Returns {number: {"value": worst reading, "limit": its limit}}."""
    rel, widest = [], []
    for s, r in zip(served, reference, strict=True):
        for b in range(r.shape[0]):
            d = s[b].double() - r[b].double()
            rel.append((d.norm() / r[b].double().norm()).item())
            widest.append(d.abs().max().item())
    return {"frame_rel_l2": {"value": _worst(rel), "limit": limits["frame_rel_l2"]},
            "frame_max_abs": {"value": _worst(widest), "limit": limits["frame_max_abs"]}}


def _worst(values: list) -> float:
    """The largest value, NaN where any is NaN."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
