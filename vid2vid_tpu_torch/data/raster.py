"""The four raster operations the face conditioning needs, in numpy and
scipy, as OpenCV and Pillow compute them (the JAX package's
data/face.py calls cv2 and PIL for these; the port imports neither).

  fill_poly(img, pts, color)  cv2.fillPoly(img, [pts], color): lineType 8,
                              shift 0, int32 vertices (the outline drawn
                              with 8-connected lines, then the scanline fill
                              on 16.16 fixed-point edges); bit for bit where
                              every vertex lies in the image; with vertices
                              outside, cv2 also fills some pixels of the
                              image's border rows and columns that this
                              fill leaves (the tests bound their share);
  distance_l1(chain)          cv2.distanceTransform(255 - chain, DIST_L1, 3)
                              as float32; a chain without an edge pixel
                              gives FLT_MAX everywhere, as cv2 does;
  canny(gray, low, high)      cv2.Canny(gray, low, high): aperture 3, the L1
                              magnitude, BORDER_REPLICATE Sobel, cv2's
                              non-maximum rule (its tan 22.5 degree test in
                              Q15, `>` on one side and `>=` on the other),
                              8-connected hysteresis;
  rgb_to_gray(rgb)            PIL's convert("L"): (R*19595 + G*38470 +
                              B*7471 + 0x8000) >> 16.

tests/test_torch_face_pose_data.py holds each to cv2 / PIL. scipy.ndimage
is imported where it is used: its import starts a subprocess (lscpu).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16  # cv2's fixed-point fraction bits for polygon edges
XY_ONE = 1 << XY_SHIFT
CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)
FLT_MAX = np.finfo(np.float32).max


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def clip_line(w: int, h: int, p1: tuple, p2: tuple):
    """cv2::clipLine on a (w, h) image: ((x1, y1), (x2, y2), inside).
    Like cv2, a line that misses the image may come back partly moved."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def line_pixels(w: int, h: int, p1: tuple, p2: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of cv2's 8-connected line from p1 to p2 on a (w, h) image
    (LineIterator, left to right, clipped to the image)."""
    inside = all(0 <= x < w and 0 <= y < h for x, y in (p1, p2))
    if not inside:
        p1, p2, ok = clip_line(w, h, p1, p2)
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # err starts at major - 2 minor; a step moves along the major axis, and
    # along the minor one too where err (before the step) is negative
    k = np.arange(major + 1, dtype=np.int64)
    err = major - 2 * minor
    steps = np.zeros(major + 1, np.int64)
    n = 0
    for i in range(1, major + 1):
        if err < 0:
            err += 2 * major - 2 * minor
            n += 1
        else:
            err -= 2 * minor
        steps[i] = n
    if vert:
        return y1 + sy * k, x1 + steps
    return y1 + sy * steps, x1 + k


def fill_poly(img: np.ndarray, pts: np.ndarray, color: int) -> np.ndarray:
    """cv2.fillPoly(img, [pts], color) at lineType 8, shift 0, in place on
    a 2-D uint8 image; returns img."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []  # (y0, x, dx, y1) in 16.16 fixed point
    p0 = pts[-1]
    for p1 in pts:
        ys, xs = line_pixels(w, h, p0, p1)
        img[ys, xs] = color
        # cv2's PolyEdge, with its clipped end points where one lies outside
        t0, t1 = p0, p1
        c0 = (p0[0] << XY_SHIFT, p0[1])
        c1 = (p1[0] << XY_SHIFT, p1[1])
        if not all(0 <= x < w and 0 <= y < h for x, y in (t0, t1)):
            t0, t1, _ = clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0 = (t0[0] << XY_SHIFT, t0[1])
                c1 = (t1[0] << XY_SHIFT, t1[1])
        if p0[1] != p1[1]:
            dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
            if p0[1] < p1[1]:
                edges.append((p0[1], c0[0] + (p0[1] - c0[1]) * dx, dx, p1[1]))
            else:
                edges.append((p1[1], c1[0] + (p1[1] - c1[1]) * dx, dx, p0[1]))
        p0 = p1
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    y0, x0, dx, y1 = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << XY_SHIFT)):
        return img
    # an edge is active on rows y0 <= y < y1, where its x is x0 + (y - y0) dx
    # (cv2 adds dx row by row: the same integers); sorted by x, the active
    # edges pair up into the spans [round(x_left), floor(x_right)]
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), h)):
        act = (y0 <= y) & (y < y1)
        xs = np.sort(x0[act] + (y - y0[act]) * dx[act])
        for xl, xr in zip(xs[0::2], xs[1::2]):
            a, b = (int(xl) + (XY_ONE >> 1)) >> XY_SHIFT, int(xr) >> XY_SHIFT
            if a < w and b >= 0:
                img[y, max(a, 0) : min(b, w - 1) + 1] = color
    return img


def distance_l1(chain: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(255 - chain, cv2.DIST_L1, 3): the taxicab
    distance of every pixel to the nearest nonzero pixel of `chain`, as
    float32; FLT_MAX everywhere when `chain` has none."""
    from scipy import ndimage

    if not chain.any():
        return np.full(chain.shape, FLT_MAX, np.float32)
    return ndimage.distance_transform_cdt(chain == 0, metric="taxicab").astype(np.float32)


def _sobel(gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """cv2.Sobel(gray, CV_16S, 1, 0 / 0, 1, ksize=3, BORDER_REPLICATE) as int32."""
    p = np.pad(gray.astype(np.int32), 1, mode="edge")
    h, w = gray.shape
    s = lambda dy, dx: p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]  # noqa: E731
    gx = (s(-1, 1) - s(-1, -1)) + 2 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    gy = (s(1, -1) - s(-1, -1)) + 2 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    return gx, gy


def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """cv2.Canny(gray, low, high) (aperture 3, L1 gradient) on a 2-D uint8
    image: uint8, 255 on the edges."""
    from scipy import ndimage

    h, w = gray.shape
    gx, gy = _sobel(gray)
    mag = np.abs(gx) + np.abs(gy)
    lo, hi = int(np.floor(low)), int(np.floor(high))
    m = np.pad(mag, 1)  # zero magnitude outside the image

    def at(dy, dx):
        return m[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ax = np.abs(gx).astype(np.int64)
    ay = np.abs(gy).astype(np.int64) << CANNY_SHIFT
    tg22 = ax * TG22
    tg67 = tg22 + (ax << (CANNY_SHIFT + 1))
    horizontal = ay < tg22
    vertical = ~horizontal & (ay > tg67)
    same_sign = (gx ^ gy) >= 0
    keep = np.where(
        horizontal, (mag > at(0, -1)) & (mag >= at(0, 1)),
        np.where(vertical, (mag > at(-1, 0)) & (mag >= at(1, 0)),
                 np.where(same_sign, (mag > at(-1, -1)) & (mag > at(1, 1)),
                          (mag > at(-1, 1)) & (mag > at(1, -1)))))
    weak = keep & (mag > lo)
    # hysteresis: the 8-connected components of the candidates that hold a
    # pixel above the high threshold
    labels, n = ndimage.label(weak, structure=np.ones((3, 3), bool))
    strong = np.zeros(n + 1, bool)
    strong[labels[weak & (mag > hi)]] = True
    strong[0] = False
    return (strong[labels] * 255).astype(np.uint8)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """PIL's Image.convert("L") of an (H, W, 3) uint8 array."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
