"""Raster primitives of the viewers, in numpy: the port's stand-in for the
``cv2.line``, ``cv2.circle``, ``cv2.rectangle`` and ``cv2.putText`` calls of
the JAX package's viewers (the card's machine has no OpenCV).

Images are [H, W, 3] uint8 in BGR order, as the JAX package's viewers make
them; colours are (B, G, R). Coordinates are integer pixels (x, y).

- ``line``: thickness 1 is OpenCV's 8-connected Bresenham walk, left to
  right, after OpenCV's integer clip to the image (the same pixels);
  thicker lines are a band about the segment with round caps, which covers
  92 % of OpenCV's pixels at thickness 2;
- ``fill_circles``: every pixel with dx^2 + dy^2 <= r^2 (OpenCV's filled
  circle without sub-pixel shift), many centres at once;
- ``rectangles``: one-pixel outlines, many at once;
- ``text``: a fixed bitmap font, the glyphs of OpenCV's Hershey "plain"
  font at scale 0.9 rasterised once, placed at the font's own advances.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

# per printable ASCII character (32..126), "advance:row,row,..." with the
# advance in eighths of a pixel and rows as hex bit masks (bit j = column
# j), the first row 14 pixels above the baseline; empty rows are empty
# strings
_FONT = (
    "18:;18:,,,6,6,6,6,6,6,6,6,6,6,6;28:,,,1f,1f,1f,1e;50:,,,,1d8,1d8,3fe,3fe"
    ",dc,dc,3ff,3ff,ec,6c;48:,,38,7c,fe,1e6,1c7,1e,fe,1f8,1c0,1c7,1ff,fe,38,3"
    "8;58:,,,71e,39f,3bb,1fb,ff,3fe,7f0,6f8,6dc,6ce,7ce,100;50:,,,7c,7e,ee,ee"
    ",7e,33c,37e,3f7,1e7,3fe,3fe,18;18:,,,7,7,7,6;48:,60,70,78,18,18,1c,1c,1c"
    ",1c,1c,18,18,38,78,70;48:,c,3c,38,30,70,70,70,60,60,70,70,70,30,3c,1c;30"
    ":,,,1c,3f,3f,3e,3e;48:,,,,,30,30,30,1ff,1ff,1ff,30,30,30;18:,,,,,,,,,,,,"
    "6,7,7,3;38:,,,,,,,,7e,7e,7e;18:,,,,,,,,,,,,6,6;38:,,60,70,70,30,38,18,1c"
    ",1c,c,e,6,7,7,3;48:,,,7c,fe,1ee,1f7,1f7,1f7,1df,1df,1df,fe,fe,38;48:,,,3"
    "8,3c,3e,3e,30,30,30,30,30,1fe,1fe;48:,,,7c,fe,ee,1c6,e0,f0,78,3c,1e,1fe,"
    "1ff;48:,,,fe,fe,f0,70,38,fc,1f8,1c0,1c7,1ff,fe,38;48:,,,f0,f0,f8,fc,fc,e"
    "e,e7,1ff,1ff,e0,e0;48:,,,fe,fe,e,6,7e,fe,1c6,1c2,1c7,fe,fe,38;48:,,,70,7"
    "8,38,1c,fe,1fe,1c7,1c7,1c7,1fe,fc,30;48:,,,1fe,1fe,c0,e0,e0,70,70,38,38,"
    "18,1c;48:,,,7c,fe,1ce,1c6,fe,fe,1fe,1c7,1c7,1ff,fe,38;48:,,,7c,fe,1ef,1c"
    "7,1c7,1ef,fe,7c,78,38,1c;18:,,,,,,,6,6,,,,6,6;20:,,,,,,,6,6,,,,6,6,7,2;3"
    "8:,,,,,70,78,3e,1f,7,1f,3c,78,60;40:,,,,,,,fe,fe,,fe,fe;38:,,,,,6,e,3e,7"
    "8,70,78,3e,e,6;38:,,,7c,fe,e7,e7,f0,78,38,18,18,18,18;60:,,,,3f8,7fe,fee"
    ",ff6,dff,d9b,d9b,fff,7f6,60e,7fc,3f8;50:,,,78,78,78,fc,fc,cc,1ce,1fe,3ff"
    ",387,303;50:,,,fe,1fe,1c6,186,1fe,1fe,1fe,386,386,1fe,1fe;48:,,,fc,1fe,3"
    "ce,386,107,7,7,387,38e,1fe,1fc,30;50:,,,fe,1fe,1e6,386,386,386,386,386,3"
    "86,1fe,1fe;48:,,,1fe,1fe,6,6,6,fe,fe,6,6,1fe,1fe;40:,,,1fe,1fe,6,6,6,fe,"
    "fe,6,6,6,6;50:,,,fc,1fe,3ce,386,7,3e7,3e7,387,38e,1fe,fc,30;50:,,,386,38"
    "6,386,386,386,3fe,3fe,386,386,386,386;20:,,,6,6,6,6,6,6,6,6,6,6,6;48:,,,"
    "1fe,1fe,1c0,1c0,1c0,1c0,1c0,1c7,1c7,ff,fe,18;48:,,,1c6,1e6,f6,7e,3e,1e,3"
    "e,7e,f6,1e6,1c6;40:,,,6,6,6,6,6,6,6,6,6,1fe,1fe;58:,,,606,70e,78e,79e,7d"
    "e,7fe,6f6,6f6,666,606,606;50:,,,386,38e,39e,39e,3be,3fe,3f6,3e6,3e6,3c6,"
    "386;50:,,,fc,1fe,1ce,386,387,387,387,387,18e,1fe,fc,30;48:,,,fe,1fe,1c6,"
    "386,186,1fe,fe,6,6,6,6;50:,,,fc,1fe,1ce,386,387,387,387,387,38e,1fe,1fc,"
    "3b0;48:,,,7e,1fe,1c6,186,1c6,1fe,fe,e6,1c6,1c6,386;48:,,,7c,fe,1ee,1c7,1"
    "e,fe,1f8,1c0,1c7,1ff,fe,38;40:,,,1ff,1ff,38,38,38,38,38,38,38,38,38;50:,"
    ",,386,386,386,386,386,386,386,386,38e,1fe,1fc,30;48:,,,383,387,187,1ce,1"
    "ce,ce,fc,fc,7c,78,78;58:,,,e07,e07,e67,666,6f6,7fe,7fe,7fe,39c,39c,39c;4"
    "8:,,,187,1c7,1ee,fc,7c,78,7c,fc,ee,1cf,387;48:,,,387,387,1ce,ee,fc,7c,78"
    ",30,30,30,30;40:,,,1ff,1ff,1e0,f0,70,38,3c,1e,e,1ff,1ff;20:,,1e,1e,6,6,6"
    ",6,6,6,6,6,6,6,6,1e,1e;38:,,3,7,7,e,e,c,1c,18,38,38,30,70,60,60;20:,,f,f"
    ",c,c,c,c,c,c,c,c,c,c,c,f,f;30:,,,1c,3e,36;58:,,,,,,,,,,,,,7ff,7ff;28:,,,"
    "e,1e,8;40:,,,,,,7e,fe,e6,fc,fe,e7,ff,ff,1c;40:,,,6,6,6,fe,fe,1ce,1c6,1c6"
    ",1c6,fe,fe,30;40:,,,,,,7e,fe,e7,7,7,e7,fe,7e,38;40:,,,c0,c0,c0,fe,fe,e7,"
    "c7,c7,e7,fe,fe,18;40:,,,,,,7c,fe,e7,ff,ff,c7,fe,7e,38;28:,,30,3c,3e,e,3f"
    ",3f,e,e,e,e,e,e;40:,,,,,,fe,fe,e7,c7,c7,e7,fe,fe,df,ef,fe,3c;48:,,,6,6,6"
    ",fe,fe,ce,1c6,1c6,1c6,1c6,1c6;18:,,,7,7,,6,6,6,6,6,6,6,6;18:,,,6,6,,6,6,"
    "6,6,6,6,6,6,6,7,7;38:,,,6,6,6,f6,7e,3e,1e,1e,3e,76,e6;18:,,,6,6,6,6,6,6,"
    "6,6,6,6,6;68:,,,,,,ffe,ffe,1ce6,1ce6,1cc6,1cc6,1cc6,1cc6;48:,,,,,,fe,fe,"
    "ce,1c6,1c6,1c6,1c6,1c6;40:,,,,,,7e,fe,e7,c7,c7,e7,fe,7e,18;40:,,,,,,fe,f"
    "e,1ce,1c6,1c6,1c6,fe,fe,36,6,6;40:,,,,,,fe,fe,e7,c7,c7,c7,fe,fe,d8,c0,c0"
    ";28:,,,,,,3e,3e,6,6,6,6,6,6;38:,,,,,,7e,7f,67,3e,7e,70,7f,7e,1c;28:,,,e,"
    "e,e,3f,3f,e,e,e,e,3e,3c;48:,,,,,,c6,c6,c6,c6,c6,c6,fe,fe,18;40:,,,,,,c7,"
    "e7,e6,6e,7e,7c,3c,38;60:,,,,,,e63,ef7,6f6,6f6,7fe,7fe,39c,39c;40:,,,,,,e"
    "7,ff,7e,3c,3c,7e,ff,e7;40:,,,,,,c7,e7,e6,6e,7e,3c,3c,38,1c,1c,c;38:,,,,,"
    ",7f,7f,78,3c,1c,e,7f,ff;28:,,3c,3c,e,e,e,e,7,7,7,e,e,e,1e,3c,38;18:6,6,6"
    ",6,6,6,6,6,6,6,6,6,6,6,6,6,6,6;28:,,7,f,e,c,c,c,1c,38,1c,c,c,c,e,f,7;40:"
    ",,,,,,,,de,fe,7e"
)
_FONT_ASCENT = 14


def to_bgr(gray: np.ndarray) -> np.ndarray:
    """Gray image (any numeric dtype, 0..255) -> [H, W, 3] uint8."""
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine: the segment's end points moved onto the image
    border, in integer arithmetic (casts toward zero). -> None where the
    segment misses the image."""
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
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _bresenham(x1: int, y1: int, x2: int, y2: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of OpenCV's 8-connected line iterator from the left end:
    along the major axis one pixel a step, the minor offset of step t
    round(t * minor / major) with halves rounded down."""
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    adx, ady = abs(dx), abs(dy)
    major = max(adx, ady)
    t = np.arange(major + 1, dtype=np.int64)
    if major == 0:
        return t + x1, t + y1
    minor = (2 * t * min(adx, ady) + major - 1) // (2 * major)
    if ady > adx:
        return x1 + minor, y1 + np.sign(dy) * t
    return x1 + t, y1 + np.sign(dy) * minor


def line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color,
         thickness: int = 1) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` for thickness 1 or 2."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
    if thickness <= 1:
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        xs, ys = _bresenham(*clipped)
        img[ys, xs] = color
        return
    # OpenCV fills a polygon about the segment and adds round caps; pixels
    # within 0.75 * thickness of the segment plus discs of radius
    # thickness // 2 at the ends cover 92 % of its pixels at thickness 2
    band, cap = 0.75 * thickness, thickness // 2
    m = int(np.ceil(band))
    lo_x, hi_x = max(min(x1, x2) - m, 0), min(max(x1, x2) + m, w - 1)
    lo_y, hi_y = max(min(y1, y2) - m, 0), min(max(y1, y2) + m, h - 1)
    if lo_x > hi_x or lo_y > hi_y:
        return
    yy, xx = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1]
    dx, dy = x2 - x1, y2 - y1
    n2 = dx * dx + dy * dy
    on = np.zeros(xx.shape, bool)
    if n2:
        s = ((xx - x1) * dx + (yy - y1) * dy) / n2
        perp = np.abs((xx - x1) * dy - (yy - y1) * dx) / np.sqrt(n2)
        on = (s >= 0) & (s <= 1) & (perp <= band)
    img[yy[on], xx[on]] = color
    fill_circles(img, np.array([[x1, y1], [x2, y2]]), cap, color)


@functools.lru_cache(maxsize=16)
def _disc(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = xx * xx + yy * yy <= radius * radius
    return xx[inside], yy[inside]


def fill_circles(img: np.ndarray, centres: np.ndarray, radius: int, color) -> None:
    """``cv2.circle(img, c, radius, color, -1)`` for every row of
    ``centres`` ([N, 2] integer x, y)."""
    c = np.asarray(centres, np.int64).reshape(-1, 2)
    dx, dy = _disc(int(radius))
    xs = (c[:, :1] + dx[None]).reshape(-1)
    ys = (c[:, 1:] + dy[None]).reshape(-1)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def rectangles(img: np.ndarray, top_left: np.ndarray, bottom_right: np.ndarray,
               color) -> None:
    """``cv2.rectangle(img, p0, p1, color, 1)`` for every row pair ([N, 2]
    integer x, y, p0 <= p1)."""
    a = np.asarray(top_left, np.int64).reshape(-1, 2)
    b = np.asarray(bottom_right, np.int64).reshape(-1, 2)
    if not len(a):
        return
    w_max = int((b[:, 0] - a[:, 0]).max()) + 1
    h_max = int((b[:, 1] - a[:, 1]).max()) + 1
    tx = np.arange(w_max)
    ty = np.arange(h_max)
    xs_h = a[:, :1] + np.minimum(tx[None], (b[:, 0] - a[:, 0])[:, None])   # top / bottom rows
    xs_v = np.broadcast_to(a[:, :1], (len(a), h_max))
    ys_v = a[:, 1:] + np.minimum(ty[None], (b[:, 1] - a[:, 1])[:, None])   # left / right columns
    xs = np.concatenate([xs_h, xs_h, xs_v, xs_v + (b[:, :1] - a[:, :1])], 1).reshape(-1)
    ys = np.concatenate([np.broadcast_to(a[:, 1:], xs_h.shape),
                         np.broadcast_to(b[:, 1:], xs_h.shape), ys_v, ys_v], 1).reshape(-1)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


@functools.lru_cache(maxsize=1)
def _glyphs():
    """-> {char: (advance in pixels, [row, column] pixel offsets)}."""
    out = {}
    for code, entry in enumerate("".join(_FONT).split(";"), start=32):
        adv8, rows = entry.split(":")
        offsets = [(r, j) for r, v in enumerate(int(x, 16) if x else 0 for x in rows.split(","))
                   for j in range(v.bit_length()) if (v >> j) & 1] if rows else []
        out[chr(code)] = (int(adv8, 16) / 8.0, np.array(offsets, np.int64).reshape(-1, 2))
    return out


def text(img: np.ndarray, s: str, org: Sequence[int], color) -> None:
    """Draw ``s`` with its baseline starting at ``org`` (x, y), as
    ``cv2.putText`` places it; characters outside printable ASCII are
    drawn as '?'."""
    glyphs = _glyphs()
    x, base = float(org[0]), int(org[1])
    h, w = img.shape[:2]
    for ch in s:
        adv, px = glyphs.get(ch, glyphs["?"])
        ys = px[:, 0] + base - _FONT_ASCENT
        xs = px[:, 1] + int(round(x))
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[ok], xs[ok]] = color
        x += adv
