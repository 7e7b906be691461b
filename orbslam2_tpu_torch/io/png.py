"""PNG reading and writing without OpenCV: the port's ``cv2.imread`` and
``cv2.imwrite`` for the dataset readers.

The TUM, KITTI and EuRoC sequences are PNG files: 8-bit gray (KITTI, EuRoC),
8-bit colour (TUM's rgb/) and 16-bit gray (TUM's depth/). The reader decodes
non-interlaced PNG of bit depth 8 in gray, RGB and RGBA, and of bit depth 16
in gray; any other kind (palette, gray with alpha, interlaced, other depths)
raises ``ValueError``. Arrays come out as ``cv2.imread`` gives them:

- ``imread(path)`` (``cv2.IMREAD_UNCHANGED``): gray [H, W] uint8 or uint16,
  colour [H, W, 3] in BGR order, RGBA [H, W, 4] in BGRA order;
- ``imread(path, gray=True)`` (``cv2.IMREAD_GRAYSCALE``): [H, W] uint8; a
  16-bit image keeps its high byte and a colour one goes through libpng's
  ``png_set_rgb_to_gray`` with OpenCV's weights (0.299, 0.587), which is
  ``(9797 R + 19234 G + 3737 B) >> 15``, alpha dropped;
- ``None`` where the file cannot be opened, as ``cv2.imread``.

The zlib stream is inflated by the standard library. The rows' filters are
undone by ``csrc/png_unfilter.cpp``, built with g++ at first use into
``_build/libpngunfilter.so``: Average and Paeth rows are sequential along
the row, which a Python loop makes a second per 640x480 frame. A failed
build raises; ``unfilter_plain`` (numpy) is the plain version the tests hold
it against and nothing calls it on the reading path.

``imwrite`` writes filter-0 (None) rows through ``zlib.compress``; gray
uint8 and uint16, BGR and BGRA uint8, as ``cv2.imwrite`` takes them.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from orbslam2_tpu_torch.utils.native_build import build_shared_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "png_unfilter.cpp")
LIB_PATH = os.path.join(_PKG_DIR, "_build", "libpngunfilter.so")
ABI_VERSION = 1

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587) in 15-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B = 9797, 19234, 3737

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile ``csrc/png_unfilter.cpp`` into ``_build/libpngunfilter.so``;
    -> its path. Raises with the compiler's output when the build fails."""
    return build_shared_library(SOURCE, LIB_PATH, force=force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.png_abi_version.restype = ctypes.c_int
            lib.png_abi_version.argtypes = []
            if lib.png_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{LIB_PATH}: ABI {lib.png_abi_version()}, "
                                   f"expected {ABI_VERSION}")
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64]
            _lib = lib
    return _lib


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Inflated scanlines (``height`` rows of a filter byte and ``stride``
    bytes) -> the [height, stride] uint8 image bytes, by the C++ library."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = _load().png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {src[(bad - 1) * (stride + 1)]}")
    return out


def unfilter_plain(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """numpy version of ``unfilter`` (slow: a loop over the pixels of every
    Average or Paeth row). ``stride`` is a whole number of pixels."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        cur = np.zeros(stride + bpp, np.int32)     # bpp leading zeros: the left of pixel 0
        if ftype == 0:
            cur[bpp:] = line
        elif ftype == 1:
            # Sub is a running sum along each byte lane of the pixels
            cur[bpp:] = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur[bpp:] = (line + prev) & 255
        elif ftype in (3, 4):
            up = np.concatenate([np.zeros(bpp, np.int32), prev])
            for i in range(bpp, stride + bpp, bpp):
                left, above = cur[i - bpp:i], up[i:i + bpp]
                if ftype == 3:
                    pred = (left + above) >> 1
                else:
                    corner = up[i - bpp:i]
                    p = left + above - corner
                    pa, pb, pc = np.abs(p - left), np.abs(p - above), np.abs(p - corner)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, above, corner))
                cur[i:i + bpp] = (line[i - bpp:i] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur[bpp:]
        prev = cur[bpp:]
    return out


def _chunks(data: bytes):
    """-> (type, body) for every chunk; raises on a bad signature or CRC."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def decode(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG file bytes -> image array as ``imread`` gives it (see the module
    docstring)."""
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace != 0:
        raise ValueError("interlaced PNG is not supported")
    if color not in _CHANNELS or depth not in (8, 16) or (depth == 16 and color != 0):
        raise ValueError(f"PNG of colour type {color} and bit depth {depth} is not "
                         "supported (8-bit gray, RGB or RGBA, or 16-bit gray)")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    rows = unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(height, width)
        return (img >> 8).astype(np.uint8) if gray else img
    img = rows.reshape(height, width, ch) if ch > 1 else rows.reshape(height, width)
    if ch == 1:
        return img
    if gray:
        c = img.astype(np.uint32)
        return ((c[..., 0] * _GRAY_R + c[..., 1] * _GRAY_G + c[..., 2] * _GRAY_B)
                >> 15).astype(np.uint8)
    # RGB(A) -> BGR(A), as OpenCV hands colour images out
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:ch]])


def imread(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """The PNG at ``path`` (see the module docstring); None where the file
    cannot be opened."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode(data, gray=gray)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + \
        struct.pack(">I", zlib.crc32(ctype + body))


def encode(img: np.ndarray) -> bytes:
    """Gray uint8/uint16 [H, W], BGR [H, W, 3] or BGRA [H, W, 4] uint8 -> PNG
    file bytes, every row with filter type 0."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color, depth = 0, img.dtype.itemsize * 8
        rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    elif img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        color, depth = (2, 6)[img.shape[2] - 3], 8
        rows = img[..., [2, 1, 0, 3][:img.shape[2]]].reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    scan = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rows).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)) + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
