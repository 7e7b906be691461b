"""Baseline JPEG writing without OpenCV: the port's ``cv2.imwrite`` of a
``.jpg`` (the live viewer publishes ``latest_frame.jpg`` and
``latest_map.jpg`` for a dashboard to poll).

What it writes: baseline sequential DCT (SOF0), JFIF, 8-bit samples; gray
[H, W] uint8 as one component, BGR [H, W, 3] uint8 as Y, Cb, Cr without
subsampling (4:4:4, every component one 8x8 block per MCU); the IJG
quantisation tables of ITU-T T.81 Annex K.1 scaled by ``quality`` as libjpeg
scales them (OpenCV's default quality is 95); the Huffman tables of Annex
K.3. Any baseline decoder reads it.

Everything is numpy and vectorised over the image: the level shift, the
8x8 orthonormal DCT as two matrix products, the quantisation, the zig-zag
order, the symbols of all blocks at once (DC differences, runs of zeros
with ZRL and EOB), and the bit stream packed with ``np.packbits`` and
byte-stuffed.

``decode`` reads such files back (baseline, 1x1 sampling): a symbol at a
time through 16-bit lookup tables, then the inverse DCT of all blocks.
"""
from __future__ import annotations

import functools
import os
import struct

import numpy as np

# ITU-T T.81 Annex K.1, in row order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# ITU-T T.81 Annex K.3: (code counts by length 1..16, symbols)
_DC_VALUES = bytes(range(12))
_HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], _DC_VALUES),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], _DC_VALUES),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}
_EOB, _ZRL = 0x00, 0xF0


@functools.lru_cache(maxsize=1)
def _zigzag() -> np.ndarray:
    """Row-order index of each zig-zag position."""
    k = np.arange(64)
    i, j = k // 8, k % 8
    s = i + j
    return np.lexsort((np.where(s % 2, i, -i), s))


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II: JPEG's FDCT is C X C^T."""
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


@functools.lru_cache(maxsize=8)
def _codes(name: str):
    """Canonical Huffman codes of a table. -> (code [256], length [256])."""
    counts, values = _HUFFMAN[name]
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[values[k]] = code
            len_of[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table (row order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _bit_size(a: np.ndarray) -> np.ndarray:
    """Bits of |a| (0 for 0): JPEG's magnitude category."""
    a = np.abs(a)
    size = np.zeros(a.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The size low bits that follow a category: v, or v - 1 for v < 0."""
    return np.where(v >= 0, v, v - 1) & ((np.int64(1) << size) - 1)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H/8 * W/8, 8, 8] in raster order of the blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _entropy_code(zz: np.ndarray, comp: np.ndarray, table: np.ndarray, tables) -> bytes:
    """Huffman-code quantised blocks in scan order. zz: [N, 64] zig-zag
    coefficients; comp: [N] the component of each block (its DC
    predictor); table: [N] which (DC, AC) table pair of ``tables`` it takes.
    -> the byte-stuffed entropy-coded segment."""
    n = zz.shape[0]
    dc_code = np.stack([_codes(t[0])[0] for t in tables])
    dc_len = np.stack([_codes(t[0])[1] for t in tables])
    ac_code = np.stack([_codes(t[1])[0] for t in tables])
    ac_len = np.stack([_codes(t[1])[1] for t in tables])

    # DC: the difference to the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    size = _bit_size(diff)
    keys = [np.arange(n) * 256]
    vals = [(dc_code[table, size] << size) | _extra_bits(diff, size)]
    nbits = [dc_len[table, size] + size]

    # AC: (run, size) symbols, ZRL for every 16 zeros, EOB after the last
    blk, pos = np.nonzero(zz[:, 1:])
    k = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    v = zz[blk, k]
    size = _bit_size(v)
    sym = ((run % 16) << 4) | size
    c = table[blk]
    keys.append(blk * 256 + 2 * k)
    vals.append((ac_code[c, sym] << size) | _extra_bits(v, size))
    nbits.append(ac_len[c, sym] + size)
    n_zrl = run // 16
    zrl_of = np.repeat(np.arange(len(blk)), n_zrl)
    keys.append(blk[zrl_of] * 256 + 2 * k[zrl_of] - 1)
    vals.append(ac_code[c[zrl_of], _ZRL])
    nbits.append(ac_len[c[zrl_of], _ZRL])
    eob = np.flatnonzero(zz[:, 63] == 0)
    keys.append(eob * 256 + 255)
    vals.append(ac_code[table[eob], _EOB])
    nbits.append(ac_len[table[eob], _EOB])

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    nbits = np.concatenate(nbits)[order]

    # pack: every item's bits, most significant first; pad the last byte
    # with ones
    total = int(nbits.sum())
    item = np.repeat(np.arange(len(nbits)), nbits)
    starts = np.cumsum(nbits) - nbits
    shift = nbits[item] - 1 - (np.arange(total) - starts[item])
    bits = ((vals[item] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    data = np.packbits(bits)
    # byte stuffing: a 0x00 after every 0xFF
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """Gray [H, W] or BGR [H, W, 3] uint8 -> baseline JPEG file bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape} as JPEG")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG takes 1 to 65535 rows and columns, got {h}x{w}")
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes = [x]
    else:
        b, g, r = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    # pad to whole blocks by repeating the last row and column
    ph, pw = (-h) % 8, (-w) % 8
    planes = [np.pad(p, ((0, ph), (0, pw)), mode="edge") for p in planes]
    qt = [quant_table(_Q_LUMA, quality), quant_table(_Q_CHROMA, quality)]
    c = _dct_matrix()
    zz_order = _zigzag()
    coded = []
    for i, p in enumerate(planes):
        blocks = c @ (_blocks(p) - 128.0) @ c.T
        q = qt[min(i, 1)]
        coded.append(np.round(blocks.reshape(-1, 64) / q).astype(np.int64)[:, zz_order])
    nc = len(planes)
    # scan order: one block of each component per MCU
    zz = np.stack(coded, axis=1).reshape(-1, 64)
    comp = np.tile(np.arange(nc), zz.shape[0] // nc)
    tables = [("dc_luma", "ac_luma"), ("dc_chroma", "ac_chroma")]

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HHBB", 1, 1, 0, 0))]
    out.append(_segment(0xFFDB, b"".join(
        bytes([t]) + bytes(qt[t][zz_order].astype(np.uint8)) for t in range(min(nc, 2)))))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, 0x11, min(i, 1)]) for i in range(nc))))
    dht = b""
    for t in range(min(nc, 2)):
        for cls, name in ((0, tables[t][0]), (1, tables[t][1])):
            counts, values = _HUFFMAN[name]
            dht += bytes([(cls << 4) | t]) + bytes(counts) + values
    out.append(_segment(0xFFC4, dht))
    out.append(_segment(0xFFDA, bytes([nc]) + b"".join(
        bytes([i + 1, (min(i, 1) << 4) | min(i, 1)]) for i in range(nc)) + b"\x00\x3f\x00"))
    out.append(_entropy_code(zz, comp, np.minimum(comp, 1), tables))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _huffman_lut(counts, values):
    """-> (symbol, code length) for every 16-bit window starting with a code
    of the table (length 0 where no code starts)."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for ln, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - ln)
            sym[lo:lo + (1 << (16 - ln))] = values[k]
            length[lo:lo + (1 << (16 - ln))] = ln
            code += 1
            k += 1
        code <<= 1
    return sym, length


def decode(data: bytes) -> np.ndarray:
    """Baseline JPEG of the kind ``encode`` writes (SOF0, 8-bit, every
    component sampled 1x1, no restart markers) -> gray [H, W] or BGR
    [H, W, 3] uint8; raises ``ValueError`` on anything else. The reading
    check of the published files where no OpenCV is installed."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt, huff, comps = {}, {}, []
    i = 2
    while True:
        marker, length = struct.unpack(">HH", data[i:i + 4])
        body = data[i + 4:i + 2 + length]
        i += 2 + length
        if marker == 0xFFDB:
            j = 0
            while j < len(body):
                if body[j] >> 4:
                    raise ValueError("16-bit quantisation tables are not read")
                qt[body[j] & 15] = np.frombuffer(body[j + 1:j + 65], np.uint8).astype(np.float64)
                j += 65
        elif marker == 0xFFC4:
            j = 0
            while j < len(body):
                counts = list(body[j + 1:j + 17])
                n = sum(counts)
                huff[body[j] >> 4, body[j] & 15] = _huffman_lut(counts, body[j + 17:j + 17 + n])
                j += 17 + n
        elif marker == 0xFFC0:
            _, h, w, nc = struct.unpack(">BHHB", body[:6])
            comps = [tuple(body[6 + 3 * c:9 + 3 * c]) for c in range(nc)]
            if any(c[1] != 0x11 for c in comps):
                raise ValueError("only 1x1 sampling is read")
        elif marker == 0xFFDA:
            scan = [(body[2 + 2 * c] >> 4, body[2 + 2 * c] & 15) for c in range(body[0])]
            break
        elif marker in (0xFFC1, 0xFFC2, 0xFFC3, 0xFFDD):
            raise ValueError(f"marker {marker:#x} is not read (baseline only)")
    end = data.rindex(b"\xff\xd9")
    raw = np.frombuffer(data[i:end], np.uint8)
    raw = np.delete(raw, np.flatnonzero((raw[:-1] == 0xFF) & (raw[1:] == 0)) + 1)
    bits = np.unpackbits(raw).astype(np.int64)
    bits = np.concatenate([bits, np.ones(32, np.int64)])
    # the 16-bit window at every bit position
    win = np.zeros(len(bits) - 16, np.int64)
    for k in range(16):
        win = (win << 1) | bits[k:k + len(win)]
    win = win.tolist()

    nc = len(comps)
    by, bx = -(-h // 8), -(-w // 8)
    coef = np.zeros((by * bx, nc, 64), np.int64)
    pred = [0] * nc
    pos = 0
    luts = [(huff[0, td][0].tolist(), huff[0, td][1].tolist(),
             huff[1, ta][0].tolist(), huff[1, ta][1].tolist()) for td, ta in scan]

    def extend(v, size):
        return v if v >= 1 << (size - 1) else v - (1 << size) + 1

    for b in range(by * bx):
        for c in range(nc):
            dc_sym, dc_len, ac_sym, ac_len = luts[c]
            window = win[pos]
            size = dc_sym[window]
            pos += dc_len[window]
            if size:
                pred[c] += extend(win[pos] >> (16 - size), size)
                pos += size
            out = coef[b, c]
            out[0] = pred[c]
            k = 1
            while k < 64:
                window = win[pos]
                sym = ac_sym[window]
                pos += ac_len[window]
                run, size = sym >> 4, sym & 15
                if size == 0:
                    if run == 15:
                        k += 16
                        continue
                    break
                k += run
                out[k] = extend(win[pos] >> (16 - size), size)
                pos += size
                k += 1
    zz = _zigzag()
    c_mat = _dct_matrix()
    planes = []
    for c in range(nc):
        blocks = np.zeros((by * bx, 64))
        blocks[:, zz] = coef[:, c] * qt[comps[c][2]]
        pix = c_mat.T @ blocks.reshape(-1, 8, 8) @ c_mat + 128.0
        planes.append(pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
                      [:h, :w])
    if nc == 1:
        return np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    bgr = np.stack([y + 1.772 * cb, y - 0.344136 * cb - 0.714136 * cr, y + 1.402 * cr], -1)
    return np.clip(np.round(bgr), 0, 255).astype(np.uint8)


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def imwrite(path: str, img: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, quality))


def imwrite_atomic(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write through a temporary file in the same directory and rename it
    into place, so that a reader polling ``path`` never sees half a file."""
    tmp = os.path.join(os.path.dirname(path) or ".", f".{os.path.basename(path)}.tmp")
    imwrite(tmp, img, quality)
    os.replace(tmp, path)
