"""Fused per-keypoint orientation + rotated-BRIEF: the Hopper kernel's wrappers
and their plain PyTorch versions.

Counterpart of ``orbslam2_tpu/ops/pallas_orb.py``: the kernel behind
``fused_orient_describe_levels`` (one launch for all pyramid levels of a frame)
and ``fused_orient_describe`` (one level, a table of one entry through the same
kernel) replaces the TPU kernel ``pallas_orb.fused_orient_describe``. It is
CUDA C++ (``csrc/orient_describe.cu``: one warp per output slot, a level table
passed by value, all raw-patch loads of a lane in flight at once, warp-shuffle
moments, ``__ballot_sync`` bit packing). It is bound by bytes on paper; at a
frame's 2000 keypoints one launch lasts as long as its slowest warp's chain of
memory latencies. See the source note in the ``.cu`` file.

The library is built with ``nvcc`` for ``sm_90a`` at first use, from the
sources in ``csrc/`` and nothing else, into ``orbslam2_tpu_torch/_build/``,
and loaded with ``ctypes``. For a CUDA tensor a wrapper launches the kernel
or raises; the plain versions are taken only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

HALF_PATCH = 15
PATCH = 31
MAX_LEVELS = 16
# sizes of the two structs below; csrc/orient_describe.cu pins the same
# numbers with static_assert
LEVEL_ENTRY_BYTES = 56
LEVEL_TABLE_BYTES = 912

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("orient_describe.cu",)
_LIB_NAME = "liborbslam2_kernels.so"

_lib: Optional[ctypes.CDLL] = None


class LevelEntry(ctypes.Structure):
    """``OrientDescribeLevel`` of csrc/orient_describe.cu."""
    _fields_ = [("raw", ctypes.c_void_p), ("blur", ctypes.c_void_p),
                ("ys", ctypes.c_void_p), ("xs", ctypes.c_void_p),
                ("h", ctypes.c_int32), ("w", ctypes.c_int32),
                ("k", ctypes.c_int32), ("budget", ctypes.c_int32),
                ("offset", ctypes.c_int32), ("reserved", ctypes.c_int32)]


class LevelTable(ctypes.Structure):
    """``OrientDescribeTable`` of csrc/orient_describe.cu: what one launch
    needs to know of every level. It lives on the host; the launcher hands it
    to the kernel by value."""
    _fields_ = [("level", LevelEntry * MAX_LEVELS),
                ("n_levels", ctypes.c_int32), ("n_total", ctypes.c_int32),
                ("coord_bytes", ctypes.c_int32), ("reserved", ctypes.c_int32)]


# one LevelEntry in native layout, for filling a table in one call per level
_LEVEL_ENTRY = struct.Struct("4P6i")


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of orbslam2_tpu_torch "
                       "are built from source at first use")


def build_kernels(force: bool = False, ptxas_verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into one shared library; -> its path. Rebuilds
    when a source is newer than the library. ``ptxas_verbose`` prints the
    registers and shared memory ``ptxas`` reports for each kernel."""
    lib_path = os.path.join(_BUILD_DIR, _LIB_NAME)
    srcs = [os.path.join(_CSRC_DIR, s) for s in _SOURCES]
    if not force and os.path.exists(lib_path) and all(
            os.path.getmtime(lib_path) >= os.path.getmtime(s) for s in srcs):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(("-Xptxas", "-v") if ptxas_verbose else ()),
           "-o", tmp_path, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    if ptxas_verbose:
        print(proc.stderr.strip(), flush=True)
    os.replace(tmp_path, lib_path)  # atomic: concurrent builders both succeed
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernels())
        table_p = ctypes.POINTER(LevelTable)
        lib.orient_describe_launch.argtypes = [table_p] + [ctypes.c_void_p] * 4
        lib.orient_describe_launch_empty.argtypes = [table_p] + [ctypes.c_void_p] * 2
        for name in ("orient_describe_launch", "orient_describe_launch_empty",
                     "orient_describe_table_bytes"):
            getattr(lib, name).restype = ctypes.c_int
        if lib.orient_describe_table_bytes() != ctypes.sizeof(LevelTable):
            raise RuntimeError("the level table of csrc/orient_describe.cu and "
                               "LevelTable differ in size")
        _lib = lib
    return _lib


def _check_tensor(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, raw on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pattern(pattern: torch.Tensor, device) -> None:
    if pattern.shape != (256, 2, 2):
        raise ValueError("pattern must be [256, 2, 2]")
    _check_tensor("pattern", pattern, torch.float32, device)
    if pattern.data_ptr() % 16:
        raise ValueError("pattern must be 16-byte aligned")


def build_level_table(raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor],
                      ys: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                      budgets: Sequence[int]) -> LevelTable:
    """Check one frame's levels and fill the table the launcher takes.

    Level ``l`` owns output slots ``offset_l .. offset_l + budgets[l] - 1``
    with ``offset_l = sum(budgets[:l])``; its first ``k_l = len(ys[l])``
    slots are keypoints, the rest are written as zero. Raises on what the
    kernel does not take: a wrong dtype, shape or device, a non-contiguous
    tensor, more keypoints than budget, more than 16 levels."""
    n = len(raws)
    if not (len(blurs) == len(ys) == len(xs) == len(budgets) == n):
        raise ValueError("raws, blurs, ys, xs and budgets must have one entry per level")
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {n}")
    device = raws[0].device
    coord_dtype = ys[0].dtype
    if coord_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ys and xs must be int32 or int64, got {coord_dtype}")
    table = LevelTable()
    f32 = torch.float32
    offset = 0
    for i in range(n):
        raw, blur, y, x, budget = raws[i], blurs[i], ys[i], xs[i], int(budgets[i])
        if raw.dim() != 2 or blur.shape != raw.shape:
            raise ValueError("raw and blur must be [H, W] images of one shape")
        h, w = raw.shape
        if h < PATCH or w < PATCH:
            raise ValueError("level image smaller than the 31x31 patch")
        if y.dim() != 1 or x.shape != y.shape:
            raise ValueError("ys and xs must be [K]")
        k = y.shape[0]
        if k > budget:
            raise ValueError(f"level {i}: {k} keypoints for a budget of {budget}")
        if not (raw.dtype == blur.dtype == f32 and y.dtype == x.dtype == coord_dtype
                and raw.device == blur.device == y.device == x.device == device
                and raw.is_contiguous() and blur.is_contiguous()
                and y.is_contiguous() and x.is_contiguous()):
            for name, t, dtype in (("raw", raw, f32), ("blur", blur, f32),
                                   ("ys", y, coord_dtype), ("xs", x, coord_dtype)):
                _check_tensor(name, t, dtype, device)   # raises, naming the tensor
        _LEVEL_ENTRY.pack_into(table, i * LEVEL_ENTRY_BYTES,
                               raw.data_ptr(), blur.data_ptr(), y.data_ptr(),
                               x.data_ptr(), h, w, k, budget, offset, 0)
        offset += budget
    table.n_levels = n
    table.n_total = offset
    table.coord_bytes = 4 if coord_dtype == torch.int32 else 8
    return table


def _launch(table: LevelTable, pattern: torch.Tensor, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs and launch the kernel once on the current stream."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _load()
    n_total = table.n_total
    angle = torch.empty((n_total,), dtype=torch.float32, device=device)
    desc = torch.empty((n_total, 8), dtype=torch.int32, device=device)
    if n_total == 0:
        return angle, desc
    with torch.cuda.device(device):
        err = lib.orient_describe_launch(
            ctypes.byref(table), pattern.data_ptr(), angle.data_ptr(),
            desc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"orient_describe_launch failed: CUDA error {err}")
    fused_orient_describe.launches += 1
    return angle, desc


def launch_empty_kernel(table: LevelTable, scratch: torch.Tensor) -> None:
    """Measurement aid, not part of the port's path: launch the library's
    empty kernel on the grid ``table`` gives ``fused_orient_describe_levels``,
    for the time no launch of that grid can beat. ``scratch``: any CUDA f32
    tensor. Not counted in ``fused_orient_describe.launches``."""
    _check_tensor("scratch", scratch, torch.float32, scratch.device)
    if scratch.device.type != "cuda":
        raise ValueError(f"unsupported device {scratch.device}")
    with torch.cuda.device(scratch.device):
        err = _load().orient_describe_launch_empty(
            ctypes.byref(table), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"orient_describe_launch_empty failed: CUDA error {err}")


def _moments_plain(raw: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid moments (m10, m01) over the radius-15 disc around
    each (y, x), already clamped inside the margin, in the kernel's order
    (the note in csrc/orient_describe.cu): per column dx = -15..15 the disc's
    rows summed in row order, ``col_sum += v`` and ``m01 = fma(dy, v, m01)``;
    then ``m10 = dx * col_sum``; then the 32 columns (the 32nd empty) halved
    five times, column i adding column i + half. The fused multiply-add is
    taken in float64 and rounded once to float32: ``dy * v`` is exact there,
    and so is its sum with ``m01`` while every pixel is 0 or in [2^-8, 255]
    (the bits then span under 53); below 2^-8 the float64 sum may round
    first, which changes the float32 result only where it lands on a float32
    midpoint. Every other sum and product rounds on its own, so the result
    is the kernel's bit for bit. A pixel outside the disc enters as v = 0,
    which adds exactly nothing: the sums start at +0 and never become -0."""
    w = raw.shape[1]
    off = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=raw.device)
    dyy, dxx = torch.meshgrid(off, off, indexing="ij")          # [31, 31]
    disc = (dxx * dxx + dyy * dyy) <= HALF_PATCH * HALF_PATCH
    idx = (y[:, None, None] + dyy) * w + (x[:, None, None] + dxx)
    patches = raw.reshape(-1)[idx] * disc.to(raw.dtype)          # [K, 31, 31]
    k = patches.shape[0]
    col_sum = torch.zeros(k, 32, dtype=raw.dtype, device=raw.device)
    m01 = torch.zeros(k, 32, dtype=raw.dtype, device=raw.device)
    for r in range(PATCH):
        v = patches[:, r, :]
        col_sum[:, :PATCH] = col_sum[:, :PATCH] + v
        m01[:, :PATCH] = (m01[:, :PATCH].double() + v.double() * float(r - HALF_PATCH)
                          ).to(raw.dtype)
    dx = torch.cat([off, off.new_tensor([HALF_PATCH + 1])]).to(raw.dtype)
    m10 = col_sum * dx
    half = 16
    while half:
        m10 = m10[:, :half] + m10[:, half:2 * half]
        m01 = m01[:, :half] + m01[:, half:2 * half]
        half //= 2
    return m10[:, 0], m01[:, 0]


def fused_orient_describe_plain(raw: torch.Tensor, blur: torch.Tensor,
                                ys: torch.Tensor, xs: torch.Tensor,
                                pattern: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same arithmetic, rounded in
    the same order, in tensor ops (gather 31x31 patches, the moments of
    ``_moments_plain``, rotate, round half to even, index, compare, pack).
    Works on any device; on the card it gives the kernel's outputs bit for
    bit."""
    from orbslam2_tpu_torch.ops.orb import pack_bits

    h, w = raw.shape
    y = ys.long().clamp(HALF_PATCH, h - 1 - HALF_PATCH)
    x = xs.long().clamp(HALF_PATCH, w - 1 - HALF_PATCH)
    m10, m01 = _moments_plain(raw, y, x)

    r2 = m10 * m10 + m01 * m01
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-12))
    degenerate = r2 < 1e-12
    ca = torch.where(degenerate, torch.ones_like(m10), m10 * inv_r)[:, None]
    sa = torch.where(degenerate, torch.zeros_like(m01), m01 * inv_r)[:, None]

    # pattern lanes: a-points then b-points -> [1, 512]
    pdx = torch.cat([pattern[:, 0, 0], pattern[:, 1, 0]])[None, :]
    pdy = torch.cat([pattern[:, 0, 1], pattern[:, 1, 1]])[None, :]
    rx = torch.round(pdx * ca - pdy * sa).long().clamp(-HALF_PATCH, HALF_PATCH)
    ry = torch.round(pdx * sa + pdy * ca).long().clamp(-HALF_PATCH, HALF_PATCH)
    vals = blur.reshape(-1)[(y[:, None] + ry) * w + (x[:, None] + rx)]
    vals = torch.round(torch.clamp(vals, 0.0, 255.0))            # [K, 512]
    bits = vals[:, :256] < vals[:, 256:]
    return torch.atan2(m01, m10), pack_bits(bits)


def fused_orient_describe_levels_plain(
        raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor],
        ys: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
        pattern: torch.Tensor, budgets: Sequence[int]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_orient_describe_levels``: the
    per-level plain version in a loop, each level padded with zeros up to its
    budget, the levels concatenated. Works on any device."""
    angles, descs = [], []
    for raw, blur, y, x, budget in zip(raws, blurs, ys, xs, budgets):
        angle, desc = fused_orient_describe_plain(raw, blur, y, x, pattern)
        pad = int(budget) - y.shape[0]
        if pad < 0:
            raise ValueError(f"{y.shape[0]} keypoints for a budget of {budget}")
        angles.append(F.pad(angle, (0, pad)))
        descs.append(F.pad(desc, (0, 0, 0, pad)))
    return torch.cat(angles), torch.cat(descs)


def fused_orient_describe_levels(
        raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor],
        ys: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
        pattern: torch.Tensor, budgets: Sequence[int]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pyramid levels of one frame in one kernel launch.

    raws/blurs: per level, [H_l, W_l] f32 level image and its blurred twin;
    ys/xs: per level, [K_l] keypoint coords, all int32 or all int64;
    pattern: [256, 2, 2] BRIEF pairs ((a, b) x (dx, dy)); budgets: per level,
    the number of output slots (>= K_l).

    -> (angle [sum(budgets)] f32 radians, desc [sum(budgets), 8] int32
    bit-views of the packed 256-bit descriptors, ``pack_bits`` layout), the
    levels one after another; slots past a level's K_l are zero.
    """
    table = build_level_table(raws, blurs, ys, xs, budgets)
    device = raws[0].device
    _check_pattern(pattern, device)
    if device.type == "cpu":
        return fused_orient_describe_levels_plain(raws, blurs, ys, xs, pattern, budgets)
    return _launch(table, pattern, device)


def fused_orient_describe(raw: torch.Tensor, blur: torch.Tensor,
                          ys: torch.Tensor, xs: torch.Tensor,
                          pattern: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level: a table of one entry through the same kernel.

    raw/blur: [H, W] f32 level images; ys/xs: [K] keypoint coords, both int32
    or both int64; pattern: [256, 2, 2] BRIEF pairs ((a, b) x (dx, dy)).

    -> (angle [K] f32 radians, desc [K, 8] int32 bit-views of the packed
    256-bit descriptors, ``pack_bits`` layout).
    """
    table = build_level_table((raw,), (blur,), (ys,), (xs,), (ys.shape[0],))
    _check_pattern(pattern, raw.device)
    if raw.device.type == "cpu":
        return fused_orient_describe_plain(raw, blur, ys, xs, pattern)
    return _launch(table, pattern, raw.device)


# launches of the CUDA kernel made through either wrapper (read by
# chip_smoke.py): one per frame on the main path
fused_orient_describe.launches = 0
