// Fused per-keypoint orientation + rotated-BRIEF for Hopper (sm_90a): one
// launch for all pyramid levels of a frame.
//
// Replaces the TPU kernel orbslam2_tpu/ops/pallas_orb.py::fused_orient_describe
// (body _kernel, helper _phase_copies). It computes the same function and is
// not a block-by-block translation: the phase-copied images, tile-aligned
// windows, one-hot matrix gather and float bit row of the TPU kernel exist
// only for that machine's alignment rules and matrix unit, and are gone.
//
// Per keypoint:
//   1. intensity-centroid moments m10/m01 over the radius-15 disc
//      (dx^2 + dy^2 <= 225) of the RAW level image;
//   2. cos/sin = m10/r, m01/r via rsqrt(max(r^2, 1e-12)); r^2 < 1e-12 means
//      angle 0; the angle itself is atan2(m01, m10);
//   3. the 256 BRIEF pairs are rotated, the 512 sample offsets rounded half
//      to even, and each pair compared on the BLURRED level image quantised to
//      integer grey, round(clip(I, 0, 255)); bit = val_a < val_b;
//   4. bit b of word w is pair 32*w + b (the pack_bits layout).
//
// What bounds it on this card: bytes on paper (each level image read once
// from device memory, 52 bytes a keypoint; the arithmetic is about 10^4
// operations a keypoint). At a frame's 2000 keypoints and 6.4 MB of images
// that sit in L2 that bound is out of reach: 2000 warps are under a quarter
// of the 8448 the card holds, every warp is resident from the first
// microsecond, and each pulls its own two 31x31 windows (62 rows of 124
// bytes) from L2. The launch then lasts as long as its slowest warp: a chain
// of memory latencies (level table, coordinates, raw patch, blurred samples)
// stretched by all warps drawing on L2 at once. PERF.md has the times.
//
// Design.
// - One launch a frame. The launcher takes a table of up to 16 levels by
//   value (a __grid_constant__ parameter, 912 bytes of the 4 KB parameter
//   space: no copy to the device, no synchronisation). An entry holds the
//   level's image pointers and size, its keypoint coordinates, the count k
//   the extractor selected, its slot budget and the offset of its first
//   slot in the frame-wide outputs. One warp per output slot: it finds its
//   level by walking the offsets (uniform across the warp). A slot past k
//   inside the budget is written as zero, so the outputs need no memset.
// - The moment pass costs one memory latency, not 31. Lane c reads column c
//   of the raw patch (one coalesced 124-byte read per row) and starts all 31
//   loads before it sums the first. Summing each value where it is loaded,
//   inside the disc test, made every load wait for the one before. The sums
//   keep their row order, so no bit changes.
// - The BRIEF gathers go to L1/L2 directly. Copying the keypoint's blurred
//   31x31 window into shared memory with cp.async (4-byte copies, since rows
//   start at arbitrary columns) under the moment pass, with the pattern in
//   the same copy group, was built and timed on the card: it is no faster,
//   because sending 31 more copies a lane costs what the shorter gathers
//   save (PERF.md has both times). The pattern (256 float4, indexed by lane)
//   is read through the read-only path and hits L1 after an SM's first warp.
// - 8 warps a block: 4 and 8 tie on the card and 16 is slower; ptxas reports
//   40 registers and no shared memory, so occupancy does not depend on it.
// - Not TMA: a tensor map needs row pitches that are multiples of 16 bytes,
//   and the level widths (640, 533, 444, 370, ...) are mostly not. A
//   pitched pyramid would change what the extractor hands every other
//   consumer.
// - A butterfly of warp shuffles sums the moments so that every lane holds
//   them, then in round w each lane evaluates pair 32*w + lane and
//   __ballot_sync yields word w. Rotation products use the non-fusing
//   intrinsics so that the rounded offsets agree with the plain PyTorch
//   version of the same function.
// - One order of the moment sums, stated here and repeated by the plain
//   version (ops/cuda_orb.py, _moments_plain): lane c sums column
//   dx = c - 15 of the disc over its rows in row order, col_sum += v and
//   m01 = fma(dy, v, m01), one rounding a step; m10 = dx * col_sum, rounded;
//   then the butterfly halves the 32 lanes five times (lane 31 holds zeros),
//   lane i adding lane i + half. The sums are exact only for integer pixels;
//   resampled levels and float renders round, and a sum in another order
//   moves the angle and may flip a bit. The fma is nvcc's contraction of
//   m01 += dy * v (its default, -fmad=true); m10's product is rounded, as
//   the butterfly sends it. Written out with __fmaf_rn and __fmul_rn, the
//   same order measured slower on the card (PERF.md), so the source leaves
//   it to the compiler, and chip_smoke.py holds kernel and plain version to
//   identical descriptors.
//
// Plain C interface; built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes by orbslam2_tpu_torch/ops/cuda_orb.py, whose
// LevelEntry / LevelTable mirror the two structs below.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct OrientDescribeLevel {
    const float* raw;    // [h, w] level image
    const float* blur;   // [h, w] blurred level image
    const void* ys;      // [k] int32 or int64 (the table's coord_bytes)
    const void* xs;      // [k]
    int32_t h, w;
    int32_t k;           // keypoints selected on this level
    int32_t budget;      // output slots of this level (>= k)
    int32_t offset;      // first slot in the frame-wide outputs
    int32_t reserved;
};

struct OrientDescribeTable {
    OrientDescribeLevel level[16];
    int32_t n_levels;
    int32_t n_total;      // sum of the budgets
    int32_t coord_bytes;  // 4: ys/xs are int32, 8: int64
    int32_t reserved;
};

}  // extern "C"

// ops/cuda_orb.py pins the same sizes (LEVEL_ENTRY_BYTES, LEVEL_TABLE_BYTES).
static_assert(sizeof(OrientDescribeLevel) == 56, "level entry layout");
static_assert(sizeof(OrientDescribeTable) == 912, "level table layout");

namespace {

constexpr int kMaxLevels = 16;
constexpr int kHalfPatch = 15;
constexpr int kPatch = 31;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ float grey(float v) {
    return rintf(fminf(fmaxf(v, 0.0f), 255.0f));
}

__device__ __forceinline__ int load_coord(const void* p, int i, int coord_bytes,
                                          int lo, int hi) {
    const long long v = coord_bytes == 8 ? ((const long long*)p)[i]
                                         : (long long)((const int*)p)[i];
    return (int)min(max(v, (long long)lo), (long long)hi);
}

__global__ void __launch_bounds__(kThreads)
orient_describe_kernel(const __grid_constant__ OrientDescribeTable table,
                       const float4* __restrict__ pattern,  // [256] (ax, ay, bx, by)
                       float* __restrict__ angle,           // [n_total]
                       int* __restrict__ desc) {            // [n_total, 8]
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int slot = blockIdx.x * kWarpsPerBlock + warp;

    if (slot >= table.n_total) return;

    // ---- which level, which keypoint (uniform across the warp) ----
    int lv = 0;
    while (lv + 1 < table.n_levels && slot >= table.level[lv + 1].offset) ++lv;
    const OrientDescribeLevel& level = table.level[lv];
    const int kp = slot - level.offset;
    if (kp >= level.k) {  // padded slot of the level's budget
        if (lane < 8) desc[(size_t)slot * 8 + lane] = 0;
        if (lane == 0) angle[slot] = 0.0f;
        return;
    }

    const int h = level.h;
    const int w = level.w;
    // Valid keypoints keep a 19-pixel margin; invalid slots are moved inside
    // so that no read leaves the image.
    const int y = load_coord(level.ys, kp, table.coord_bytes, kHalfPatch, h - 1 - kHalfPatch);
    const int x = load_coord(level.xs, kp, table.coord_bytes, kHalfPatch, w - 1 - kHalfPatch);

    // ---- the raw patch: 31 independent loads a lane, all in flight at once ----
    // The patch's corner as one 64-bit offset: added to the pointer term by
    // term instead, the launch measured a tenth slower on the card.
    const size_t corner = (size_t)(y - kHalfPatch) * w + (x - kHalfPatch);
    const bool loads = lane < kPatch;  // lane c owns column c of the patch
    const int dx = lane - kHalfPatch;
    float v[kPatch];
    if (loads) {
        const float* p = level.raw + corner + lane;
#pragma unroll
        for (int r = 0; r < kPatch; ++r) v[r] = __ldg(p + (size_t)r * w);
    }

    // ---- moments over the disc of the raw patch, rows in order ----
    // (the order the plain version repeats: see the note above)
    float col_sum = 0.0f;  // sum of the lane's column (for m10)
    float m01 = 0.0f;
    if (loads) {
#pragma unroll
        for (int r = 0; r < kPatch; ++r) {
            const int dy = r - kHalfPatch;
            if (dx * dx + dy * dy <= kHalfPatch * kHalfPatch) {
                col_sum += v[r];
                m01 += (float)dy * v[r];  // one fused multiply-add (see the note)
            }
        }
    }
    float m10 = (float)dx * col_sum;
    for (int off = 16; off > 0; off >>= 1) {
        m10 += __shfl_xor_sync(kFullMask, m10, off);
        m01 += __shfl_xor_sync(kFullMask, m01, off);
    }

    const float r2 = __fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01));
    const float inv_r = rsqrtf(fmaxf(r2, 1e-12f));
    const bool degenerate = r2 < 1e-12f;
    const float ca = degenerate ? 1.0f : __fmul_rn(m10, inv_r);
    const float sa = degenerate ? 0.0f : __fmul_rn(m01, inv_r);

    // ---- rotated BRIEF on the blurred window ----
    const float* b = level.blur + (size_t)y * w + x;
    unsigned my_word = 0;
#pragma unroll
    for (int word = 0; word < 8; ++word) {
        const float4 pt = pattern[word * 32 + lane];
        // x' = dx ca - dy sa ; y' = dx sa + dy ca ; rintf rounds half to even
        int ax = (int)rintf(__fsub_rn(__fmul_rn(pt.x, ca), __fmul_rn(pt.y, sa)));
        int ay = (int)rintf(__fadd_rn(__fmul_rn(pt.x, sa), __fmul_rn(pt.y, ca)));
        int bx = (int)rintf(__fsub_rn(__fmul_rn(pt.z, ca), __fmul_rn(pt.w, sa)));
        int by = (int)rintf(__fadd_rn(__fmul_rn(pt.z, sa), __fmul_rn(pt.w, ca)));
        ax = clampi(ax, -kHalfPatch, kHalfPatch);
        ay = clampi(ay, -kHalfPatch, kHalfPatch);
        bx = clampi(bx, -kHalfPatch, kHalfPatch);
        by = clampi(by, -kHalfPatch, kHalfPatch);
        const float va = grey(b[ay * w + ax]);
        const float vb = grey(b[by * w + bx]);
        const unsigned bits = __ballot_sync(kFullMask, va < vb);
        if (lane == word) my_word = bits;
    }
    if (lane < 8) desc[(size_t)slot * 8 + lane] = (int)my_word;
    if (lane == 0) angle[slot] = atan2f(m01, m10);
}

// Measurement aid, not a kernel of the port: the same grid, block and
// parameter with no work, for the time no launch of this grid can beat.
__global__ void __launch_bounds__(kThreads)
orient_describe_empty_kernel(const __grid_constant__ OrientDescribeTable table,
                             float* __restrict__ angle) {
    if (table.n_total < 0) angle[0] = 0.0f;  // never true: keeps the parameter live
}

int check_table(const OrientDescribeTable* table) {
    if (table->n_levels < 1 || table->n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    if (table->coord_bytes != 4 && table->coord_bytes != 8) return (int)cudaErrorInvalidValue;
    return 0;
}

int blocks_for(int n_total) {
    return (n_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int orient_describe_launch(const OrientDescribeTable* table,
                                      const void* pattern, void* angle,
                                      void* desc, void* stream) {
    if (const int err = check_table(table)) return err;
    if (table->n_total <= 0) return 0;
    orient_describe_kernel<<<blocks_for(table->n_total), kThreads, 0,
                             (cudaStream_t)stream>>>(
        *table, (const float4*)pattern, (float*)angle, (int*)desc);
    return (int)cudaGetLastError();
}

extern "C" int orient_describe_launch_empty(const OrientDescribeTable* table,
                                            void* angle, void* stream) {
    if (const int err = check_table(table)) return err;
    if (table->n_total <= 0) return 0;
    orient_describe_empty_kernel<<<blocks_for(table->n_total), kThreads, 0,
                                   (cudaStream_t)stream>>>(*table, (float*)angle);
    return (int)cudaGetLastError();
}

extern "C" int orient_describe_table_bytes() { return (int)sizeof(OrientDescribeTable); }
