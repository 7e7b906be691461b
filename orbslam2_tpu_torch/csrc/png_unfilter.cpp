// PNG scanline unfiltering (ISO/IEC 15948, section 9.2) for the port's PNG
// reader (orbslam2_tpu_torch/io/png.py), which stands in for cv2.imread.
//
// Host code, not a device kernel: a decoded PNG is a stream of rows, each a
// filter-type byte followed by the filtered bytes. Sub, Average and Paeth
// rows depend on the byte one pixel to the left in the same row, so a row is
// sequential along its length; libpng's adaptive filtering (what
// cv2.imwrite emits) mixes all five types within one image. A loop in
// Python costs about a second per 640x480 frame; this one is memory-bound.
//
// Built with g++ at first use into orbslam2_tpu_torch/_build/libpngunfilter.so
// and loaded with ctypes. The numpy plain version beside it
// (png.unfilter_plain) is what the tests hold it against.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

}  // namespace

extern "C" int png_abi_version() { return 1; }

// raw: `height` rows of 1 + `stride` bytes (the filter type, then the row);
// out: height * stride bytes; bpp: bytes of one whole pixel (at least 1).
// -> 0, or 1 + the index of the first row whose filter type is not 0..4.
extern "C" int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                                int64_t stride, int64_t bpp) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = raw + y * (stride + 1) + 1;
        const uint8_t type = in[-1];
        uint8_t* cur = out + y * stride;
        const uint8_t* up = y > 0 ? cur - stride : nullptr;
        switch (type) {
        case 0:
            std::memcpy(cur, in, static_cast<size_t>(stride));
            break;
        case 1:
            for (int64_t i = 0; i < stride; ++i)
                cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (int64_t i = 0; i < stride; ++i)
                cur[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (int64_t i = 0; i < stride; ++i) {
                const int left = i >= bpp ? cur[i - bpp] : 0;
                const int above = up ? up[i] : 0;
                cur[i] = static_cast<uint8_t>(in[i] + ((left + above) >> 1));
            }
            break;
        case 4:
            for (int64_t i = 0; i < stride; ++i) {
                const int left = i >= bpp ? cur[i - bpp] : 0;
                const int above = up ? up[i] : 0;
                const int corner = (up && i >= bpp) ? up[i - bpp] : 0;
                cur[i] = static_cast<uint8_t>(in[i] + paeth(left, above, corner));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
