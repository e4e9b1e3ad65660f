// Native host-side image preprocessing for the TPU SfM engine.
//
// The device is fed float32 grayscale arrays; producing them from decoded
// uint8 RGB is host work the reference does through PIL/OpenCV round trips
// (Runner.py:467-548: PIL resize + numpy gray + scale passes, each
// materializing a full image). This single fused pass does
// uint8 RGB -> bilinear resize -> OpenCV-weight grayscale -> [0,1] float32
// with no intermediate buffers, and is the first stage of the host data
// pipeline (decode stays with libjpeg via PIL; see SURVEY.md §2.2 — decode is
// I/O, not compute).
//
// Build: g++ -O3 -march=native -shared -fPIC preprocess.cpp -o libsfmpre.so

#include <cstdint>
#include <cstddef>
#include <algorithm>

extern "C" {

// OpenCV grayscale coefficients (reference Runner.py:467-478).
static const float KR = 0.299f, KG = 0.587f, KB = 0.114f;

// Fused resize+gray: src is HxWx3 uint8 (C-contiguous), dst is OHxOW float32.
// Bilinear with half-pixel centers (cv2.resize convention).
void resize_gray_u8(const uint8_t* src, int h, int w,
                    float* dst, int oh, int ow) {
    const float sy = (float)h / (float)oh;
    const float sx = (float)w / (float)ow;
    for (int oy = 0; oy < oh; ++oy) {
        float fy = ((float)oy + 0.5f) * sy - 0.5f;
        int y0 = (int)fy; if (fy < 0) y0 = 0;
        int y1 = std::min(y0 + 1, h - 1);
        float wy = fy - (float)y0; if (wy < 0) wy = 0;
        const uint8_t* r0 = src + (size_t)y0 * w * 3;
        const uint8_t* r1 = src + (size_t)y1 * w * 3;
        float* out = dst + (size_t)oy * ow;
        for (int ox = 0; ox < ow; ++ox) {
            float fx = ((float)ox + 0.5f) * sx - 0.5f;
            int x0 = (int)fx; if (fx < 0) x0 = 0;
            int x1 = std::min(x0 + 1, w - 1);
            float wx = fx - (float)x0; if (wx < 0) wx = 0;
            const uint8_t* p00 = r0 + (size_t)x0 * 3;
            const uint8_t* p01 = r0 + (size_t)x1 * 3;
            const uint8_t* p10 = r1 + (size_t)x0 * 3;
            const uint8_t* p11 = r1 + (size_t)x1 * 3;
            float g00 = KR * p00[0] + KG * p00[1] + KB * p00[2];
            float g01 = KR * p01[0] + KG * p01[1] + KB * p01[2];
            float g10 = KR * p10[0] + KG * p10[1] + KB * p10[2];
            float g11 = KR * p11[0] + KG * p11[1] + KB * p11[2];
            float top = g00 + (g01 - g00) * wx;
            float bot = g10 + (g11 - g10) * wx;
            out[ox] = (top + (bot - top) * wy) * (1.0f / 255.0f);
        }
    }
}

// Grayscale-only variant for single-channel uint8 input.
void resize_gray1_u8(const uint8_t* src, int h, int w,
                     float* dst, int oh, int ow) {
    const float sy = (float)h / (float)oh;
    const float sx = (float)w / (float)ow;
    for (int oy = 0; oy < oh; ++oy) {
        float fy = ((float)oy + 0.5f) * sy - 0.5f;
        int y0 = (int)fy; if (fy < 0) y0 = 0;
        int y1 = std::min(y0 + 1, h - 1);
        float wy = fy - (float)y0; if (wy < 0) wy = 0;
        const uint8_t* r0 = src + (size_t)y0 * w;
        const uint8_t* r1 = src + (size_t)y1 * w;
        float* out = dst + (size_t)oy * ow;
        for (int ox = 0; ox < ow; ++ox) {
            float fx = ((float)ox + 0.5f) * sx - 0.5f;
            int x0 = (int)fx; if (fx < 0) x0 = 0;
            int x1 = std::min(x0 + 1, w - 1);
            float wx = fx - (float)x0; if (wx < 0) wx = 0;
            float top = r0[x0] + (r0[x1] - (float)r0[x0]) * wx;
            float bot = r1[x0] + (r1[x1] - (float)r1[x0]) * wx;
            out[ox] = (top + (bot - top) * wy) * (1.0f / 255.0f);
        }
    }
}

}  // extern "C"
