// Native data-loader entries: PNG decode, fused photometric jitter,
// bilinear resize and normalize-and-pad, each bit-exact with the PIL or
// numpy path of `gwdepth_tpu_torch/data/transforms.py` and
// `data/dataset.py` (tests/test_torch_native_loader.py). The port's own
// copy of the JAX package's loader.cpp, with the same four C entries.
//
//  - gw_png_decode: libpng decode straight into a caller buffer.  want_rgb
//    mirrors PIL `Image.open(...).convert("RGB")` (palette lookup, gray
//    expansion, alpha dropped, 16-bit stripped); raw mode mirrors
//    `np.asarray(Image.open(...))` for depth/seg maps (palette indices kept,
//    16-bit gray byte-swapped to native).  Built only with libpng: with
//    -DGW_NO_PNG (a host without png.h) the entry is left out and PIL
//    decodes.
//  - gw_color_jitter: brightness/contrast/saturation/hue in the random
//    order the transform draws.  Blend math replicates Pillow exactly:
//    float32 lerp truncated toward zero then clipped (ImagingBlend), the
//    L-channel integer formula (r*19595+g*38470+b*7471+0x8000)>>16, the
//    ImageStat mean rounding, and Pillow's mixed float/double RGB<->HSV
//    (float divisions, double composition, float assignment, double *255
//    truncation).
//  - gw_normalize_pad: fused (u8/255 - mean)/std onto a zeroed canvas,
//    float32 op-for-op with the numpy normalize path.
//  - gw_resize_bilinear_rgb8: PIL `Image.resize(..., BILINEAR)` on uint8
//    RGB, bit-exact: Pillow's two-pass Resample.c algorithm (double
//    coefficient precompute with antialias support scaling, INT32
//    fixed-point taps at PRECISION_BITS=22, clip8 on the accumulator,
//    horizontal pass into a uint8 temp then vertical).
//
// Threading: no threads in here — the Loader's thread pool provides the
// parallelism and ctypes releases the GIL for the call duration.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

#ifndef GW_NO_PNG
#include <png.h>
#endif

namespace {

inline uint8_t clip8(double v) {
    if (v <= 0.0) return 0;
    if (v >= 255.0) return 255;
    return static_cast<uint8_t>(v);  // truncation toward zero (Pillow clip8)
}

// Pillow ImagingBlend: out = (uint8)((int)in1 + alpha*((int)in2-(int)in1)),
// float arithmetic, truncation, clipped when alpha is outside [0, 1].
inline uint8_t blend1(int in1, int in2, float alpha) {
    float v = static_cast<float>(in1) + alpha * static_cast<float>(in2 - in1);
    if (v <= 0.0f) return 0;
    if (v >= 255.0f) return 255;
    return static_cast<uint8_t>(v);
}

// Pillow L-channel: (r*19595 + g*38470 + b*7471 + 0x8000) >> 16
inline uint8_t lum(uint8_t r, uint8_t g, uint8_t b) {
    return static_cast<uint8_t>(
        (static_cast<uint32_t>(r) * 19595u + static_cast<uint32_t>(g) * 38470u +
         static_cast<uint32_t>(b) * 7471u + 0x8000u) >> 16);
}

// Lazily-built lookup tables for the HSV hot path.  All tables hold the
// EXACT values the scalar Pillow expressions produce, so using them cannot
// change a single output bit — they just replace per-pixel divisions.
struct HsvTables {
    // f32 quotient n/d for n in 0..255, d in 1..255 (d=0 unused)
    float div[256][256];
    // Pillow s channel: (uint8)((double)((float)cr / (float)maxc) * 255.0)
    uint8_t sat[256][256];  // [cr][maxc], maxc >= 1
    // hsv2rgb p: (uint8)clip8(fv * (1.0 - fs) + 0.5)  [s][v]
    uint8_t ptab[256][256];
    // hsv2rgb per-channel terms: fs = s/255.0; x6 = h/255.0*6.0,
    // i = (int)x6, f = x6 - i
    double fs_tab[256];
    double f_tab[256];
    uint8_t i_tab[256];
    HsvTables() {
        for (int d = 1; d < 256; ++d) {
            float fd = static_cast<float>(d);
            for (int n = 0; n < 256; ++n)
                div[n][d] = static_cast<float>(n) / fd;
        }
        for (int cr = 0; cr < 256; ++cr)
            for (int mx = 1; mx < 256; ++mx)
                sat[cr][mx] = clip8(
                    static_cast<double>(div[cr][mx]) * 255.0);
        for (int s = 0; s < 256; ++s) {
            double fs = static_cast<double>(s) / 255.0;
            fs_tab[s] = fs;
            for (int v = 0; v < 256; ++v)
                ptab[s][v] = clip8(static_cast<double>(v) * (1.0 - fs) + 0.5);
        }
        for (int h = 0; h < 256; ++h) {
            double x6 = static_cast<double>(h) / 255.0 * 6.0;
            int i = static_cast<int>(x6);
            f_tab[h] = x6 - i;
            i_tab[h] = static_cast<uint8_t>(i % 6);
        }
    }
};

static const HsvTables& hsv_tables() {
    static HsvTables t;  // thread-safe magic static
    return t;
}

// Pillow rgb2hsv (Convert.c): float divisions, double composition/fmod with
// float assignments, double *255.0, (int) truncation.  `tb` supplies the
// precomputed f32 quotients (identical bits to the inline divisions).
inline void rgb2hsv(const HsvTables& tb, uint8_t r, uint8_t g, uint8_t b,
                    uint8_t* uh, uint8_t* us, uint8_t* uv) {
    uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    *uv = maxc;
    if (minc == maxc) {
        *uh = 0;
        *us = 0;
        return;
    }
    int cr = maxc - minc;
    float rc = tb.div[maxc - r][cr];
    float gc = tb.div[maxc - g][cr];
    float bc = tb.div[maxc - b][cr];
    float h;
    if (r == maxc) {
        h = static_cast<float>(static_cast<double>(bc) - static_cast<double>(gc));
    } else if (g == maxc) {
        h = static_cast<float>(2.0 + static_cast<double>(rc) - static_cast<double>(bc));
    } else {
        h = static_cast<float>(4.0 + static_cast<double>(gc) - static_cast<double>(rc));
    }
    // fmod(x, 1.0) for x in [5/6, 11/6]: exact conditional subtract
    // (x - 1.0 is exact by Sterbenz for x in [1, 2))
    double x = static_cast<double>(h) / 6.0 + 1.0;
    h = static_cast<float>(x >= 1.0 ? x - 1.0 : x);
    *uh = clip8(static_cast<double>(h) * 255.0);
    *us = tb.sat[cr][maxc];
}

// Pillow hsv2rgb (Convert.c): double math, p/q/t rounded (+0.5, truncate).
inline void hsv2rgb(const HsvTables& tb, uint8_t uh, uint8_t us, uint8_t uv,
                    uint8_t* r, uint8_t* g, uint8_t* b) {
    if (us == 0) {
        *r = *g = *b = uv;
        return;
    }
    double fs = tb.fs_tab[us];
    double fv = static_cast<double>(uv);
    double f = tb.f_tab[uh];
    uint8_t p = tb.ptab[us][uv];
    uint8_t q = clip8(fv * (1.0 - fs * f) + 0.5);
    uint8_t t = clip8(fv * (1.0 - fs * (1.0 - f)) + 0.5);
    switch (tb.i_tab[uh]) {
        case 0: *r = uv; *g = t;  *b = p;  break;
        case 1: *r = q;  *g = uv; *b = p;  break;
        case 2: *r = p;  *g = uv; *b = t;  break;
        case 3: *r = p;  *g = q;  *b = uv; break;
        case 4: *r = t;  *g = p;  *b = uv; break;
        default: *r = uv; *g = p;  *b = q;  break;
    }
}

// ---- Pillow Resample.c replica (8bpc bilinear) -------------------------
// PRECISION_BITS, clip8, precompute_coeffs and the two passes follow
// Pillow's source exactly so outputs match byte-for-byte.

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t resample_clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Fills bounds (outSize x {xmin, xmax}) and int32 taps (outSize x ksize);
// returns ksize. Matches Pillow precompute_coeffs + normalize_coeffs_8bpc:
// double-precision triangle filter normalized per output pixel, then
// rounded half away from zero into fixed point.
int precompute_coeffs(int inSize, int outSize, int* bounds, int32_t* kk,
                      double* prekk, int ksize) {
    const double scale = static_cast<double>(inSize) / outSize;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 1.0 * filterscale;
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < outSize; ++xx) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > inSize) xmax = inSize;
        xmax -= xmin;
        double* k = prekk + static_cast<long>(xx) * ksize;
        int x = 0;
        for (; x < xmax; ++x) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; ++x)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; ++x) k[x] = 0.0;
        bounds[2 * xx] = xmin;
        bounds[2 * xx + 1] = xmax;
    }
    const long n = static_cast<long>(outSize) * ksize;
    for (long i = 0; i < n; ++i)
        kk[i] = prekk[i] < 0
            ? static_cast<int32_t>(-0.5 + prekk[i] * (1 << kPrecisionBits))
            : static_cast<int32_t>(0.5 + prekk[i] * (1 << kPrecisionBits));
    return ksize;
}

inline int coeff_ksize(int inSize, int outSize) {
    double scale = static_cast<double>(inSize) / outSize;
    if (scale < 1.0) scale = 1.0;
    return static_cast<int>(std::ceil(1.0 * scale)) * 2 + 1;
}

#ifndef GW_NO_PNG
struct PngReader {
    FILE* fp = nullptr;
    png_structp png = nullptr;
    png_infop info = nullptr;
    png_bytep* rows = nullptr;
    ~PngReader() {
        if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
        if (fp) std::fclose(fp);
        delete[] rows;
    }
};
#endif  // GW_NO_PNG

}  // namespace

extern "C" {

#ifndef GW_NO_PNG
// Decode a PNG file.
//   want_rgb=1: emit uint8 RGB (PIL Image.open(...).convert("RGB")).
//   want_rgb=0: emit the raw array np.asarray(Image.open(...)) would give —
//     gray8 / gray16 (byte-swapped to native LE) / palette indices /
//     native channels.
// out_capacity in bytes.  On success returns 0 and fills h/w/channels/
// itemsize.  Returns 1 if the buffer is too small (dims still filled),
// negative on decode errors and on a 16-bit gray file asked for as RGB
// (PIL's convert("RGB") clips such values at 255, where libpng's strip
// keeps the high byte): the caller falls back to PIL.
int gw_png_decode(const char* path, int want_rgb, unsigned char* out,
                  long out_capacity, int* h, int* w, int* channels,
                  int* itemsize) {
    PngReader st;
    st.fp = std::fopen(path, "rb");
    if (!st.fp) return -1;
    unsigned char sig[8];
    if (std::fread(sig, 1, 8, st.fp) != 8 || png_sig_cmp(sig, 0, 8)) return -2;
    st.png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                    nullptr);
    if (!st.png) return -3;
    st.info = png_create_info_struct(st.png);
    if (!st.info) return -3;
    if (setjmp(png_jmpbuf(st.png))) return -4;
    png_init_io(st.png, st.fp);
    png_set_sig_bytes(st.png, 8);
    png_read_info(st.png, st.info);

    png_uint_32 width = png_get_image_width(st.png, st.info);
    png_uint_32 height = png_get_image_height(st.png, st.info);
    int bit_depth = png_get_bit_depth(st.png, st.info);
    int color_type = png_get_color_type(st.png, st.info);

    if (want_rgb) {
        if (bit_depth == 16 && !(color_type & PNG_COLOR_MASK_COLOR))
            return -6;
        if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(st.png);
        if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
            png_set_expand_gray_1_2_4_to_8(st.png);
        if (bit_depth == 16) png_set_strip_16(st.png);
        if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(st.png);
        // note: tRNS deliberately NOT expanded — PIL convert("RGB") does a
        // plain palette lookup and ignores transparency
        if (color_type == PNG_COLOR_TYPE_GRAY ||
            color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
            png_set_gray_to_rgb(st.png);
    } else {
        if (bit_depth == 16) png_set_swap(st.png);  // PNG is BE; emit native LE
        if (bit_depth < 8) png_set_packing(st.png); // 1/2/4-bit -> one byte/px
    }
    png_set_interlace_handling(st.png);
    png_read_update_info(st.png, st.info);

    size_t rowbytes = png_get_rowbytes(st.png, st.info);
    int ch = png_get_channels(st.png, st.info);
    int isz = png_get_bit_depth(st.png, st.info) == 16 ? 2 : 1;
    *h = static_cast<int>(height);
    *w = static_cast<int>(width);
    *channels = ch;
    *itemsize = isz;
    if (rowbytes != static_cast<size_t>(width) * ch * isz) return -5;
    if (static_cast<long>(rowbytes * height) > out_capacity) return 1;

    st.rows = new png_bytep[height];
    for (png_uint_32 y = 0; y < height; ++y) st.rows[y] = out + y * rowbytes;
    png_read_image(st.png, st.rows);
    return 0;
}
#endif  // GW_NO_PNG

// In-place fused color jitter on a contiguous uint8 RGB image.
// ops[i]: 0=brightness 1=contrast 2=saturation 3=hue; factors[i] is the
// blend factor (for hue: the integer uint8 shift, already int(f*255)).
int gw_color_jitter(unsigned char* img, int h, int w, int n_ops,
                    const int* ops, const float* factors) {
    const long n = static_cast<long>(h) * w;
    for (int k = 0; k < n_ops; ++k) {
        const float f = factors[k];
        switch (ops[k]) {
            case 0: {  // brightness: blend(black, img, f)
                for (long i = 0; i < n * 3; ++i)
                    img[i] = blend1(0, img[i], f);
                break;
            }
            case 1: {  // contrast: blend(mean-gray, img, f)
                uint64_t sum = 0;
                for (long i = 0; i < n; ++i)
                    sum += lum(img[3 * i], img[3 * i + 1], img[3 * i + 2]);
                // ImageStat mean (double) then int(mean + 0.5)
                int m = static_cast<int>(
                    static_cast<double>(sum) / static_cast<double>(n) + 0.5);
                for (long i = 0; i < n * 3; ++i)
                    img[i] = blend1(m, img[i], f);
                break;
            }
            case 2: {  // saturation: blend(L-gray, img, f)
                for (long i = 0; i < n; ++i) {
                    uint8_t g = lum(img[3 * i], img[3 * i + 1], img[3 * i + 2]);
                    img[3 * i] = blend1(g, img[3 * i], f);
                    img[3 * i + 1] = blend1(g, img[3 * i + 1], f);
                    img[3 * i + 2] = blend1(g, img[3 * i + 2], f);
                }
                break;
            }
            case 3: {  // hue: HSV roundtrip with uint8 channel shift
                const HsvTables& tb = hsv_tables();
                int shift = static_cast<int>(f);
                for (long i = 0; i < n; ++i) {
                    uint8_t uh, us, uv;
                    rgb2hsv(tb, img[3 * i], img[3 * i + 1], img[3 * i + 2],
                            &uh, &us, &uv);
                    uh = static_cast<uint8_t>((static_cast<int>(uh) + shift) & 0xFF);
                    hsv2rgb(tb, uh, us, uv,
                            &img[3 * i], &img[3 * i + 1], &img[3 * i + 2]);
                }
                break;
            }
            default:
                return -1;
        }
    }
    return 0;
}

// PIL-exact bilinear resize of a contiguous uint8 RGB (h, w, 3) image into
// (oh, ow, 3). Horizontal pass first (into a uint8 temp, like Pillow), then
// vertical. Returns 0 on success, -1 on bad sizes / allocation failure.
int gw_resize_bilinear_rgb8(const unsigned char* src, int h, int w,
                            unsigned char* dst, int oh, int ow) {
    if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return -1;
    if (h == oh && w == ow) {
        std::memcpy(dst, src, static_cast<size_t>(h) * w * 3);
        return 0;
    }
    const bool need_h = (ow != w);
    const bool need_v = (oh != h);

    const unsigned char* hin = src;
    unsigned char* temp = nullptr;
    if (need_h) {
        const int ksize = coeff_ksize(w, ow);
        int* bounds = new (std::nothrow) int[2L * ow];
        int32_t* kk = new (std::nothrow) int32_t[static_cast<long>(ow) * ksize];
        double* pre = new (std::nothrow) double[static_cast<long>(ow) * ksize];
        unsigned char* out_h = dst;
        if (need_v) {
            temp = new (std::nothrow) unsigned char[
                static_cast<size_t>(h) * ow * 3];
            out_h = temp;
        }
        if (!bounds || !kk || !pre || !out_h) {
            delete[] bounds; delete[] kk; delete[] pre; delete[] temp;
            return -1;
        }
        precompute_coeffs(w, ow, bounds, kk, pre, ksize);
        for (int y = 0; y < h; ++y) {
            const unsigned char* row = src + static_cast<long>(y) * w * 3;
            unsigned char* orow = out_h + static_cast<long>(y) * ow * 3;
            for (int xx = 0; xx < ow; ++xx) {
                const int xmin = bounds[2 * xx];
                const int xmax = bounds[2 * xx + 1];
                const int32_t* k = kk + static_cast<long>(xx) * ksize;
                int s0 = 1 << (kPrecisionBits - 1);
                int s1 = s0, s2 = s0;
                const unsigned char* p = row + 3L * xmin;
                for (int x = 0; x < xmax; ++x) {
                    s0 += p[3 * x] * k[x];
                    s1 += p[3 * x + 1] * k[x];
                    s2 += p[3 * x + 2] * k[x];
                }
                orow[3 * xx] = resample_clip8(s0);
                orow[3 * xx + 1] = resample_clip8(s1);
                orow[3 * xx + 2] = resample_clip8(s2);
            }
        }
        delete[] bounds; delete[] kk; delete[] pre;
        hin = out_h;
    }
    if (need_v) {
        const int ksize = coeff_ksize(h, oh);
        int* bounds = new (std::nothrow) int[2L * oh];
        int32_t* kk = new (std::nothrow) int32_t[static_cast<long>(oh) * ksize];
        double* pre = new (std::nothrow) double[static_cast<long>(oh) * ksize];
        if (!bounds || !kk || !pre) {
            delete[] bounds; delete[] kk; delete[] pre; delete[] temp;
            return -1;
        }
        precompute_coeffs(h, oh, bounds, kk, pre, ksize);
        const long rowb = 3L * ow;
        for (int yy = 0; yy < oh; ++yy) {
            const int ymin = bounds[2 * yy];
            const int ymax = bounds[2 * yy + 1];
            const int32_t* k = kk + static_cast<long>(yy) * ksize;
            unsigned char* orow = dst + static_cast<long>(yy) * rowb;
            for (long i = 0; i < rowb; ++i) {
                int s = 1 << (kPrecisionBits - 1);
                const unsigned char* p = hin + static_cast<long>(ymin) * rowb + i;
                for (int y = 0; y < ymax; ++y)
                    s += p[static_cast<long>(y) * rowb] * k[y];
                orow[i] = resample_clip8(s);
            }
        }
        delete[] bounds; delete[] kk; delete[] pre;
    }
    delete[] temp;
    return 0;
}

// Fused normalize + zero-pad onto a (ch, cw, 3) float32 canvas:
// out[:h,:w] = (img/255 - mean)/std  (float32 op order matching numpy),
// the rest zeroed.  Returns 0; nonzero if the image exceeds the canvas
// (writing w > cw rows would run past the output buffer).
int gw_normalize_pad(const unsigned char* img, int h, int w, float* out,
                     int ch, int cw, const float* mean, const float* std_) {
    if (h > ch || w > cw) return 1;
    for (int y = 0; y < ch; ++y) {
        float* row = out + static_cast<long>(y) * cw * 3;
        if (y >= h) {
            std::memset(row, 0, static_cast<size_t>(cw) * 3 * sizeof(float));
            continue;
        }
        const unsigned char* src = img + static_cast<long>(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            for (int c = 0; c < 3; ++c) {
                float v = static_cast<float>(src[3 * x + c]) / 255.0f;
                row[3 * x + c] = (v - mean[c]) / std_[c];
            }
        }
        if (w < cw)
            std::memset(row + 3 * w, 0,
                        static_cast<size_t>(cw - w) * 3 * sizeof(float));
    }
    return 0;
}

}  // extern "C"
