// Native grayscale image decoder: PNG (8/16-bit gray, RGB, palette-free)
// and PGM (P5), straight to uint8 rows. The PyTorch port's copy of
// native/image_decode.cpp (its uint8 form: the port's loader needs no
// other), built with g++ into build/ by hybvio_tpu_torch/io/native_image.py.
//
// Rationale: the CLI/EuRoC replay decodes one image per frame on the input
// thread. This decoder runs outside the GIL (ctypes releases it), so the
// Python-level prefetch threads overlap decode with compute. Mirrors the
// role of the reference's OpenCV/ffmpeg reader threads (reference:
// src/commandline/video_input.cpp:23-58).
//
// zlib provides inflate; everything else (chunk walk, unfiltering, luma
// conversion) is implemented here. Built where zlib's header is missing, the
// library decodes PGM only and hyb_img_png_supported() returns 0.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if __has_include(<zlib.h>)
#include <zlib.h>
#define HYB_HAVE_ZLIB 1
#else
#define HYB_HAVE_ZLIB 0
#endif

namespace {

struct Bytes {
    std::vector<uint8_t> data;
    bool ok = false;
};

Bytes read_file(const char *path) {
    Bytes b;
    FILE *f = fopen(path, "rb");
    if (!f) return b;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (n <= 0) { fclose(f); return b; }
    b.data.resize((size_t)n);
    b.ok = fread(b.data.data(), 1, (size_t)n, f) == (size_t)n;
    fclose(f);
    return b;
}

uint32_t be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

const uint8_t PNG_SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct PngInfo {
    uint32_t w = 0, h = 0;
    int bit_depth = 0, color_type = 0, interlace = 0;
    size_t idat_begin = 0;  // first IDAT chunk offset (data start)
    bool ok = false;
};

PngInfo png_parse_header(const Bytes &file) {
    PngInfo info;
    const auto &d = file.data;
    if (!file.ok || d.size() < 8 + 25 || memcmp(d.data(), PNG_SIG, 8) != 0)
        return info;
    size_t off = 8;
    // IHDR must be first
    if (be32(&d[off]) != 13 || memcmp(&d[off + 4], "IHDR", 4) != 0)
        return info;
    const uint8_t *ih = &d[off + 8];
    info.w = be32(ih);
    info.h = be32(ih + 4);
    info.bit_depth = ih[8];
    info.color_type = ih[9];
    info.interlace = ih[12];
    info.ok = info.w > 0 && info.h > 0;
    return info;
}

// inflate all IDAT chunks into `out`
bool png_inflate(const Bytes &file, std::vector<uint8_t> &out) {
#if !HYB_HAVE_ZLIB
    (void)file;
    (void)out;
    return false;
#else
    const auto &d = file.data;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    size_t off = 8;
    bool done = false;
    int zret = Z_OK;
    while (off + 8 <= d.size() && !done) {
        uint32_t len = be32(&d[off]);
        const char *type = (const char *)&d[off + 4];
        if (off + 8 + len + 4 > d.size()) break;
        if (memcmp(type, "IDAT", 4) == 0) {
            zs.next_in = const_cast<uint8_t *>(&d[off + 8]);
            zs.avail_in = len;
            while (zs.avail_in > 0) {
                size_t old = out.size();
                out.resize(old + (1 << 16));
                zs.next_out = &out[old];
                zs.avail_out = 1 << 16;
                zret = inflate(&zs, Z_NO_FLUSH);
                out.resize(old + ((1 << 16) - zs.avail_out));
                if (zret == Z_STREAM_END) { done = true; break; }
                if (zret != Z_OK) { inflateEnd(&zs); return false; }
            }
        } else if (memcmp(type, "IEND", 4) == 0) {
            break;
        }
        off += 8 + len + 4;
    }
    inflateEnd(&zs);
    return done || zret == Z_OK;
#endif
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// unfilter in place row by row; bpp = bytes per pixel
bool png_unfilter(std::vector<uint8_t> &raw, uint32_t h, size_t stride, int bpp) {
    if (raw.size() < h * (stride + 1)) return false;
    std::vector<uint8_t> prev(stride, 0);
    for (uint32_t y = 0; y < h; y++) {
        uint8_t *row = &raw[y * (stride + 1)];
        int filter = row[0];
        uint8_t *cur = row + 1;
        switch (filter) {
            case 0: break;
            case 1:
                for (size_t i = bpp; i < stride; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
                break;
            case 2:
                for (size_t i = 0; i < stride; i++) cur[i] = (uint8_t)(cur[i] + prev[i]);
                break;
            case 3:
                for (size_t i = 0; i < (size_t)bpp; i++) cur[i] = (uint8_t)(cur[i] + prev[i] / 2);
                for (size_t i = bpp; i < stride; i++)
                    cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
                break;
            case 4:
                for (size_t i = 0; i < (size_t)bpp; i++)
                    cur[i] = (uint8_t)(cur[i] + paeth(0, prev[i], 0));
                for (size_t i = bpp; i < stride; i++)
                    cur[i] = (uint8_t)(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
                break;
            default:
                return false;
        }
        memcpy(prev.data(), cur, stride);
    }
    return true;
}

// ---- PGM ----

struct PgmInfo {
    uint32_t w = 0, h = 0, maxval = 0;
    size_t data_off = 0;
    bool ok = false;
};

PgmInfo pgm_parse(const Bytes &file) {
    PgmInfo info;
    const auto &d = file.data;
    if (!file.ok || d.size() < 10 || d[0] != 'P' || d[1] != '5') return info;
    size_t off = 2;
    uint32_t vals[3];
    for (int v = 0; v < 3; v++) {
        // skip whitespace + comments
        while (off < d.size()) {
            if (d[off] == '#') {
                while (off < d.size() && d[off] != '\n') off++;
            } else if (isspace(d[off])) {
                off++;
            } else {
                break;
            }
        }
        uint32_t x = 0;
        while (off < d.size() && isdigit(d[off])) x = x * 10 + (d[off++] - '0');
        vals[v] = x;
    }
    if (off >= d.size() || !isspace(d[off])) return info;
    off++;  // single whitespace after maxval
    info.w = vals[0];
    info.h = vals[1];
    info.maxval = vals[2];
    info.data_off = off;
    info.ok = info.w > 0 && info.h > 0 && info.maxval > 0;
    return info;
}

}  // namespace

extern "C" {

// 1 when the library was built with zlib (PNG and PGM), 0 for PGM only.
int hyb_img_png_supported() { return HYB_HAVE_ZLIB; }

// Probe image dimensions. Returns 0 on success.
int hyb_img_probe(const char *path, int *w, int *h) {
    Bytes file = read_file(path);
    if (!file.ok) return -1;
    PngInfo png = png_parse_header(file);
    if (png.ok) {
        *w = (int)png.w;
        *h = (int)png.h;
        return 0;
    }
    PgmInfo pgm = pgm_parse(file);
    if (pgm.ok) {
        *w = (int)pgm.w;
        *h = (int)pgm.h;
        return 0;
    }
    return -2;
}

// Decode to RAW 8-bit grayscale (0-255); out must hold h*w bytes (dims from
// hyb_img_probe). RGB(A) converts with the reference's luma weights
// 0.299/0.587/0.114 (reference: image.cpp:345-367); 16-bit gray keeps its
// high byte. Returns 0 on success. The uint8 form exists so 8-bit sources
// stay 8-bit end-to-end: the VIO step normalizes on the accelerator and the
// host->device transfer ships 1/4 the bytes of float32 (the reference
// pipeline likewise carries 8-bit frames, image.cpp:345-367).
int hyb_img_decode_u8(const char *path, uint8_t *out, int h, int w) {
    Bytes file = read_file(path);
    if (!file.ok) return -1;

    PgmInfo pgm = pgm_parse(file);
    if (pgm.ok) {
        if ((int)pgm.w != w || (int)pgm.h != h) return -3;
        size_t n = (size_t)w * h;
        if (pgm.maxval == 255) {
            if (file.data.size() < pgm.data_off + n) return -4;
            memcpy(out, &file.data[pgm.data_off], n);
        } else if (pgm.maxval < 256) {
            if (file.data.size() < pgm.data_off + n) return -4;
            const uint8_t *p = &file.data[pgm.data_off];
            for (size_t i = 0; i < n; i++)
                out[i] = (uint8_t)((p[i] * 255u + pgm.maxval / 2) / pgm.maxval);
        } else {
            if (file.data.size() < pgm.data_off + 2 * n) return -4;
            const uint8_t *p = &file.data[pgm.data_off];
            for (size_t i = 0; i < n; i++) out[i] = p[2 * i];  // high byte
        }
        return 0;
    }

    PngInfo png = png_parse_header(file);
    if (!png.ok) return -2;
    if ((int)png.w != w || (int)png.h != h) return -3;
    if (png.interlace != 0) return -5;
    int channels;
    switch (png.color_type) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return -6;
    }
    if (png.bit_depth != 8 && !(png.bit_depth == 16 && png.color_type == 0))
        return -7;

    std::vector<uint8_t> raw;
    raw.reserve((size_t)w * h * channels + h);
    if (!png_inflate(file, raw)) return -8;

    int bytes_per_sample = png.bit_depth / 8;
    int bpp = channels * bytes_per_sample;
    size_t stride = (size_t)w * bpp;
    if (!png_unfilter(raw, png.h, stride, bpp)) return -9;

    for (uint32_t y = 0; y < png.h; y++) {
        const uint8_t *row = &raw[y * (stride + 1) + 1];
        uint8_t *o = out + (size_t)y * w;
        if (png.color_type == 0 && png.bit_depth == 8) {
            memcpy(o, row, w);
        } else if (png.color_type == 0) {  // 16-bit gray: high byte
            for (int x = 0; x < w; x++) o[x] = row[2 * x];
        } else if (png.color_type == 4) {  // gray + alpha
            for (int x = 0; x < w; x++) o[x] = row[2 * x];
        } else {  // RGB / RGBA -> integer luma (0.299/0.587/0.114)
            for (int x = 0; x < w; x++) {
                const uint8_t *p = row + x * channels;
                o[x] = (uint8_t)((299u * p[0] + 587u * p[1] + 114u * p[2] + 500u) / 1000u);
            }
        }
    }
    return 0;
}

}  // extern "C"
