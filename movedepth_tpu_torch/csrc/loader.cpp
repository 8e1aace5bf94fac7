// Host data-loader core of the port: threaded JPEG/PNG decode, h-flip,
// the chained float Lanczos-3 pyramid and the fused 4-op colour jitter.
//
// A copy of the JAX package's native/loader.cpp with the same C ABI
// (md_load_batch, md_jitter_batch, md_probe, md_decode) and the same float
// arithmetic, so that built with the same flags on one host the two
// libraries give the same bytes. Bound with ctypes by
// movedepth_tpu_torch/data/native_loader.py and built by
// movedepth_tpu_torch/native.py (g++ -O3 -march=native -fPIC -std=c++17).
//
// Two builds of this file:
//   route a: decode with libjpeg and libpng (-ljpeg -lpng), one OS thread
//            per image, in md_load_batch;
//   route b: -DMD_NO_CODECS, for a host without those headers: the caller
//            decodes (Pillow releases the GIL while it decodes) and hands
//            the uint8 RGB images to md_pyramid_batch, which does the
//            h-flip, the pyramid and the float conversion here.
// Resize is separable Lanczos-3 with support scaling, the family PIL's
// LANCZOS uses (float math here against PIL's fixed point: equal to ~1e-3).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#ifndef MD_NO_CODECS
#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> data;  // h * w * 3, RGB in [0, 1]
};

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> data;  // h * w * 3, RGB
};

// ---------------------------------------------------------------- decoding
#ifndef MD_NO_CODECS

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  for (int y = 0; y < out->h; ++y) {
    JSAMPROW rp = out->data.data() + size_t(y) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

bool decode_png(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  for (int y = 0; y < out->h; ++y)
    png_read_row(png, out->data.data() + size_t(y) * out->w * 3, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

bool decode_any(const char* path, ImageU8* out) {
  const char* dot = strrchr(path, '.');
  if (dot && (!strcmp(dot, ".png") || !strcmp(dot, ".PNG")))
    return decode_png(path, out);
  return decode_jpeg(path, out);
}
#endif  // MD_NO_CODECS

// --------------------------------------------------- separable Lanczos-3

inline double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  double px = M_PI * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

struct ResampleTaps {
  std::vector<int> start;      // first source index per output pixel
  std::vector<int> count;      // taps per output pixel
  std::vector<float> weights;  // flattened taps
  int max_taps = 0;
};

ResampleTaps make_taps(int in_size, int out_size) {
  ResampleTaps t;
  double scale = double(in_size) / out_size;
  double support = 3.0 * (scale > 1.0 ? scale : 1.0);
  t.max_taps = int(std::ceil(support)) * 2 + 1;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weights.resize(size_t(out_size) * t.max_taps);
  double inv_filter = scale > 1.0 ? 1.0 / scale : 1.0;
  for (int xo = 0; xo < out_size; ++xo) {
    double center = (xo + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(in_size, int(center + support + 0.5));
    double sum = 0.0;
    float* w = t.weights.data() + size_t(xo) * t.max_taps;
    std::vector<double> tmp(hi - lo);
    for (int xi = lo; xi < hi; ++xi) {
      tmp[xi - lo] = lanczos3((xi + 0.5 - center) * inv_filter);
      sum += tmp[xi - lo];
    }
    for (int i = 0; i < hi - lo; ++i)
      w[i] = float(sum != 0.0 ? tmp[i] / sum : tmp[i]);
    t.start[xo] = lo;
    t.count[xo] = hi - lo;
  }
  return t;
}

template <typename SrcT>
void resize_lanczos_t(const SrcT* src_data, int src_w, int src_h,
                      float src_scale, int out_w, int out_h, Image* out) {
  ResampleTaps tx = make_taps(src_w, out_w);
  ResampleTaps ty = make_taps(src_h, out_h);
  // horizontal pass (also applies src_scale, e.g. 1/255 for uint8 input)
  std::vector<float> tmp(size_t(src_h) * out_w * 3);
  for (int y = 0; y < src_h; ++y) {
    const SrcT* srow = src_data + size_t(y) * src_w * 3;
    float* drow = tmp.data() + size_t(y) * out_w * 3;
    for (int xo = 0; xo < out_w; ++xo) {
      const float* w = tx.weights.data() + size_t(xo) * tx.max_taps;
      int s = tx.start[xo], n = tx.count[xo];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const SrcT* p = srow + size_t(s) * 3;
      for (int i = 0; i < n; ++i, p += 3) {
        acc0 += w[i] * p[0];
        acc1 += w[i] * p[1];
        acc2 += w[i] * p[2];
      }
      drow[xo * 3 + 0] = acc0 * src_scale;
      drow[xo * 3 + 1] = acc1 * src_scale;
      drow[xo * 3 + 2] = acc2 * src_scale;
    }
  }
  // vertical pass
  out->w = out_w;
  out->h = out_h;
  out->data.resize(size_t(out_w) * out_h * 3);
  for (int yo = 0; yo < out_h; ++yo) {
    const float* w = ty.weights.data() + size_t(yo) * ty.max_taps;
    int s = ty.start[yo], n = ty.count[yo];
    float* drow = out->data.data() + size_t(yo) * out_w * 3;
    const int row_elems = out_w * 3;
    for (int x = 0; x < row_elems; ++x) drow[x] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float wi = w[i];
      const float* trow = tmp.data() + size_t(s + i) * row_elems;
      for (int x = 0; x < row_elems; ++x) drow[x] += wi * trow[x];
    }
    for (int x = 0; x < row_elems; ++x)
      drow[x] = std::fmin(std::fmax(drow[x], 0.0f), 1.0f);
  }
}

void resize_lanczos(const ImageU8& src, int out_w, int out_h, Image* out) {
  resize_lanczos_t(src.data.data(), src.w, src.h, 1.0f / 255.0f, out_w,
                   out_h, out);
}

void resize_lanczos(const Image& src, int out_w, int out_h, Image* out) {
  resize_lanczos_t(src.data.data(), src.w, src.h, 1.0f, out_w, out_h, out);
}

// ------------------------------------------------------------ color jitter
//
// The 4-op torchvision-ColorJitter-equivalent augmentation, float math
// identical to data/kitti.py::color_jitter_np (which mirrors the PIL path's
// rng draws; reference: mono_dataset.py:67-80,220-223). The numpy hue op is
// a full float HSV round-trip and costs ~29 ms per 640x192 frame on one
// core -- fused here it is one cache-resident pass per op, threaded with
// the decode pool.

inline float floored_mod1(float x) { return x - std::floor(x); }

void jitter_image(float* img, size_t npix, const float params[4],
                  const uint8_t order[4]) {
  const float b = params[0], c = params[1], s = params[2];
  const float hue_shift = float(int(params[3] * 255.0f)) / 255.0f;
  for (int oi = 0; oi < 4; ++oi) {
    switch (order[oi]) {
      case 0: {  // brightness: x*b
        for (size_t i = 0; i < npix * 3; ++i)
          img[i] = std::fmin(std::fmax(img[i] * b, 0.0f), 1.0f);
        break;
      }
      case 1: {  // contrast: blend toward the global luma mean
        double acc = 0.0;
        for (size_t i = 0; i < npix; ++i) {
          const float* p = img + i * 3;
          acc += 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
        }
        const float mean = float(acc / double(npix));
        const float base = mean * (1.0f - c);
        for (size_t i = 0; i < npix * 3; ++i)
          img[i] = std::fmin(std::fmax(base + img[i] * c, 0.0f), 1.0f);
        break;
      }
      case 2: {  // saturation: blend toward per-pixel luma
        for (size_t i = 0; i < npix; ++i) {
          float* p = img + i * 3;
          const float l =
              (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) * (1.0f - s);
          for (int k = 0; k < 3; ++k)
            p[k] = std::fmin(std::fmax(l + p[k] * s, 0.0f), 1.0f);
        }
        break;
      }
      default: {  // hue: float HSV rotation by int(h*255)/255
        for (size_t i = 0; i < npix; ++i) {
          float* p = img + i * 3;
          const float r = std::fmin(std::fmax(p[0], 0.0f), 1.0f);
          const float g = std::fmin(std::fmax(p[1], 0.0f), 1.0f);
          const float bl = std::fmin(std::fmax(p[2], 0.0f), 1.0f);
          const float v = std::fmax(r, std::fmax(g, bl));
          const float cc = v - std::fmin(r, std::fmin(g, bl));
          float hh;
          if (cc == 0.0f) {
            hh = 0.0f;
          } else {
            // same tie-breaking order as the numpy where-chain
            if (v == r) hh = (g - bl) / cc;
            else if (v == g) hh = 2.0f + (bl - r) / cc;
            else hh = 4.0f + (r - g) / cc;
            hh = floored_mod1(hh / 6.0f);
          }
          const float ss = v == 0.0f ? 0.0f : cc / v;
          hh = floored_mod1(hh + hue_shift);
          const float f6 = hh * 6.0f;
          const int sect = int(std::floor(f6)) % 6;
          const float f = f6 - std::floor(f6);
          const float pp = v * (1.0f - ss);
          const float q = v * (1.0f - ss * f);
          const float t = v * (1.0f - ss * (1.0f - f));
          switch (sect) {
            case 0: p[0] = v;  p[1] = t;  p[2] = pp; break;
            case 1: p[0] = q;  p[1] = v;  p[2] = pp; break;
            case 2: p[0] = pp; p[1] = v;  p[2] = t;  break;
            case 3: p[0] = pp; p[1] = q;  p[2] = v;  break;
            case 4: p[0] = t;  p[1] = pp; p[2] = v;  break;
            default: p[0] = v; p[1] = pp; p[2] = q;  break;
          }
          for (int k = 0; k < 3; ++k)
            p[k] = std::fmin(std::fmax(p[k], 0.0f), 1.0f);
        }
        break;
      }
    }
  }
}

void hflip(ImageU8* img) {
  for (int y = 0; y < img->h; ++y) {
    uint8_t* row = img->data.data() + size_t(y) * img->w * 3;
    for (int x = 0; x < img->w / 2; ++x) {
      for (int c = 0; c < 3; ++c)
        std::swap(row[x * 3 + c], row[(img->w - 1 - x) * 3 + c]);
    }
  }
}

// The chained pyramid of image i (scale s resized from scale s-1, like the
// reference dataset, mono_dataset.py:104-126) into outs[s] at slot i.
void pyramid(const ImageU8& img, int i, int width, int height,
             int num_scales, float** outs) {
  Image cur;
  for (int s = 0; s < num_scales; ++s) {
    int w = width >> s, h = height >> s;
    Image dst;
    if (s == 0)
      resize_lanczos(img, w, h, &dst);
    else
      resize_lanczos(cur, w, h, &dst);
    memcpy(outs[s] + size_t(i) * w * h * 3, dst.data.data(),
           size_t(w) * h * 3 * sizeof(float));
    cur = std::move(dst);
  }
}

void zero_fill(int i, int width, int height, int num_scales, float** outs) {
  for (int s = 0; s < num_scales; ++s) {
    int w = width >> s, h = height >> s;
    memset(outs[s] + size_t(i) * w * h * 3, 0,
           size_t(w) * h * 3 * sizeof(float));
  }
}

// Runs fn(i) for i in [0, n) on min(num_threads, n) OS threads.
template <typename Fn>
void parallel_for(int n, int num_threads, Fn fn) {
  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int nt = std::min(std::max(num_threads, 1), n);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

#ifndef MD_NO_CODECS
// Decode n images, optionally h-flip, then produce the chained Lanczos
// pyramid. outs[s] is a preallocated float32 buffer of
// n * (height >> s) * (width >> s) * 3. A file that does not decode gives
// zeros at every scale. Returns the number of failures.
int md_load_batch(const char** paths, int n, const uint8_t* flips,
                  int width, int height, int num_scales, float** outs,
                  int num_threads) {
  std::atomic<int> failures{0};
  parallel_for(n, num_threads, [&](int i) {
    ImageU8 img;
    if (!decode_any(paths[i], &img)) {
      failures.fetch_add(1);
      zero_fill(i, width, height, num_scales, outs);
      return;
    }
    if (flips && flips[i]) hflip(&img);
    pyramid(img, i, width, height, num_scales, outs);
  });
  return failures.load();
}

// Single-image decode to a caller-allocated full-res buffer (its size from
// md_probe first). Used for tests and GT tooling.
int md_probe(const char* path, int* w, int* h) {
  ImageU8 img;
  if (!decode_any(path, &img)) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}

int md_decode(const char* path, float* out, int w, int h) {
  ImageU8 img;
  if (!decode_any(path, &img)) return 1;
  if (img.w != w || img.h != h) return 2;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < size_t(w) * h * 3; ++i) out[i] = img.data[i] * inv;
  return 0;
}
#else
// md_load_batch on images the caller decoded: imgs[i] is a C-contiguous
// (hs[i], ws[i], 3) uint8 RGB image, or null for a file that did not decode
// (zeros at every scale). Optionally h-flip, then the chained Lanczos
// pyramid into outs as md_load_batch does. Returns the number of nulls.
int md_pyramid_batch(const uint8_t* const* imgs, const int* ws,
                     const int* hs, int n, const uint8_t* flips, int width,
                     int height, int num_scales, float** outs,
                     int num_threads) {
  std::atomic<int> failures{0};
  parallel_for(n, num_threads, [&](int i) {
    if (!imgs[i]) {
      failures.fetch_add(1);
      zero_fill(i, width, height, num_scales, outs);
      return;
    }
    ImageU8 img;
    img.w = ws[i];
    img.h = hs[i];
    img.data.assign(imgs[i], imgs[i] + size_t(img.w) * img.h * 3);
    if (flips && flips[i]) hflip(&img);
    pyramid(img, i, width, height, num_scales, outs);
  });
  return failures.load();
}
#endif  // MD_NO_CODECS

// Apply the 4-op color jitter IN PLACE to n (h, w, 3) float images (one
// shared (b, c, s, hue) draw and op order per call -- the dataset shares
// the jitter across a sample's frames, reference mono_dataset.py:220-223).
// Math identical to data/kitti.py::color_jitter_np; threaded per image.
void md_jitter_batch(float* imgs, int n, int h, int w, const float* params,
                     const uint8_t* order, int num_threads) {
  const size_t npix = size_t(h) * w;
  parallel_for(n, num_threads, [&](int i) {
    jitter_image(imgs + size_t(i) * npix * 3, npix, params, order);
  });
}

}  // extern "C"
