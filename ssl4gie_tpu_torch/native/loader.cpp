// The port's copy of `native/loader.cpp` (built by
// `ssl4gie_tpu_torch/data/native_loader.py`, the same C entry points).
//
// Native data loader: JPEG/PNG decode + bilinear resize + center-pad,
// with a pthread pool filling preallocated batch buffers.
//
// This is the framework's native IO engine — the counterpart of the reference's
// torch DataLoader C++ worker pool + PIL-SIMD decode path (SURVEY §2.9): the hot
// host work (entropy decode, resize) runs in C++ with the GIL released; Python only
// hands over path lists and receives filled uint8 tensors ready for the on-device
// augmentation pipeline.
//
// C ABI (ctypes):
//   void* s4g_pool_create(int n_threads);
//   void  s4g_pool_destroy(void* pool);
//   int   s4g_load_batch(void* pool, const char** paths, int n, int out_size,
//                        int make_square, unsigned char* out);
//     out: (n, out_size, out_size, 3) uint8, preallocated by the caller.
//     returns 0 on success, else the 1-based index of the first failed item.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <vector>
#include <string>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <functional>
#include <queue>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<unsigned char> rgb;  // h*w*3
};

// ------------------------------------------------------------------ decode

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                           nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return false; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->w = w;
  out->h = h;
  out->rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; r++)
    rows[r] = out->rgb.data() + size_t(r) * w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok && out->w > 0 && out->h > 0;
}

// ------------------------------------------------------------------ resize

// Bilinear resize with PIL's half-pixel convention (Image.resize default filter is
// bicubic in recent Pillow; bilinear is visually equivalent for our 224px targets
// and is what torchvision's tensor path uses).
void resize_bilinear(const Image& src, int out_w, int out_h, int pad_square,
                     unsigned char* dst /* out_h*out_w*3 */) {
  int sw = src.w, sh = src.h;
  int off_x = 0, off_y = 0;
  int box_w = sw, box_h = sh;
  std::vector<unsigned char> padded;
  const unsigned char* data = src.rgb.data();
  if (pad_square && sw != sh) {
    int size = sw > sh ? sw : sh;
    padded.assign(size_t(size) * size * 3, 0);
    off_x = (size - sw) / 2;
    off_y = (size - sh) / 2;
    for (int r = 0; r < sh; r++)
      memcpy(padded.data() + (size_t(r + off_y) * size + off_x) * 3,
             src.rgb.data() + size_t(r) * sw * 3, size_t(sw) * 3);
    data = padded.data();
    sw = sh = size;
  }
  (void)box_w; (void)box_h;
  const float sx = float(sw) / out_w;
  const float sy = float(sh) / out_h;
  for (int oy = 0; oy < out_h; oy++) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 >= sh) y1 = sh - 1;
    if (y0 >= sh) y0 = sh - 1;
    for (int ox = 0; ox < out_w; ox++) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 >= sw) x1 = sw - 1;
      if (x0 >= sw) x0 = sw - 1;
      const unsigned char* p00 = data + (size_t(y0) * sw + x0) * 3;
      const unsigned char* p01 = data + (size_t(y0) * sw + x1) * 3;
      const unsigned char* p10 = data + (size_t(y1) * sw + x0) * 3;
      const unsigned char* p11 = data + (size_t(y1) * sw + x1) * 3;
      unsigned char* o = dst + (size_t(oy) * out_w + ox) * 3;
      for (int c = 0; c < 3; c++) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        o[c] = (unsigned char)(v + 0.5f);
      }
    }
  }
}

// ------------------------------------------------------------------ pool

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; i++)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

void* s4g_pool_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new ThreadPool(n_threads);
}

void s4g_pool_destroy(void* pool) {
  delete static_cast<ThreadPool*>(pool);
}

int s4g_load_batch(void* pool_ptr, const char** paths, int n, int out_size,
                   int make_square, unsigned char* out) {
  ThreadPool* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int> failed{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; i++) {
    pool->submit([=, &failed, &remaining, &done_mu, &done_cv] {
      Image im;
      if (decode_file(paths[i], &im)) {
        resize_bilinear(im, out_size, out_size, make_square,
                        out + size_t(i) * out_size * out_size * 3);
      } else {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failed.load();
}

int s4g_decode_info(const char* path, int* w, int* h) {
  Image im;
  if (!decode_file(path, &im)) return 1;
  *w = im.w;
  *h = im.h;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host augmentation pipeline (classification recipe): color jitter -> gaussian
// blur -> h/v flips -> rotation (nearest, fill 0) -> ImageNet normalize.
// Statistical match of data/augment.py's on-device pipeline, for multi-core TPU
// hosts where augmentation overlaps device compute (SURVEY §2.7). Per-image
// xorshift RNG seeded by (seed, index) keeps batches reproducible.

namespace {

struct XorShift {
  unsigned long long s;
  explicit XorShift(unsigned long long seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  unsigned long long next() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return s;
  }
  float uniform(float lo, float hi) {
    return lo + (hi - lo) * float(next() >> 11) / float(1ull << 53);
  }
};

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

void augment_one(const unsigned char* src, int S, XorShift& rng, float* dst,
                 std::vector<float>& tmp_a, std::vector<float>& tmp_b) {
  const size_t n = size_t(S) * S;
  tmp_a.resize(n * 3);
  tmp_b.resize(n * 3);
  float* img = tmp_a.data();
  for (size_t i = 0; i < n * 3; i++) img[i] = src[i] / 255.0f;

  // ---- color jitter (brightness 0.4, contrast 0.5, saturation 0.25, hue 0.01)
  float fb = rng.uniform(0.6f, 1.4f);
  float fc = rng.uniform(0.5f, 1.5f);
  float fs = rng.uniform(0.75f, 1.25f);
  float fh = rng.uniform(-0.01f, 0.01f);
  // brightness
  for (size_t i = 0; i < n * 3; i++) {
    float v = img[i] * fb;
    img[i] = v < 0 ? 0 : (v > 1 ? 1 : v);
  }
  // contrast: blend with mean gray
  double gsum = 0;
  for (size_t i = 0; i < n; i++)
    gsum += 0.299f * img[i*3] + 0.587f * img[i*3+1] + 0.114f * img[i*3+2];
  float gmean = float(gsum / n);
  for (size_t i = 0; i < n * 3; i++) {
    float v = gmean + fc * (img[i] - gmean);
    img[i] = v < 0 ? 0 : (v > 1 ? 1 : v);
  }
  // saturation: blend with per-pixel gray
  for (size_t i = 0; i < n; i++) {
    float g = 0.299f * img[i*3] + 0.587f * img[i*3+1] + 0.114f * img[i*3+2];
    for (int c = 0; c < 3; c++) {
      float v = g + fs * (img[i*3+c] - g);
      img[i*3+c] = v < 0 ? 0 : (v > 1 ? 1 : v);
    }
  }
  // hue shift via HSV
  if (fh != 0.0f) {
    for (size_t i = 0; i < n; i++) {
      float r = img[i*3], g = img[i*3+1], b = img[i*3+2];
      float mx = std::max(r, std::max(g, b)), mn = std::min(r, std::min(g, b));
      float d = mx - mn, v = mx;
      float sat = mx > 0 ? d / mx : 0.0f;
      float h = 0;
      if (d > 0) {
        if (mx == r) h = (b == mx ? 0 : (g - b) / d);
        else if (mx == g) h = 2.0f + (b - r) / d;
        else h = 4.0f + (r - g) / d;
        h /= 6.0f;
        if (h < 0) h += 1.0f;
      }
      h += fh;
      h -= floorf(h);
      float f6 = h * 6.0f;
      int ii = int(f6) % 6;
      float f = f6 - floorf(f6);
      float p = v * (1 - sat), q = v * (1 - f * sat), t = v * (1 - (1 - f) * sat);
      float rr, gg, bb;
      switch (ii) {
        case 0: rr = v; gg = t; bb = p; break;
        case 1: rr = q; gg = v; bb = p; break;
        case 2: rr = p; gg = v; bb = t; break;
        case 3: rr = p; gg = q; bb = v; break;
        case 4: rr = t; gg = p; bb = v; break;
        default: rr = v; gg = p; bb = q; break;
      }
      img[i*3] = rr; img[i*3+1] = gg; img[i*3+2] = bb;
    }
  }

  // ---- 25-tap separable gaussian blur, sigma U[0.001, 2], reflect padding
  float sigma = rng.uniform(0.001f, 2.0f);
  float w[25];
  double wsum = 0;
  for (int i = -12; i <= 12; i++) {
    w[i + 12] = expf(-0.5f * (i / sigma) * (i / sigma));
    wsum += w[i + 12];
  }
  for (int i = 0; i < 25; i++) w[i] = float(w[i] / wsum);
  float* blur = tmp_b.data();
  auto reflect = [S](int i) { return i < 0 ? -i : (i >= S ? 2 * S - 2 - i : i); };
  for (int y = 0; y < S; y++)
    for (int x = 0; x < S; x++)
      for (int c = 0; c < 3; c++) {
        float acc = 0;
        for (int k = -12; k <= 12; k++)
          acc += w[k + 12] * img[(size_t(y) * S + reflect(x + k)) * 3 + c];
        blur[(size_t(y) * S + x) * 3 + c] = acc;
      }
  for (int y = 0; y < S; y++)
    for (int x = 0; x < S; x++)
      for (int c = 0; c < 3; c++) {
        float acc = 0;
        for (int k = -12; k <= 12; k++)
          acc += w[k + 12] * blur[(size_t(reflect(y + k)) * S + x) * 3 + c];
        img[(size_t(y) * S + x) * 3 + c] = acc;
      }

  // ---- flips
  bool hf = rng.uniform(0, 1) > 0.5f;
  bool vf = rng.uniform(0, 1) > 0.5f;

  // ---- rotation (nearest, fill 0) + normalize, fused into the output write.
  // TF.affine convention: positive angle through the inverse matrix without
  // negation (see tests/test_splits_and_aug.py); symmetric range so direction
  // is immaterial.
  float ang = rng.uniform(-180.0f, 180.0f) * 3.14159265358979f / 180.0f;
  float ca = cosf(ang), sa = sinf(ang);
  float ctr = (S - 1) / 2.0f;
  for (int y = 0; y < S; y++) {
    for (int x = 0; x < S; x++) {
      float xc = x - ctr, yc = y - ctr;
      float sx = ca * xc + sa * yc + ctr;
      float sy = -sa * xc + ca * yc + ctr;
      int ix = int(lrintf(sx)), iy = int(lrintf(sy));
      float px[3] = {0, 0, 0};
      if (ix >= 0 && ix < S && iy >= 0 && iy < S) {
        int rx = hf ? S - 1 - ix : ix;
        int ry = vf ? S - 1 - iy : iy;
        const float* p = img + (size_t(ry) * S + rx) * 3;
        px[0] = p[0]; px[1] = p[1]; px[2] = p[2];
      }
      float* o = dst + (size_t(y) * S + x) * 3;
      for (int c = 0; c < 3; c++) o[c] = (px[c] - kMean[c]) / kStd[c];
    }
  }
}

}  // namespace

extern "C" {

int s4g_augment_classification(void* pool_ptr, const unsigned char* imgs, int n,
                               int S, unsigned long long seed, float* out) {
  ThreadPool* pool = static_cast<ThreadPool*>(pool_ptr);
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; i++) {
    pool->submit([=, &remaining, &done_mu, &done_cv] {
      XorShift rng(seed * 0x9E3779B97F4A7C15ull + i + 1);
      std::vector<float> ta, tb;
      augment_one(imgs + size_t(i) * S * S * 3, S, rng,
                  out + size_t(i) * S * S * 3, ta, tb);
      if (remaining.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return 0;
}

}  // extern "C"
