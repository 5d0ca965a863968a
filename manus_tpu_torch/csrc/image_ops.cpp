// Host-side batch assembly for the BRICS dynamic loader
// (manus_tpu_torch/data/prefetch.py assemble_batch_native): paste each
// view's RGBA bbox crop into a full frame, convert uint8 to float,
// composite over the background colour, and box-downscale by an integer
// factor, one thread per view. Plain host code with a C interface, loaded
// with ctypes; a crop that leaves the frame is clipped to it.
//
// Build (utils/cuda_build.py does it at first use):
//   g++ -O3 -shared -fPIC -pthread -o libimage_ops.so image_ops.cpp
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct CropJob {
  const uint8_t* crop;  // [ch, cw, 4] RGBA
  int32_t xmin, ymin, xmax, ymax;
};

// Assemble one view: paste crop, composite over bg, emit float rgb + mask.
void assemble_one(const CropJob& job, int H, int W, const float* bg,
                  float* rgb_out, float* mask_out) {
  // background fill
  for (int i = 0; i < H * W; ++i) {
    rgb_out[i * 3 + 0] = bg[0];
    rgb_out[i * 3 + 1] = bg[1];
    rgb_out[i * 3 + 2] = bg[2];
    mask_out[i] = 0.f;
  }
  const int cw = job.xmax - job.xmin;
  const int ch = job.ymax - job.ymin;
  if (cw <= 0 || ch <= 0) return;
  constexpr float inv255 = 1.f / 255.f;
  for (int y = 0; y < ch; ++y) {
    const int oy = y + job.ymin;
    if (oy < 0 || oy >= H) continue;
    const uint8_t* src = job.crop + (size_t)y * cw * 4;
    for (int x = 0; x < cw; ++x) {
      const int ox = x + job.xmin;
      if (ox < 0 || ox >= W) continue;
      const size_t o = (size_t)oy * W + ox;
      const float a = src[x * 4 + 3] * inv255;
      const float r = src[x * 4 + 0] * inv255;
      const float g = src[x * 4 + 1] * inv255;
      const float b = src[x * 4 + 2] * inv255;
      rgb_out[o * 3 + 0] = r * a + bg[0] * (1.f - a);
      rgb_out[o * 3 + 1] = g * a + bg[1] * (1.f - a);
      rgb_out[o * 3 + 2] = b * a + bg[2] * (1.f - a);
      mask_out[o] = a;
    }
  }
}

// Box-filter downscale by integer factor (INTER_AREA-style for the common
// resize_factor = 1/k case).
void box_downscale(const float* src, int H, int W, int C, int k, float* dst) {
  const int h2 = H / k, w2 = W / k;
  const float inv = 1.f / (k * k);
  for (int y = 0; y < h2; ++y) {
    for (int x = 0; x < w2; ++x) {
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int dy = 0; dy < k; ++dy) {
          const float* row = src + (((size_t)(y * k + dy) * W) + x * k) * C + c;
          for (int dx = 0; dx < k; ++dx) acc += row[(size_t)dx * C];
        }
        dst[((size_t)y * w2 + x) * C + c] = acc * inv;
      }
    }
  }
}

void parallel_for_impl(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  const int workers = std::min(n_threads, n);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}
}  // namespace

extern "C" {

// Assemble a batch of V views.
//   crops:   concatenated RGBA crop bytes (offsets gives each start)
//   bboxes:  [V, 4] int32 (xmin, ymin, xmax, ymax)
//   bg:      [3] float
//   rgb_out: [V, H/k, W/k, 3] float32
//   mask_out:[V, H/k, W/k, 1] float32
// k is an integer downscale factor (1 = none). Returns 0 on success.
int assemble_batch(const uint8_t* crops, const int64_t* offsets,
                   const int32_t* bboxes, int V, int H, int W, int k,
                   const float* bg, float* rgb_out, float* mask_out,
                   int n_threads) {
  if (k < 1 || H % k || W % k) return -1;
  const int h2 = H / k, w2 = W / k;
  const bool resize = k > 1;
  parallel_for_impl(V, n_threads, [&](int v) {
    CropJob job;
    job.crop = crops + offsets[v];
    job.xmin = bboxes[v * 4 + 0];
    job.ymin = bboxes[v * 4 + 1];
    job.xmax = bboxes[v * 4 + 2];
    job.ymax = bboxes[v * 4 + 3];
    float* rgb_dst = rgb_out + (size_t)v * h2 * w2 * 3;
    float* mask_dst = mask_out + (size_t)v * h2 * w2;
    if (!resize) {
      assemble_one(job, H, W, bg, rgb_dst, mask_dst);
    } else {
      std::vector<float> full_rgb((size_t)H * W * 3);
      std::vector<float> full_mask((size_t)H * W);
      assemble_one(job, H, W, bg, full_rgb.data(), full_mask.data());
      box_downscale(full_rgb.data(), H, W, 3, k, rgb_dst);
      box_downscale(full_mask.data(), H, W, 1, k, mask_dst);
    }
  });
  return 0;
}

}  // extern "C"
