// warp_equirect: planar equirect source (3, H, W) -> perspective views
// (V, 3, h, w) f32, bicubic (v360 4-point Lagrange) or bilinear.
//
// Replaces gs360x/kernels/warp_pallas.py: _warp_kernel_yaw2 (called through
// _warp_call_yaw2, host tables from _yaw_host_tables). The TPU kernel splits
// the resample into a one-hot MXU horizontal pass over host-planned windows
// and a Lagrange vertical pass over 64-row tiles; none of that carries over.
// This kernel computes the function itself, per output pixel:
//   ray   = normalize(((2j+1)/w - 1) * tan(hfov/2), ((2i+1)/h - 1) * tan(vfov/2), 1)
//   world = R_view * ray                      (full 3x3, f32 FMAs)
//   u = (atan2(x, z)/pi + 1) * W/2 - 0.5,  v = (asin(clamp(y))/(pi/2) + 1) * H/2 - 0.5
// then 4x4 (bicubic) or 2x2 (bilinear) taps: every tap column wraps modulo W
// (the longitude seam), and a tap row past a pole reflects over it with a
// W/2 column shift (v360 reflecty, gs360x/kernels/warp.py _reflect_y), so no
// padded copy of the source is needed. Nothing here assumes pitch = 0.
//
// Bound on the H100: scattered source reads through L1/L2 (16 taps x 3
// channels per bicubic pixel, ~50 loads against ~12 bytes written), plus
// the atan2/asin of each pixel. Built without fast math: the approximate
// atan2f/asinf move u by more than 0.01 px at 8K.
//
// Design: a block is 32 x 8 output pixels of one view; a warp is 32
// neighbouring output columns of one row, so its taps fall on a few
// neighbouring source rows and the same cache lines. One thread computes
// the three channels of its pixel from one set of coordinates and weights.
// u8 sources are accumulated as raw values and scaled once (`scale`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTable = 16;  // per-view row: rot[0:9], tan(hfov/2), tan(vfov/2)
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Geometry {
  int src_h, src_w, out_h, out_w;
  float scale;
};

__device__ __forceinline__ int wrap_col(int x, int w) {
  int r = x % w;  // C remainder keeps the sign of x
  return r < 0 ? r + w : r;
}

// v360 reflecty: a row past a pole reflects; `shift` gets the half-width
// column shift that carries the sample onto the opposite meridian.
__device__ __forceinline__ int reflect_row(int y, int h, int w, int* shift) {
  int over = 0;
  if (y < 0) {
    y = -1 - y;
    over = 1;
  } else if (y >= h) {
    y = 2 * h - 1 - y;
    over = 1;
  }
  *shift = over ? (w / 2) : 0;
  return min(max(y, 0), h - 1);
}

__device__ __forceinline__ void lagrange(float t, float wt[4]) {
  const float tt = t * t;
  const float ttt = tt * t;
  wt[0] = -t / 3.0f + tt / 2.0f - ttt / 6.0f;
  wt[1] = 1.0f - t / 2.0f - tt + ttt / 2.0f;
  wt[2] = t + tt / 2.0f - ttt / 2.0f;
  wt[3] = -t / 6.0f + ttt / 6.0f;
}

template <typename T, bool kBicubic>
__global__ void warp_equirect_kernel(const T* __restrict__ src,
                                     const float* __restrict__ views,
                                     float* __restrict__ out, Geometry g) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int vi = blockIdx.z;
  if (j >= g.out_w || i >= g.out_h) return;

  const float* tab = views + vi * kTable;
  const float tanh_ = tab[9];
  const float tanv_ = tab[10];

  // perspective ray through the pixel center, normalized
  const float nx = ((2.0f * j + 1.0f) / g.out_w - 1.0f) * tanh_;
  const float ny = ((2.0f * i + 1.0f) / g.out_h - 1.0f) * tanv_;
  const float norm = sqrtf(nx * nx + ny * ny + 1.0f);
  const float dx = nx / norm, dy = ny / norm, dz = 1.0f / norm;

  // rotate into the source frame
  const float wx = tab[0] * dx + tab[1] * dy + tab[2] * dz;
  const float wy = tab[3] * dx + tab[4] * dy + tab[5] * dz;
  const float wz = tab[6] * dx + tab[7] * dy + tab[8] * dz;

  const float kPi = 3.14159265358979323846f;
  const float phi = atan2f(wx, wz);
  const float theta = asinf(fminf(fmaxf(wy, -1.0f), 1.0f));
  const float u = (phi / kPi + 1.0f) * (g.src_w / 2.0f) - 0.5f;
  const float v = (theta / (kPi / 2.0f) + 1.0f) * (g.src_h / 2.0f) - 0.5f;

  const float x0f = floorf(u);
  const float y0f = floorf(v);
  const float fx = u - x0f;
  const float fy = v - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);

  const int64_t plane = static_cast<int64_t>(g.src_h) * g.src_w;
  const T* p0 = src;
  const T* p1 = src + plane;
  const T* p2 = src + 2 * plane;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;

  if (kBicubic) {
    float wxs[4], wys[4];
    lagrange(fx, wxs);
    lagrange(fy, wys);
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      int shift;
      const int yy = reflect_row(y0 + ky - 1, g.src_h, g.src_w, &shift);
      const int64_t row = static_cast<int64_t>(yy) * g.src_w;
      float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int64_t idx = row + wrap_col(x0 + kx - 1 + shift, g.src_w);
        r0 += static_cast<float>(p0[idx]) * wxs[kx];
        r1 += static_cast<float>(p1[idx]) * wxs[kx];
        r2 += static_cast<float>(p2[idx]) * wxs[kx];
      }
      acc0 += r0 * wys[ky];
      acc1 += r1 * wys[ky];
      acc2 += r2 * wys[ky];
    }
  } else {
    int sh0, sh1;
    const int ya = reflect_row(y0, g.src_h, g.src_w, &sh0);
    const int yb = reflect_row(y0 + 1, g.src_h, g.src_w, &sh1);
    const int64_t ra = static_cast<int64_t>(ya) * g.src_w;
    const int64_t rb = static_cast<int64_t>(yb) * g.src_w;
    const int64_t i00 = ra + wrap_col(x0 + sh0, g.src_w);
    const int64_t i01 = ra + wrap_col(x0 + 1 + sh0, g.src_w);
    const int64_t i10 = rb + wrap_col(x0 + sh1, g.src_w);
    const int64_t i11 = rb + wrap_col(x0 + 1 + sh1, g.src_w);
    const T* planes[3] = {p0, p1, p2};
    float accs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* p = planes[c];
      const float top = static_cast<float>(p[i00]) * (1.0f - fx) +
                        static_cast<float>(p[i01]) * fx;
      const float bot = static_cast<float>(p[i10]) * (1.0f - fx) +
                        static_cast<float>(p[i11]) * fx;
      accs[c] = top * (1.0f - fy) + bot * fy;
    }
    acc0 = accs[0];
    acc1 = accs[1];
    acc2 = accs[2];
  }

  const int64_t out_plane = static_cast<int64_t>(g.out_h) * g.out_w;
  float* o = out + static_cast<int64_t>(vi) * 3 * out_plane +
             static_cast<int64_t>(i) * g.out_w + j;
  o[0] = acc0 * g.scale;
  o[out_plane] = acc1 * g.scale;
  o[2 * out_plane] = acc2 * g.scale;
}

template <typename T>
cudaError_t launch(const void* src, const float* views, float* out,
                   int n_views, int interp, const Geometry& g,
                   cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((g.out_w + kBlockX - 1) / kBlockX,
            (g.out_h + kBlockY - 1) / kBlockY, n_views);
  if (interp == 1) {
    warp_equirect_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(src), views, out, g);
  } else {
    warp_equirect_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(src), views, out, g);
  }
  return cudaGetLastError();
}

}  // namespace

// src_kind: 0 u8 planes, 2 f32 planes. interp: 0 bilinear, 1 bicubic.
// views: (n_views, 16) f32 on the device. out: (n_views, 3, out_h, out_w) f32.
// Returns a cudaError_t (0 = launched).
extern "C" int gs360x_warp_equirect(const void* src, int src_kind, int src_h,
                                    int src_w, const void* views, int n_views,
                                    void* out, int out_h, int out_w,
                                    int interp, float scale, void* stream) {
  if (n_views <= 0 || out_h <= 0 || out_w <= 0) return 0;
  if (src_h <= 0 || src_w <= 0 || n_views > 65535 || (interp != 0 && interp != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{src_h, src_w, out_h, out_w, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(views);
  float* o = static_cast<float*>(out);
  if (src_kind == 0) return static_cast<int>(launch<uint8_t>(src, tab, o, n_views, interp, g, s));
  if (src_kind == 2) return static_cast<int>(launch<float>(src, tab, o, n_views, interp, g, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
