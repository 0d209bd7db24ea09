// remap: V static coordinate maps over one planar source (C, H, W) ->
// (V, C, h, w) f32, cv2.remap semantics: out = valid ? sample(src, u, v)
// : fill, for nearest, bilinear, bicubic (v360 4-point Lagrange) and
// catmull-rom (Keys a = -0.5). Every tap index clamps to the source (no
// wrap, no reflection), exactly as the plain twin's samplers with
// wrap_x=False (gs360x/kernels/warp.py remap): per-tap clamps, except the
// bilinear second row, which is clamp(clamp(y0) + 1) as there.
//
// Replaces gs360x/kernels/remap_pallas.py: _remap_kernel (one map, the
// dual-fisheye tool's undistort and per-view remaps) and
// _remap_kernel_wide3 (V maps over one source in one launch, the SFM10
// lens chain). The TPU kernels plan per-tile source windows on the host
// (plan_remap_tiles, plan_remap_wide3), pad maps to 16x128 tiles, pack u8
// planes into one f32 plane and branch into a chunked sweep where a tile's
// taps spread too far; none of that carries over. This kernel reads each
// pixel's (u, v) from the maps and gathers its taps through L1/L2.
//
// Bound on the H100: device memory for the maps (8 bytes of coordinates +
// 1 byte of valid per output pixel read, 4 * C bytes written) plus the
// scattered tap reads (16 * C for the cubic kernels). Undistort and
// perspective maps are smooth, so a warp's 32 neighbouring pixels share
// a few source rows and cache lines.
//
// Design: a block is 32 x 8 output pixels of one map (blockIdx.z = map);
// one thread computes all C channels of its pixel from one set of tap
// indices and weights. Invalid pixels write `fill` and read no taps. u8
// sources are accumulated as raw values and scaled once (`scale`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kNearest = 0;
constexpr int kBilinear = 1;
constexpr int kBicubic = 2;
constexpr int kCatmullRom = 3;

struct Geometry {
  int src_h, src_w, out_h, out_w;
  float scale, fill;
};

// Clamp a coordinate's integer part into [-16, n + 16] before the int
// conversion: every tap of a coordinate further out clamps to the edge
// anyway, so the result is unchanged and no conversion overflows.
__device__ __forceinline__ int floor_index(float x, int n, float* frac) {
  const float xf = floorf(x);
  *frac = x - xf;
  return static_cast<int>(fminf(fmaxf(xf, -16.0f), static_cast<float>(n) + 16.0f));
}

__device__ __forceinline__ int clamp_index(int x, int n) {
  return min(max(x, 0), n - 1);
}

__device__ __forceinline__ void cubic_weights(float t, float wt[4], bool lagrange) {
  const float tt = t * t;
  const float ttt = tt * t;
  if (lagrange) {
    wt[0] = -t / 3.0f + tt / 2.0f - ttt / 6.0f;
    wt[1] = 1.0f - t / 2.0f - tt + ttt / 2.0f;
    wt[2] = t + tt / 2.0f - ttt / 2.0f;
    wt[3] = -t / 6.0f + ttt / 6.0f;
  } else {
    wt[0] = -0.5f * ttt + tt - 0.5f * t;
    wt[1] = 1.5f * ttt - 2.5f * tt + 1.0f;
    wt[2] = -1.5f * ttt + 2.0f * tt + 0.5f * t;
    wt[3] = 0.5f * ttt - 0.5f * tt;
  }
}

template <typename T, int C, int kInterp>
__global__ void remap_kernel(const T* __restrict__ src,
                             const float* __restrict__ map_x,
                             const float* __restrict__ map_y,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ out, Geometry g) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int vi = blockIdx.z;
  if (j >= g.out_w || i >= g.out_h) return;

  const int64_t out_plane = static_cast<int64_t>(g.out_h) * g.out_w;
  const int64_t pix = static_cast<int64_t>(vi) * out_plane +
                      static_cast<int64_t>(i) * g.out_w + j;
  float* o = out + static_cast<int64_t>(vi) * (C - 1) * out_plane + pix;
  if (valid != nullptr && valid[pix] == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c * out_plane] = g.fill;
    return;
  }
  const float u = map_x[pix];
  const float v = map_y[pix];
  const int64_t plane = static_cast<int64_t>(g.src_h) * g.src_w;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  if (kInterp == kNearest) {
    // rintf rounds half to even, like torch.round / jnp.round
    const float xr = fminf(fmaxf(rintf(u), -1.0f), static_cast<float>(g.src_w));
    const float yr = fminf(fmaxf(rintf(v), -1.0f), static_cast<float>(g.src_h));
    const int64_t idx =
        static_cast<int64_t>(clamp_index(static_cast<int>(yr), g.src_h)) * g.src_w +
        clamp_index(static_cast<int>(xr), g.src_w);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = static_cast<float>(src[c * plane + idx]);
  } else if (kInterp == kBilinear) {
    float fx, fy;
    const int x0 = floor_index(u, g.src_w, &fx);
    const int y0 = floor_index(v, g.src_h, &fy);
    const int xa = clamp_index(x0, g.src_w);
    const int xb = clamp_index(x0 + 1, g.src_w);
    const int ya = clamp_index(y0, g.src_h);
    const int yb = clamp_index(ya + 1, g.src_h);
    const int64_t ra = static_cast<int64_t>(ya) * g.src_w;
    const int64_t rb = static_cast<int64_t>(yb) * g.src_w;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T* p = src + c * plane;
      const float top = static_cast<float>(p[ra + xa]) * (1.0f - fx) +
                        static_cast<float>(p[ra + xb]) * fx;
      const float bot = static_cast<float>(p[rb + xa]) * (1.0f - fx) +
                        static_cast<float>(p[rb + xb]) * fx;
      acc[c] = top * (1.0f - fy) + bot * fy;
    }
  } else {
    float fx, fy, wxs[4], wys[4];
    const int x0 = floor_index(u, g.src_w, &fx);
    const int y0 = floor_index(v, g.src_h, &fy);
    cubic_weights(fx, wxs, kInterp == kBicubic);
    cubic_weights(fy, wys, kInterp == kBicubic);
    int xs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xs[k] = clamp_index(x0 + k - 1, g.src_w);
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      const int64_t row =
          static_cast<int64_t>(clamp_index(y0 + ky - 1, g.src_h)) * g.src_w;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T* p = src + c * plane + row;
        float r = 0.0f;
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) r += static_cast<float>(p[xs[kx]]) * wxs[kx];
        acc[c] += r * wys[ky];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) o[c * out_plane] = acc[c] * g.scale;
}

template <typename T, int C>
void launch_c(const T* src, const float* mx, const float* my,
              const uint8_t* valid, float* out, int n_maps, int interp,
              const Geometry& g, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((g.out_w + kBlockX - 1) / kBlockX,
            (g.out_h + kBlockY - 1) / kBlockY, n_maps);
  switch (interp) {
    case kNearest:
      remap_kernel<T, C, kNearest><<<grid, block, 0, stream>>>(src, mx, my, valid, out, g);
      break;
    case kBilinear:
      remap_kernel<T, C, kBilinear><<<grid, block, 0, stream>>>(src, mx, my, valid, out, g);
      break;
    case kBicubic:
      remap_kernel<T, C, kBicubic><<<grid, block, 0, stream>>>(src, mx, my, valid, out, g);
      break;
    default:
      remap_kernel<T, C, kCatmullRom><<<grid, block, 0, stream>>>(src, mx, my, valid, out, g);
      break;
  }
}

template <typename T>
cudaError_t launch(const void* src, int channels, const float* mx,
                   const float* my, const uint8_t* valid, float* out,
                   int n_maps, int interp, const Geometry& g,
                   cudaStream_t stream) {
  const T* s = static_cast<const T*>(src);
  if (channels == 1) {
    launch_c<T, 1>(s, mx, my, valid, out, n_maps, interp, g, stream);
  } else {
    launch_c<T, 3>(s, mx, my, valid, out, n_maps, interp, g, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// src: (channels, src_h, src_w) planes, src_kind 0 u8 / 2 f32; channels 1
// or 3. map_x, map_y: (n_maps, out_h, out_w) f32; valid: (n_maps, out_h,
// out_w) bytes (0 = fill) or null for all valid. interp: 0 nearest,
// 1 bilinear, 2 bicubic (Lagrange), 3 catmull-rom. out: (n_maps, channels,
// out_h, out_w) f32. Returns a cudaError_t (0 = launched).
extern "C" int gs360x_remap(const void* src, int src_kind, int channels,
                            int src_h, int src_w, const void* map_x,
                            const void* map_y, const void* valid, int n_maps,
                            void* out, int out_h, int out_w, int interp,
                            float scale, float fill, void* stream) {
  if (n_maps <= 0 || out_h <= 0 || out_w <= 0) return 0;
  if (src_h <= 0 || src_w <= 0 || n_maps > 65535 || interp < 0 ||
      interp > 3 || (channels != 1 && channels != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{src_h, src_w, out_h, out_w, scale, fill};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(map_x);
  const float* my = static_cast<const float*>(map_y);
  const uint8_t* vb = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (src_kind == 0)
    return static_cast<int>(launch<uint8_t>(src, channels, mx, my, vb, o, n_maps, interp, g, s));
  if (src_kind == 2)
    return static_cast<int>(launch<float>(src, channels, mx, my, vb, o, n_maps, interp, g, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
