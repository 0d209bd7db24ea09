// remap: V static coordinate maps over one source (RGBX texels, or C
// planes) -> (V, C, h, w) in f32, u8 or u16, cv2.remap semantics: out =
// valid ? sample(src, u, v) : fill, for nearest, bilinear, bicubic (v360
// 4-point Lagrange) and catmull-rom (Keys a = -0.5). Every tap index clamps
// to the source (no wrap, no reflection), exactly as the plain twin's
// samplers with wrap_x=False (gs360x/kernels/warp.py remap): per-tap
// clamps, except the bilinear second row, which is clamp(clamp(y0) + 1) as
// there.
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
// Bound on the H100: bytes, for either store. The maps cost 8 bytes of
// coordinates and 1 byte of valid an output pixel, read coalesced, beside
// the touched source texels; the f32 store writes 4 * C bytes a pixel, the
// u8 store C. With the u8 store the maps are most of what must move, and
// the operations bound (no trigonometry here: ~84 f32 instructions a cubic
// pixel at 33.5 T a second) stays below it. Undistort and perspective maps are smooth, so a warp's 32
// neighbouring pixels share a few source rows and cache lines.
//
// Design: a block is 32 x 8 output pixels of one map (blockIdx.z = map);
// one thread computes all C channels of its pixel from one set of tap
// indices and weights. A u8 RGB source is read as RGBX texels
// (resample.cuh): one aligned 4-byte load a tap, 16 loads a cubic pixel;
// f32 sources and single-channel masks are planes. Tap columns clamp once a
// pixel, rows once a tap row; indices are 32-bit. The store quantizes
// (resample.cuh `finish`): the dual-fisheye views leave the kernel as u8,
// bitwise the four-pass quantize of the f32 store, `fill` included. Invalid
// pixels write `fill` and read no taps. u8 sources are accumulated as raw
// values and scaled once (`scale`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resample.cuh"

namespace {

using namespace gs360x;

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

template <typename Src, typename Tout, int kInterp>
__global__ void __launch_bounds__(kBlockX * kBlockY)
remap_kernel(Src src, const float* __restrict__ map_x,
             const float* __restrict__ map_y,
             const uint8_t* __restrict__ valid, Tout* __restrict__ out,
             Geometry g) {
  constexpr int C = Src::kChannels;
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int vi = blockIdx.z;
  if (j >= g.out_w || i >= g.out_h) return;

  const int64_t out_plane = static_cast<int64_t>(g.out_h) * g.out_w;
  const int64_t pix = static_cast<int64_t>(vi) * out_plane +
                      static_cast<int64_t>(i) * g.out_w + j;
  Tout* o = out + static_cast<int64_t>(vi) * (C - 1) * out_plane + pix;
  if (valid != nullptr && valid[pix] == 0) {
    const Tout fill = finish<Tout>(g.fill);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c * out_plane] = fill;
    return;
  }
  const float u = map_x[pix];
  const float v = map_y[pix];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  if (kInterp == kNearest) {
    // rintf rounds half to even, like torch.round / jnp.round
    const float xr = fminf(fmaxf(rintf(u), -1.0f), static_cast<float>(g.src_w));
    const float yr = fminf(fmaxf(rintf(v), -1.0f), static_cast<float>(g.src_h));
    src.fetch(clamp_index(static_cast<int>(yr), g.src_h) * g.src_w +
                  clamp_index(static_cast<int>(xr), g.src_w), acc);
  } else if (kInterp == kBilinear) {
    float fx, fy;
    const int x0 = floor_index(u, g.src_w, &fx);
    const int y0 = floor_index(v, g.src_h, &fy);
    const int xa = clamp_index(x0, g.src_w);
    const int xb = clamp_index(x0 + 1, g.src_w);
    const int ya = clamp_index(y0, g.src_h);
    const int yb = clamp_index(ya + 1, g.src_h);
    const int ia[2] = {ya * g.src_w + xa, ya * g.src_w + xb};
    const int ib[2] = {yb * g.src_w + xa, yb * g.src_w + xb};
    float ta[2][C], tb[2][C];
    src.fetch_row(ia, ta);
    src.fetch_row(ib, tb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float top = ta[0][c] * (1.0f - fx) + ta[1][c] * fx;
      const float bot = tb[0][c] * (1.0f - fx) + tb[1][c] * fx;
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
      const int row = clamp_index(y0 + ky - 1, g.src_h) * g.src_w;
      int idx[4];
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) idx[kx] = row + xs[kx];
      float t[4][C];
      src.fetch_row(idx, t);
      float r[C];
#pragma unroll
      for (int c = 0; c < C; ++c) r[c] = 0.0f;
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) r[c] += t[kx][c] * wxs[kx];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += r[c] * wys[ky];
    }
  }
  store_pixel<Tout, C>(o, out_plane, acc, g.scale);
}

struct Launch {
  const float* map_x;
  const float* map_y;
  const uint8_t* valid;
  void* out;
  int n_maps, interp;
  Geometry g;
  cudaStream_t stream;
};

template <typename Src, typename Tout>
void launch_interp(const Src& src, const Launch& l) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((l.g.out_w + kBlockX - 1) / kBlockX,
            (l.g.out_h + kBlockY - 1) / kBlockY, l.n_maps);
  Tout* out = static_cast<Tout*>(l.out);
  switch (l.interp) {
    case kNearest:
      remap_kernel<Src, Tout, kNearest><<<grid, block, 0, l.stream>>>(
          src, l.map_x, l.map_y, l.valid, out, l.g);
      break;
    case kBilinear:
      remap_kernel<Src, Tout, kBilinear><<<grid, block, 0, l.stream>>>(
          src, l.map_x, l.map_y, l.valid, out, l.g);
      break;
    case kBicubic:
      remap_kernel<Src, Tout, kBicubic><<<grid, block, 0, l.stream>>>(
          src, l.map_x, l.map_y, l.valid, out, l.g);
      break;
    default:
      remap_kernel<Src, Tout, kCatmullRom><<<grid, block, 0, l.stream>>>(
          src, l.map_x, l.map_y, l.valid, out, l.g);
      break;
  }
}

template <typename Src>
cudaError_t launch_out(const Src& src, int out_kind, const Launch& l) {
  if (out_kind == KIND_U8) {
    launch_interp<Src, uint8_t>(src, l);
  } else if (out_kind == KIND_U16) {
    launch_interp<Src, uint16_t>(src, l);
  } else {
    launch_interp<Src, float>(src, l);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_planes(const void* src, int channels, int plane,
                          int out_kind, const Launch& l) {
  const T* p = static_cast<const T*>(src);
  if (channels == 1) return launch_out(Planes<T, 1>{p, plane}, out_kind, l);
  return launch_out(Planes<T, 3>{p, plane}, out_kind, l);
}

}  // namespace

// src: src_kind 3 RGBX texels (src_h, src_w) of 4 bytes, 4-byte aligned
// (channels 3), or (channels, src_h, src_w) planes, src_kind 0 u8 / 2 f32,
// channels 1 or 3. map_x, map_y: (n_maps, out_h, out_w) f32; valid:
// (n_maps, out_h, out_w) bytes (0 = fill) or null for all valid. interp:
// 0 nearest, 1 bilinear, 2 bicubic (Lagrange), 3 catmull-rom. out: (n_maps,
// channels, out_h, out_w) of out_kind 0 u8, 1 u16 or 2 f32. Returns a
// cudaError_t (0 = launched).
extern "C" int gs360x_remap(const void* src, int src_kind, int channels,
                            int src_h, int src_w, const void* map_x,
                            const void* map_y, const void* valid, int n_maps,
                            void* out, int out_kind, int out_h, int out_w,
                            int interp, float scale, float fill,
                            void* stream) {
  if (n_maps <= 0 || out_h <= 0 || out_w <= 0) return 0;
  if (src_h <= 0 || src_w <= 0 || n_maps > 65535 || interp < 0 ||
      static_cast<int64_t>(src_h) * src_w * channels > 0x7fffffff ||
      interp > 3 || (channels != 1 && channels != 3) ||
      (out_kind != KIND_U8 && out_kind != KIND_U16 && out_kind != KIND_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{static_cast<const float*>(map_x),
                 static_cast<const float*>(map_y),
                 static_cast<const uint8_t*>(valid), out, n_maps, interp,
                 Geometry{src_h, src_w, out_h, out_w, scale, fill},
                 static_cast<cudaStream_t>(stream)};
  const int plane = src_h * src_w;
  if (src_kind == KIND_RGBX) {
    if (channels != 3 || reinterpret_cast<uintptr_t>(src) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_out(
        Texels{static_cast<const uint32_t*>(src)}, out_kind, l));
  }
  if (src_kind == KIND_U8)
    return static_cast<int>(
        launch_planes<uint8_t>(src, channels, plane, out_kind, l));
  if (src_kind == KIND_F32)
    return static_cast<int>(
        launch_planes<float>(src, channels, plane, out_kind, l));
  return static_cast<int>(cudaErrorInvalidValue);
}
