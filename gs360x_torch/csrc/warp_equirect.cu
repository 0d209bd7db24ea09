// warp_equirect: an equirect source (RGBX texels, or 3 planes) -> views
// (V, 3, h, w) in f32, u8 or u16, bicubic (v360 4-point Lagrange) or
// bilinear, for perspective and circular-fisheye (equidistant v360
// "fisheye", equisolid) outputs.
//
// Replaces gs360x/kernels/warp_pallas.py: _warp_kernel_yaw2 (yaw ring),
// _warp_kernel (narrow/tilted views), _warp_kernel_wide3 (poles in view,
// pitched full360coverage views, fisheye outputs) and its fallbacks
// _warp_kernel_wide2 / _warp_kernel_wide, and _warp_kernel_yaw (yaw ring
// v1). The TPU kernels split one function into classes to fit VMEM window
// budgets (one-hot MXU h-pass, de-sheared residual windows, packed planes,
// POLE_PAD rows); none of that carries over. This kernel computes the
// function itself, per output pixel, from the true view size:
//   perspective: d = normalize(nx * tan(hfov/2), ny * tan(vfov/2), 1)
//   fisheye:     r = sqrt(nx^2 + ny^2), theta = r * half (equidistant) or
//                2 asin(clamp(r * sin(half/2))) (equisolid), clipped to
//                [0, pi]; d = (sin(theta) nx/r, sin(theta) ny/r, cos(theta));
//                a pixel with r > 1 is outside the image circle and is 0
//   with nx, ny = (2j+1)/w - 1, (2i+1)/h - 1, then
//   world = R_view * d                      (full 3x3, f32 FMAs)
//   u = (atan2(x, z)/pi + 1) * W/2 - 0.5,  v = (asin(clamp(y))/(pi/2) + 1) * H/2 - 0.5
// then 4x4 (bicubic) or 2x2 (bilinear) taps: every tap column wraps modulo W
// (the longitude seam), and a tap row past a pole reflects over it with a
// W/2 column shift (v360 reflecty, gs360x/kernels/warp.py _reflect_y), so no
// padded copy of the source is needed and no pitch is special.
//
// A launch takes a batch of frames: blockIdx.z = f * V + v, every frame
// warped through the same (V, 16) view table into out[f, v]. Frame f's
// source starts frame_stride elements after frame 0's; that offset is
// added to the base pointer in 64 bits before any tap is read, so the
// 32-bit tap index stays one frame's however many frames a batch holds.
// Planes take a plane stride beside it: planar
// (3, B*H, W), one source pass over a batch's (B*H, 3*W) rows, has frame
// f's plane c at c * B*H*W + f * H*W. Frame f of a batched launch is
// bitwise the single-frame launch on frame f: the same code reads the
// same values. Replaces the frame axis of gs360x/runtime/mesh.py
// warp_frames_sharded_pallas, one Pallas call a frame inside shard_map.
//
// The fisheye rim: r <= 1 decides between 0 and a full value, so nx, ny and
// r are computed with round-to-nearest intrinsics (no FMA contraction), the
// same f32 expression as the plain twin's _pixel_ndc / fisheye_rays: the
// image circle is bitwise the twin's.
//
// Bound on the H100. With the f32 store the bytes that must move bound it
// (12 bytes written a pixel against the touched source texels read once).
// With the u8 store a view set writes a quarter of that and the bound
// becomes its operations: ~138 f32 instructions a bicubic pixel must issue
// (60 tap FMAs, 24 for the weights, ~54 for the ray with atan2 and asin as
// polynomials; chip_smoke.TAP_INSNS_PER_PX), at 33.5 T a second. Built
// without fast math: the approximate atan2f / asinf move u by
// more than 0.01 px at 8K. What it reaches is set by instruction issue, not
// by memory: a bicubic pixel is ~680 instructions, ~470 of them the
// coordinate chain (13 IEEE divisions, sqrt, atan2f, asinf, the weights),
// and the card issues one instruction a clock and scheduler. Measured on
// the yaw ring: with every tap load removed the kernel is 9% faster, with
// atan2f and asinf removed 9% (PERF.md).
//
// Design: a block is 32 x 8 output pixels of one view; a warp is 32
// neighbouring output columns of one row, so its taps fall on a few
// neighbouring source rows and the same cache lines. One thread computes
// the three channels of its pixel from one set of coordinates and weights.
// - A u8 frame is read as RGBX texels (resample.cuh): one aligned 4-byte
//   load a tap gives its three channels, 16 loads a bicubic pixel.
// - No `%`: u lies in [-0.5, W - 0.5], so a tap column lies in [-2, W + 1]
//   and one conditional add and one conditional subtract wrap it; the four
//   wrapped columns are computed once a pixel and serve every row that does
//   not reflect. A reflected row adds W/2 and subtracts W once more where
//   needed. Indices are 32-bit.
// - The store quantizes (resample.cuh `finish`): in image mode the views
//   leave the kernel as u8 or u16, bitwise the four-pass quantize of the f32
//   store. The accumulation order per channel (kx inner, ky outer, then
//   * scale) is the same for every source layout and store.
// u8 sources are accumulated as raw values and scaled once (`scale`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resample.cuh"

namespace {

using namespace gs360x;

// per-view row: rot[0:9], then tan(hfov/2), tan(vfov/2) (perspective) or
// half = hfov/2 in radians, sin(half/2) (fisheye)
constexpr int kTable = 16;
constexpr int kPerspective = 0;
constexpr int kEquidistant = 1;  // v360 output=fisheye ("fisheye_v360")
constexpr int kEquisolid = 2;

struct Geometry {
  int src_h, src_w, out_h, out_w;
  int n_views;
  float scale;
  int64_t frame_stride;  // source elements from one frame to the next
  uint64_t view_magic;   // ceil(2^32 / n_views): see frame_of
};

// The frame of blockIdx.z = f * n_views + v: a multiply-high by
// ceil(2^32 / n_views) = (2^32 + e) / n_views, e < n_views, exact for
// blockIdx.z and n_views below 2^16: the excess blockIdx.z * e /
// (n_views * 2^32) stays under 1 / n_views.
__device__ __forceinline__ int frame_of(int fv, const Geometry& g) {
  return static_cast<int>((static_cast<uint64_t>(fv) * g.view_magic) >> 32);
}

// The source of frame f: its base pointer moved by a 64-bit offset, so
// the tap loops keep one frame's 32-bit index. The empty asm makes the
// moved pointer one value: without it nvcc folds the offset into every
// tap's address (a 64-bit multiply-add, a sign extension and two LEAs a
// tap against one IMAD.WIDE), 11% slower a frame than the kernel without
// a frame offset (PERF.md, the frame axis).
template <typename T>
__device__ __forceinline__ const T* frame_base(const T* p, int64_t offset) {
  p += offset;
  asm("" : "+l"(p));
  return p;
}

__device__ __forceinline__ Texels at_frame(const Texels& s, int64_t offset) {
  return Texels{frame_base(s.p, offset)};
}

template <typename T, int C>
__device__ __forceinline__ Planes<T, C> at_frame(const Planes<T, C>& s,
                                                 int64_t offset) {
  return Planes<T, C>{frame_base(s.p, offset), s.plane};
}

// x modulo w for x in [-w, 2w): every tap column before the pole shift
// lies in [-2, w + 1] (warp_cuda.wrap_tap_column states the rule and its
// range on the host).
__device__ __forceinline__ int wrap_col(int x, int w) {
  x += x < 0 ? w : 0;
  x -= x >= w ? w : 0;
  return x;
}

// v360 reflecty: a row past a pole reflects (`over`), and the sample then
// sits on the opposite meridian, half a width away.
__device__ __forceinline__ int reflect_row(int y, int h, bool* over) {
  *over = y < 0 || y >= h;
  if (y < 0) {
    y = -1 - y;
  } else if (y >= h) {
    y = 2 * h - 1 - y;
  }
  return min(max(y, 0), h - 1);
}

// The pixel indices of one tap row: `cols` (wrapped, unshifted) on the row
// that `y` reflects to, shifted by W/2 and wrapped again where it reflects.
template <int N>
__device__ __forceinline__ void row_taps(int y, const int (&cols)[N],
                                         const Geometry& g, int (&idx)[N]) {
  bool over;
  const int row = reflect_row(y, g.src_h, &over) * g.src_w;
#pragma unroll
  for (int k = 0; k < N; ++k) idx[k] = row + cols[k];
  if (over) {
    const int half = g.src_w / 2;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = cols[k] + half;
      idx[k] = row + (c >= g.src_w ? c - g.src_w : c);
    }
  }
}

// One kernel for one frame and for a batch: blockIdx.z = f * n_views + v,
// frame f's source at at_frame (f = 0 and offset 0 for one frame).
template <typename Src, typename Tout, bool kBicubic, int kProj>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_equirect_kernel(Src batch, const float* __restrict__ views,
                     Tout* __restrict__ out, Geometry g) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int fv = blockIdx.z;  // f * n_views + vi
  if (j >= g.out_w || i >= g.out_h) return;

  const int f = frame_of(fv, g);
  const float* tab = views + (fv - f * g.n_views) * kTable;
  const int64_t out_plane = static_cast<int64_t>(g.out_h) * g.out_w;
  Tout* o = out + static_cast<int64_t>(fv) * 3 * out_plane +
            static_cast<int64_t>(i) * g.out_w + j;

  // pixel center in [-1, 1], rounded exactly as the twin's _pixel_ndc
  const float nx = __fadd_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(j)), 1.0f),
                static_cast<float>(g.out_w)), -1.0f);
  const float ny = __fadd_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(i)), 1.0f),
                static_cast<float>(g.out_h)), -1.0f);

  const float kPi = 3.14159265358979323846f;
  float dx, dy, dz;
  if (kProj == kPerspective) {
    // perspective ray through the pixel center, normalized
    const float px = nx * tab[9];
    const float py = ny * tab[10];
    const float norm = sqrtf(px * px + py * py + 1.0f);
    dx = px / norm;
    dy = py / norm;
    dz = 1.0f / norm;
  } else {
    const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)));
    if (!(r <= 1.0f)) {  // outside the image circle: fill 0
      o[0] = Tout(0);
      o[out_plane] = Tout(0);
      o[2 * out_plane] = Tout(0);
      return;
    }
    float theta = (kProj == kEquidistant)
                      ? r * tab[9]
                      : 2.0f * asinf(fminf(fmaxf(r * tab[10], -1.0f), 1.0f));
    theta = fminf(fmaxf(theta, 0.0f), kPi);
    const float sin_t = sinf(theta);
    const float safe_r = r > 1e-12f ? r : 1.0f;  // no 0/0 at the center
    dx = sin_t * (nx / safe_r);
    dy = sin_t * (ny / safe_r);
    dz = cosf(theta);
  }

  // rotate into the source frame
  const float wx = tab[0] * dx + tab[1] * dy + tab[2] * dz;
  const float wy = tab[3] * dx + tab[4] * dy + tab[5] * dz;
  const float wz = tab[6] * dx + tab[7] * dy + tab[8] * dz;

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

  // the frame's source, formed where the taps start: a 64-bit pointer
  // live across the coordinate chain made ptxas spill in the fisheye
  // kernels over u8 planes
  const Src src = at_frame(batch, static_cast<int64_t>(f) * g.frame_stride);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (kBicubic) {
    float wxs[4], wys[4];
    cubic_weights(fx, wxs, true);
    cubic_weights(fy, wys, true);
    int cols[4];
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) cols[kx] = wrap_col(x0 + kx - 1, g.src_w);
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      int idx[4];
      row_taps(y0 + ky - 1, cols, g, idx);
      float t[4][3];
      src.fetch_row(idx, t);
      float r[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < 3; ++c) r[c] += t[kx][c] * wxs[kx];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] += r[c] * wys[ky];
    }
  } else {
    const int cols[2] = {wrap_col(x0, g.src_w), wrap_col(x0 + 1, g.src_w)};
    int ia[2], ib[2];
    row_taps(y0, cols, g, ia);
    row_taps(y0 + 1, cols, g, ib);
    float ta[2][3], tb[2][3];
    src.fetch_row(ia, ta);
    src.fetch_row(ib, tb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = ta[0][c] * (1.0f - fx) + ta[1][c] * fx;
      const float bot = tb[0][c] * (1.0f - fx) + tb[1][c] * fx;
      acc[c] = top * (1.0f - fy) + bot * fy;
    }
  }
  store_pixel<Tout, 3>(o, out_plane, acc, g.scale);
}

struct Launch {
  const float* views;
  void* out;
  int n_frames, interp, projection;
  Geometry g;
  cudaStream_t stream;
};

template <typename Src, typename Tout, int kProj>
void launch_interp(const Src& src, const Launch& l) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((l.g.out_w + kBlockX - 1) / kBlockX,
            (l.g.out_h + kBlockY - 1) / kBlockY, l.n_frames * l.g.n_views);
  Tout* out = static_cast<Tout*>(l.out);
  if (l.interp == 1) {
    warp_equirect_kernel<Src, Tout, true, kProj><<<grid, block, 0, l.stream>>>(
        src, l.views, out, l.g);
  } else {
    warp_equirect_kernel<Src, Tout, false, kProj><<<grid, block, 0, l.stream>>>(
        src, l.views, out, l.g);
  }
}

template <typename Src, typename Tout>
void launch_proj(const Src& src, const Launch& l) {
  if (l.projection == kPerspective) {
    launch_interp<Src, Tout, kPerspective>(src, l);
  } else if (l.projection == kEquidistant) {
    launch_interp<Src, Tout, kEquidistant>(src, l);
  } else {
    launch_interp<Src, Tout, kEquisolid>(src, l);
  }
}

template <typename Src>
cudaError_t launch_out(const Src& src, int out_kind, const Launch& l) {
  if (out_kind == KIND_U8) {
    launch_proj<Src, uint8_t>(src, l);
  } else if (out_kind == KIND_U16) {
    launch_proj<Src, uint16_t>(src, l);
  } else {
    launch_proj<Src, float>(src, l);
  }
  return cudaGetLastError();
}

}  // namespace

// src_kind: 3 RGBX texels (H, W) of 4 bytes, 4-byte aligned; 0 u8 planes;
// 2 f32 planes (3, H, W). n_frames frames, frame f's source at src +
// f * frame_stride elements (texels or plane elements); plane c of a frame
// at c * plane_stride elements from its start, so (3, H, W) planes of one
// frame have plane_stride H * W and (3, B*H, W) planes of a batch B*H*W.
// Within a frame every tap index must fit 31 bits: 3*H*W and
// 2 * plane_stride + H*W below 2^31. interp: 0 bilinear, 1 bicubic.
// projection: 0 perspective, 1 equidistant fisheye, 2 equisolid fisheye.
// views: (n_views, 16) f32 on the device, shared by every frame. out:
// (n_frames, n_views, 3, out_h, out_w) of out_kind 0 u8, 1 u16 or 2 f32;
// n_frames * n_views <= 65535 (the grid's z). Returns a cudaError_t
// (0 = launched).
extern "C" int gs360x_warp_equirect(const void* src, int src_kind,
                                    int n_frames, int64_t frame_stride,
                                    int64_t plane_stride, int src_h,
                                    int src_w, const void* views, int n_views,
                                    void* out, int out_kind, int out_h,
                                    int out_w, int interp, int projection,
                                    float scale, void* stream) {
  if (n_frames <= 0 || n_views <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const int64_t plane = static_cast<int64_t>(src_h) * src_w;
  // wrap_col needs every tap column within [-w, 2w): w >= 2
  if (src_h <= 0 || src_w < 2 ||
      static_cast<int64_t>(n_frames) * n_views > 65535 ||
      plane * 3 > 0x7fffffff || frame_stride < 0 ||
      (n_frames > 1 && frame_stride < plane) ||
      (interp != 0 && interp != 1) || projection < 0 || projection > 2 ||
      (out_kind != KIND_U8 && out_kind != KIND_U16 && out_kind != KIND_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (src_kind != KIND_RGBX &&
      (plane_stride < plane || 2 * plane_stride + plane > 0x7fffffff))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{static_cast<const float*>(views), out, n_frames, interp,
                 projection,
                 Geometry{src_h, src_w, out_h, out_w, n_views, scale,
                          frame_stride,
                          ((uint64_t{1} << 32) + n_views - 1) / n_views},
                 static_cast<cudaStream_t>(stream)};
  const int planes = static_cast<int>(plane_stride);
  if (src_kind == KIND_RGBX) {
    if (reinterpret_cast<uintptr_t>(src) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_out(
        Texels{static_cast<const uint32_t*>(src)}, out_kind, l));
  }
  if (src_kind == KIND_U8)
    return static_cast<int>(launch_out(
        Planes<uint8_t, 3>{static_cast<const uint8_t*>(src), planes},
        out_kind, l));
  if (src_kind == KIND_F32)
    return static_cast<int>(launch_out(
        Planes<float, 3>{static_cast<const float*>(src), planes}, out_kind,
        l));
  return static_cast<int>(cudaErrorInvalidValue);
}
