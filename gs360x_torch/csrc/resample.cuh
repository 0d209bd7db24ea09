// What warp_equirect.cu and remap.cu share: the source layouts their tap
// loops read, the 4-tap weights, and the store that quantizes.
//
// Source layouts. A tap is one source pixel; the loops address it by its
// index row * W + col (32 bits: the C entries refuse C * H * W >= 2^31).
//   Texels: (H, W) RGBX u8, one aligned 4-byte word a pixel (planarize.cu's
//     texel mode). One load gives the three channels of a tap. This is the
//     layout of the u8 main paths: a plane a channel is what the TPU's
//     (8, 128) registers want; on this card three 1-byte loads a tap cost
//     three times the load instructions and the address arithmetic.
//   Planes<T, C>: (C, H, W) u8 or f32, one load a channel. f32 sources (the
//     LUT and colour chains, u16 frames) and single-channel masks arrive so.
//
// The store. Tout = float keeps acc * scale. Tout = u8 / u16 stores
// rint(clamp(acc * scale, 0, 1) * 255 | 65535), half to even: both products
// are rounded on their own (__fmul_rn, no contraction into an FMA), so the
// result is bitwise the plain four-pass quantize (clamp, multiply, round,
// cast) of the f32 store, which then never has to be written or read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs360x {

// A block is 32 x 8 output pixels. The kernels state no minimum of resident
// blocks: ptxas then takes the fewest registers (16-48: five blocks or more
// a multiprocessor). Told that four would do, it took 64, spilled in the
// fisheye kernels, and the gathers over f32 planes, which live on loads in
// flight, ran a fifth slower (SFM10 batch 0.907 against 0.756 ms).
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

enum Kind { KIND_U8 = 0, KIND_U16 = 1, KIND_F32 = 2, KIND_RGBX = 3 };

// Byte k of `word` as f32, exactly, without the conversion unit: the byte
// is placed in the low mantissa bits of 2^23 (one PRMT), and 2^23 + b - 2^23
// is exact. An integer-to-float conversion issues at a quarter of the rate
// of an FADD on this card, and a cubic pixel needs 48 of them.
template <int k>
__device__ __forceinline__ float byte_to_float(uint32_t word) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + k)) -
         8388608.0f;
}

struct Texels {
  static constexpr int kChannels = 3;
  const uint32_t* p;
  __device__ __forceinline__ void fetch(int idx, float (&v)[3]) const {
    const uint32_t t = __ldg(p + idx);
    v[0] = byte_to_float<0>(t);
    v[1] = byte_to_float<1>(t);
    v[2] = byte_to_float<2>(t);
  }
  // the N taps of one source row
  template <int N>
  __device__ __forceinline__ void fetch_row(const int (&idx)[N],
                                            float (&t)[N][3]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) fetch(idx[k], t[k]);
  }
};

template <typename T, int C>
struct Planes {
  static constexpr int kChannels = C;
  const T* p;
  int plane;  // H * W; C * H * W fits 31 bits, so one base pointer serves
  __device__ __forceinline__ float load(int i) const {
    const T v = __ldg(p + i);
    if constexpr (sizeof(T) == 1) {
      return byte_to_float<0>(v);
    } else {
      return v;
    }
  }
  __device__ __forceinline__ void fetch(int idx, float (&v)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = load(c * plane + idx);
  }
  // the N taps of one source row, plane by plane: a row's taps of one plane
  // share a cache line, so they are issued together
  template <int N>
  __device__ __forceinline__ void fetch_row(const int (&idx)[N],
                                            float (&t)[N][C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = 0; k < N; ++k) t[k][c] = load(c * plane + idx[k]);
    }
  }
};

// v360's 4-point Lagrange weights (`bicubic`) or Keys a = -0.5 (catmull-rom)
__device__ __forceinline__ void cubic_weights(float t, float wt[4],
                                              bool lagrange) {
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

// `value` (already scaled to [0, 1] units) as the output type.
template <typename Tout>
__device__ __forceinline__ Tout finish(float value) {
  if constexpr (sizeof(Tout) == 4) {
    return value;
  } else {
    const float full = sizeof(Tout) == 1 ? 255.0f : 65535.0f;
    return static_cast<Tout>(__float2uint_rn(
        __fmul_rn(fminf(fmaxf(value, 0.0f), 1.0f), full)));
  }
}

// One output pixel of every channel: out[c * plane] = finish(acc[c] * scale).
template <typename Tout, int C>
__device__ __forceinline__ void store_pixel(Tout* o, int64_t plane,
                                            const float (&acc)[C],
                                            float scale) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    o[c * plane] = finish<Tout>(__fmul_rn(acc[c], scale));
}

}  // namespace gs360x
