// planarize: interleaved (H, 3*W) rows -> planar (3, H, W), or (u8 only)
// -> (H, W) RGBX texels, one aligned 4-byte word a pixel with X = 0.
//
// Replaces gs360x/kernels/warp_pallas.py: _planarize_mxu_kernel (u8 sources
// with H % 128 == 0, a one-hot bf16 matmul on the MXU) and _planarize_kernel
// (lane gathers), both reached through _planarize_rows. Both compute one
// function: de-interleave RGB rows into three planes; a u8 output keeps the
// bytes verbatim, a float output is float(v) * scale in f32 (scale 1/255,
// 1/65535 or 1). The seam wrap pad and the pole pad of _planar_source stay
// outside: the warp kernel wraps and reflects per tap instead. None of the
// TPU tiling (the one-hot matmul, 384-column blocks, packed planes) carries
// over.
//
// Bound on the H100: bytes. There is no arithmetic to speak of. An 8K u8
// frame (3840 x 7680) is 88.5 MB read and 88.5 MB written, 0.053 ms at the
// published 3.35 TB/s; u8 -> f32 at 8K moves 442 MB, 0.132 ms.
//
// Design. Input and output are both contiguous, so rows do not matter: the
// input is N = H*W pixels of three interleaved values, the output three
// planes of N. The vector path gives each thread a chunk of Q pixels whose
// outputs make exactly one 16-byte store in each plane (Q = 16 for a u8
// output, 4 for f32), so a warp's stores cover 512 contiguous bytes of each
// plane. The chunk's input comes in three loads as wide as it allows (16,
// 4, 8 or 16 bytes for u8->u8, u8->f32, u16->f32, f32->f32) and is
// de-interleaved in registers (__byte_perm for u8 -> u8, shifts otherwise).
// A 1-D grid of one block per 256 chunks, with a grid-stride loop and
// 64-bit offsets, so no grid dimension bounds H or W. On the H100 this runs
// at the rate of the device's own copy (torch clone of the same bytes, ~84%
// of 3.35 TB/s). Q is set by the stores, not the loads: with 16 pixels (48
// input bytes) a thread for every pair, a thread's four f32 stores a plane
// land 64 bytes apart, each warp store fills half of every sector, and
// u8 -> f32 ran at 31% of the bound, slower than the scalar path.
//
// Each thread of the vector path (`regs`) loads its own chunk from device
// memory; the sectors the three strided loads of a warp share are served
// by L1.
//
// The texel mode is the source pass of the u8 main paths: warp_equirect.cu
// and remap.cu read all three channels of a tap with one 4-byte load from
// it. It moves 3 + 4 bytes a pixel (an 8K frame: 206 MB, 0.062 ms at
// 3.35 TB/s). Its chunk is again the pixels of one 16-byte store: 4 texels
// from 12 input bytes (three 4-byte loads, __byte_perm for the shuffle), so
// a warp's store covers 512 contiguous bytes.
//
// Ragged inputs: the vector path needs N % Q == 0 and 16-byte aligned input
// and output bases (8K frames and 3840^2 lenses qualify; the texel mode
// needs N % 4 == 0). Any other input, such as a view with a storage offset,
// takes the scalar path of this file: element loads and stores (one 4-byte
// store a texel), each thread four pixels 256 apart, all loads before any
// store (the shape of torch's own copy kernel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// KIND_RGBX: an output kind only, (H, W) texels of 4 bytes from a u8 input
enum Kind { KIND_U8 = 0, KIND_U16 = 1, KIND_F32 = 2, KIND_RGBX = 3 };
enum Variant { VARIANT_AUTO = -1, VARIANT_SCALAR = 0, VARIANT_REGS = 1 };

constexpr int kThreads = 256;

// ---------------------------------------------------------------- vector

// A chunk is the Q pixels whose outputs make one 16-byte store in each
// plane: 16 pixels for a u8 output, 4 for an f32 output. Its input is three
// loads of kLoad bytes: 16 (u8 -> u8), 4 (u8 -> f32), 8 (u16 -> f32) or 16
// (f32 -> f32).
template <typename Tin, typename Tout>
struct ChunkShape {
  static constexpr int Q = 16 / sizeof(Tout);
  static constexpr int kLoad = Q * sizeof(Tin);
  static constexpr int kBytes = 3 * kLoad;
  static constexpr int kWords = kBytes / 4;
};

// The chunk's input as little-endian words, from device memory (read-only
// path).
template <int kLoad>
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint8_t* p = src + k * kLoad;
    if constexpr (kLoad == 16) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      const uint4 v = __ldg(q);
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    } else if constexpr (kLoad == 8) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 v = __ldg(q);
      w[2 * k] = v.x; w[2 * k + 1] = v.y;
    } else {
      const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
      w[k] = __ldg(q);
    }
  }
}

// Value `idx` of the chunk's interleaved input as f32, before scaling.
template <typename Tin>
__device__ __forceinline__ float value(const uint32_t* w, int idx) {
  if constexpr (sizeof(Tin) == 1) {
    return static_cast<float>((w[idx >> 2] >> (8 * (idx & 3))) & 0xffu);
  } else if constexpr (sizeof(Tin) == 2) {
    return static_cast<float>((w[idx >> 1] >> (16 * (idx & 1))) & 0xffffu);
  } else {
    return __uint_as_float(w[idx]);
  }
}

// One 16-byte store to each plane at `out` (the chunk's first pixel of
// plane 0); planes are `n_pix` apart.
template <typename Tin, typename Tout>
__device__ __forceinline__ void store_chunk(const uint32_t* w, Tout* out,
                                            int64_t n_pix, float scale) {
  if constexpr (sizeof(Tout) == 1) {
    // 16 u8 pixels: every group of 3 words (4 pixels) gives one word of each
    // plane, bytes {0,3,6,9}, {1,4,7,10} and {2,5,8,11} of the group.
    uint32_t r[4], g[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t w0 = w[3 * m], w1 = w[3 * m + 1], w2 = w[3 * m + 2];
      r[m] = __byte_perm(__byte_perm(w0, w1, 0x0630), w2, 0x5210);
      g[m] = __byte_perm(__byte_perm(w0, w1, 0x0741), w2, 0x6210);
      b[m] = __byte_perm(w0, __byte_perm(w1, w2, 0x0741), 0x6542);
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<uint4*>(out + n_pix) = make_uint4(g[0], g[1], g[2], g[3]);
    *reinterpret_cast<uint4*>(out + 2 * n_pix) =
        make_uint4(b[0], b[1], b[2], b[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      *reinterpret_cast<float4*>(out + c * n_pix) =
          make_float4(value<Tin>(w, c) * scale, value<Tin>(w, 3 + c) * scale,
                      value<Tin>(w, 6 + c) * scale,
                      value<Tin>(w, 9 + c) * scale);
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
planarize_regs(const uint8_t* __restrict__ in, Tout* __restrict__ out,
               int64_t n_chunks, int64_t n_pix, float scale) {
  using S = ChunkShape<Tin, Tout>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_chunks; i += stride) {
    uint32_t w[S::kWords];
    load_words<S::kLoad>(in + i * S::kBytes, w);
    store_chunk<Tin, Tout>(w, out + i * S::Q, n_pix, scale);
  }
}

// Texel mode, vector path: a chunk is 4 pixels, 12 input bytes in three
// words (R0G0B0R1 G1B1R2G2 B2R3G3B3) -> one 16-byte store of 4 RGBX texels.
__global__ void __launch_bounds__(kThreads)
texelize_regs(const uint8_t* __restrict__ in, uint4* __restrict__ out,
              int64_t n_chunks) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_chunks; i += stride) {
    uint32_t w[3];
    load_words<4>(in + i * 12, w);
    out[i] = make_uint4(w[0] & 0x00ffffffu,
                        __byte_perm(w[0], w[1], 0x0543) & 0x00ffffffu,
                        __byte_perm(w[1], w[2], 0x0432) & 0x00ffffffu,
                        w[2] >> 8);
  }
}

// ---------------------------------------------------------------- scalar

// A scalar thread moves kUnroll pixels kThreads apart (so each access of a
// warp is coalesced), all loads before any store.
constexpr int kUnroll = 4;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
planarize_scalar(const Tin* __restrict__ in, Tout* __restrict__ out,
                 int64_t n_pix, float scale) {
  constexpr int64_t kTile = kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
       base < n_pix; base += static_cast<int64_t>(gridDim.x) * kTile) {
    Tin v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + u * kThreads;
      if (p < n_pix) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[u][c] = in[3 * p + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + u * kThreads;
      if (p < n_pix) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if constexpr (sizeof(Tout) == 1) {
            out[c * n_pix + p] = v[u][c];
          } else {
            out[c * n_pix + p] = static_cast<float>(v[u][c]) * scale;
          }
        }
      }
    }
  }
}

// Texel mode, scalar path: one pixel a thread, three byte loads and one
// 4-byte store (the output of a fresh allocation is always 4-byte aligned;
// the C entry refuses any other).
__global__ void __launch_bounds__(kThreads)
texelize_scalar(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                int64_t n_pix) {
  constexpr int64_t kTile = kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
       base < n_pix; base += static_cast<int64_t>(gridDim.x) * kTile) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + u * kThreads;
      if (p < n_pix) {
        v[u] = static_cast<uint32_t>(in[3 * p]) |
               (static_cast<uint32_t>(in[3 * p + 1]) << 8) |
               (static_cast<uint32_t>(in[3 * p + 2]) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + u * kThreads;
      if (p < n_pix) out[p] = v[u];
    }
  }
}

// ---------------------------------------------------------------- launch

// Blocks for `items` work items of kThreads each, up to the grid's x limit;
// the kernels stride over anything beyond. One block per tile measured
// faster on the H100 than one striding wave of blocks: at 8K u8 -> u8 the
// regs kernel ran at 0.0633 instead of 0.0690 ms, the rate of the device's
// own copy.
unsigned blocks_for(int64_t items) {
  const int64_t need = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < 0x7fffffff ? need : 0x7fffffff);
}

template <typename Tin, typename Tout>
cudaError_t launch(int variant, const void* rows, void* out, int64_t n_pix,
                   float scale, cudaStream_t stream) {
  const int64_t n_chunks = n_pix / ChunkShape<Tin, Tout>::Q;
  const uint8_t* bytes = static_cast<const uint8_t*>(rows);
  Tout* dst = static_cast<Tout*>(out);
  if (variant == VARIANT_REGS) {
    planarize_regs<Tin, Tout><<<blocks_for(n_chunks), kThreads, 0, stream>>>(
        bytes, dst, n_chunks, n_pix, scale);
  } else {
    const int64_t tiles = (n_pix + kUnroll - 1) / kUnroll;
    planarize_scalar<Tin, Tout><<<blocks_for(tiles), kThreads, 0, stream>>>(
        static_cast<const Tin*>(rows), dst, n_pix, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_texels(int variant, const void* rows, void* out,
                          int64_t n_pix, cudaStream_t stream) {
  const uint8_t* bytes = static_cast<const uint8_t*>(rows);
  if (variant == VARIANT_REGS) {
    const int64_t n_chunks = n_pix / 4;
    texelize_regs<<<blocks_for(n_chunks), kThreads, 0, stream>>>(
        bytes, static_cast<uint4*>(out), n_chunks);
  } else {
    const int64_t tiles = (n_pix + kUnroll - 1) / kUnroll;
    texelize_scalar<<<blocks_for(tiles), kThreads, 0, stream>>>(
        bytes, static_cast<uint32_t*>(out), n_pix);
  }
  return cudaGetLastError();
}

// The vector path's condition: whole chunks (Q = 16 pixels for a u8 output,
// 4 for f32 and for texels) and 16-byte aligned bases.
bool vector_ok(const void* rows, const void* out, int out_kind,
               int64_t n_pix) {
  return reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         n_pix % (out_kind == KIND_U8 ? 16 : 4) == 0;
}

}  // namespace

// The variant gs360x_planarize launches for these pointers and sizes: 1,
// the vector path (regs), or 0, the scalar path.
extern "C" int gs360x_planarize_auto_variant(const void* rows,
                                             const void* out, int out_kind,
                                             int64_t h, int64_t w) {
  return vector_ok(rows, out, out_kind, h * w) ? VARIANT_REGS
                                               : VARIANT_SCALAR;
}

// in_kind: 0 u8, 1 u16, 2 f32. out_kind: 0 u8 planes (u8 input only), 2 f32
// planes, 3 RGBX texels (u8 input only; `out` 4-byte aligned; `scale`
// unused). variant: -1 the automatic choice, 0 scalar, 1 regs (refused for
// an input that does not qualify). Returns a cudaError_t (0 = launched).
extern "C" int gs360x_planarize_variant(const void* rows, int in_kind,
                                        void* out, int out_kind, int64_t h,
                                        int64_t w, float scale, int variant,
                                        void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const int64_t n_pix = h * w;
  if (variant == VARIANT_AUTO) {
    variant = gs360x_planarize_auto_variant(rows, out, out_kind, h, w);
  }
  if (variant != VARIANT_SCALAR && variant != VARIANT_REGS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != VARIANT_SCALAR && !vector_ok(rows, out, out_kind, n_pix)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == KIND_RGBX) {
    if (in_kind != KIND_U8 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_texels(variant, rows, out, n_pix, s));
  }
  if (out_kind == KIND_U8) {
    if (in_kind != KIND_U8) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch<uint8_t, uint8_t>(variant, rows, out, n_pix, scale, s));
  }
  if (out_kind != KIND_F32) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_kind) {
    case KIND_U8:
      return static_cast<int>(
          launch<uint8_t, float>(variant, rows, out, n_pix, scale, s));
    case KIND_U16:
      return static_cast<int>(
          launch<uint16_t, float>(variant, rows, out, n_pix, scale, s));
    case KIND_F32:
      return static_cast<int>(
          launch<float, float>(variant, rows, out, n_pix, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gs360x_planarize(const void* rows, int in_kind, void* out,
                                int out_kind, int64_t h, int64_t w,
                                float scale, void* stream) {
  return gs360x_planarize_variant(rows, in_kind, out, out_kind, h, w, scale,
                                  VARIANT_AUTO, stream);
}
