// planarize: interleaved (H, 3*W) rows -> planar (3, H, W).
//
// Replaces gs360x/kernels/warp_pallas.py: _planarize_mxu_kernel (u8 sources
// with H % 128 == 0, a one-hot bf16 matmul on the MXU) and _planarize_kernel
// (lane gathers), both reached through _planarize_rows. Both compute one
// function: de-interleave RGB rows into three planes; a u8 output keeps the
// bytes verbatim, a float output gets `scale` folded in (1/255, 1/65535 or 1).
// The seam wrap pad and the pole pad of _planar_source stay outside: the
// warp kernel wraps and reflects per tap instead.
//
// Bound on the H100: device memory. An 8K u8 frame is 88.5 MB read and
// 88.5 MB written, no arithmetic to speak of.
//
// Design: one thread per output element (channel, row, column). A warp
// writes 32 consecutive outputs of one plane row (coalesced stores) and
// reads 32 input elements 3 apart, inside a span of 96 elements of one row,
// so every input line it touches is fully used by the block's three
// channel slices through L2. Grid: x over columns, y over rows, z over the
// three channels; 64-bit offsets throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { KIND_U8 = 0, KIND_U16 = 1, KIND_F32 = 2 };

template <typename Tin, typename Tout>
struct Convert;

template <>
struct Convert<uint8_t, uint8_t> {
  __device__ static uint8_t run(uint8_t v, float) { return v; }
};

template <typename Tin>
struct Convert<Tin, float> {
  __device__ static float run(Tin v, float scale) {
    return static_cast<float>(v) * scale;
  }
};

template <typename Tin, typename Tout>
__global__ void planarize_kernel(const Tin* __restrict__ rows,
                                 Tout* __restrict__ out, int64_t h,
                                 int64_t w, float scale) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t y = blockIdx.y;
  const int64_t c = blockIdx.z;
  if (x >= w) return;
  const Tin v = rows[(y * w + x) * 3 + c];
  out[(c * h + y) * w + x] = Convert<Tin, Tout>::run(v, scale);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* rows, void* out, int64_t h, int64_t w,
                   float scale, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((w + threads - 1) / threads),
            static_cast<unsigned>(h), 3);
  planarize_kernel<Tin, Tout><<<grid, threads, 0, stream>>>(
      static_cast<const Tin*>(rows), static_cast<Tout*>(out), h, w, scale);
  return cudaGetLastError();
}

}  // namespace

// in_kind: 0 u8, 1 u16, 2 f32. out_kind: 0 u8 (u8 input only), 2 f32.
// Returns a cudaError_t (0 = launched).
extern "C" int gs360x_planarize(const void* rows, int in_kind, void* out,
                                int out_kind, int64_t h, int64_t w,
                                float scale, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == KIND_U8) {
    if (in_kind != KIND_U8) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<uint8_t, uint8_t>(rows, out, h, w, scale, s));
  }
  if (out_kind != KIND_F32) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_kind) {
    case KIND_U8:
      return static_cast<int>(launch<uint8_t, float>(rows, out, h, w, scale, s));
    case KIND_U16:
      return static_cast<int>(launch<uint16_t, float>(rows, out, h, w, scale, s));
    case KIND_F32:
      return static_cast<int>(launch<float, float>(rows, out, h, w, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
