// Host loop, no kernel: a decoded frame's RGBX texels packed to RGB.
//
// Replaces no TPU kernel: the JAX package packs an MJPEG frame with
// Pillow's convert("RGB"), whose copy holds the GIL. perspcut's video mode
// decodes each MJPEG-AVI frame into Pillow's own block, (H, W, 4) RGBX with
// X = 255 (io/video.decode_jpeg_frame), on a pool of host threads; this
// loop packs the block to the C-contiguous (H, W, 3) frame the batch
// stacks. It runs on the calling thread, and ctypes releases the GIL for
// the call, so the pool's threads pack side by side.
//
// Bound by host memory: 4 bytes read and 3 written a pixel, 231 MB an 8K
// frame. Four pixels a step: four 32-bit loads, three 32-bit stores, the
// shifts that drop X (little-endian words, as on every host the card sits
// in); the tail of n % 4 pixels byte by byte.

#include <cstdint>
#include <cstring>

extern "C" void gs360x_pack_rgb(const uint8_t* src, uint8_t* dst, int64_t n) {
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    uint32_t p[4];
    std::memcpy(p, src + 4 * i, sizeof p);
    const uint32_t q[3] = {(p[0] & 0xFFFFFFu) | (p[1] << 24),
                           ((p[1] >> 8) & 0xFFFFu) | (p[2] << 16),
                           ((p[2] >> 16) & 0xFFu) | (p[3] << 8)};
    std::memcpy(dst + 3 * i, q, sizeof q);
  }
  for (; i < n; ++i) {
    dst[3 * i] = src[4 * i];
    dst[3 * i + 1] = src[4 * i + 1];
    dst[3 * i + 2] = src[4 * i + 2];
  }
}
