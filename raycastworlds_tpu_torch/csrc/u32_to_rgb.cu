// RGB conversion for NVIDIA Hopper (sm_90a): one launch computes
// `ops/render.py` `u32_to_rgb` for a whole batch of frames, bit for bit.
//
// It replaces no Pallas kernel: the JAX package's `u32_to_rgb` is a plain
// `jnp` expression (three shifts and masks, a stack, a cast to uint8) that
// XLA fuses into one pass.  The port's plain version runs it eagerly: three
// int32 planes, a stack of them into an int32 [..., 3] tensor with a
// stride-3 inner axis, and a cast of that to uint8, several passes over
// 1-3 GiB intermediates at RandomRoom's [8192, 128, 256] frames.
//
// What bounds it on this card: bytes, 4 read and 3 written a pixel (the
// shifts are a few integer operations a pixel, far below the card's rate).
// The design moves every byte once, as 16-byte accesses: each thread takes
// 16 consecutive pixels, four 16 B loads of the uint32 frame, packs their
// low three bytes (R, G, B in that order, the top byte ignored) into twelve
// 32-bit words with `__byte_perm`, and writes them with three 16 B stores.
// Pixel 16g's output starts at byte 48g, so the stores stay 16 B-aligned
// when the output is.  The grid has a thread for every group, and the
// block scheduler keeps the SMs full.  Measured on the H100 at [8192, 128,
// 256] frames (1.88 GB, a 0.561 ms bound; a device copy runs at 3.0 TB/s):
// this design 0.652 ms; the same with streaming (`__ldcs`/`__stcs`) or
// read-only (`__ldg`) loads 0.714; a grid-stride loop over as many blocks
// as the SMs hold 0.85-0.91; a warp's 512 pixels staged through shared
// memory for fully coalesced accesses 0.657, no faster for the extra code.
// The pixels after the last whole group, and all of them where the input
// or the output is not 16 B-aligned (a view that starts inside an
// allocation), are converted one a thread.
//
// Bytes of a 0x00RRGGBB pixel p in memory (little-endian): 0 = B, 1 = G,
// 2 = R, 3 = the top byte.  `__byte_perm(x, y, s)` picks byte k of its
// result by nibble k of s from the eight bytes x (0-3) and y (4-7), so four
// pixels p0..p3 pack into three words as
//   R0 G0 B0 R1 = __byte_perm(p0, p1, 0x6012)
//   G1 B1 R2 G2 = __byte_perm(p1, p2, 0x5601)
//   B2 R3 G3 B3 = __byte_perm(p2, p3, 0x4560)

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 16;  // a group: 64 B in, 48 B out

__device__ __forceinline__ void pack4(uint32_t p0, uint32_t p1, uint32_t p2, uint32_t p3,
                                      uint32_t& w0, uint32_t& w1, uint32_t& w2) {
  w0 = __byte_perm(p0, p1, 0x6012);
  w1 = __byte_perm(p1, p2, 0x5601);
  w2 = __byte_perm(p2, p3, 0x4560);
}

__global__ void __launch_bounds__(kThreads) u32_to_rgb_kernel(
    const uint32_t* __restrict__ in,  // [n] 0x00RRGGBB
    uint8_t* __restrict__ out,        // [n, 3]
    int64_t n, int64_t groups) {      // groups: whole groups taken as vectors
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < groups) {
    const uint4* in4 = reinterpret_cast<const uint4*>(in) + 4 * t;
    uint4* out4 = reinterpret_cast<uint4*>(out) + 3 * t;
    const uint4 a = in4[0], b = in4[1], c = in4[2], d = in4[3];
    uint4 o0, o1, o2;
    pack4(a.x, a.y, a.z, a.w, o0.x, o0.y, o0.z);
    pack4(b.x, b.y, b.z, b.w, o0.w, o1.x, o1.y);
    pack4(c.x, c.y, c.z, c.w, o1.z, o1.w, o2.x);
    pack4(d.x, d.y, d.z, d.w, o2.y, o2.z, o2.w);
    out4[0] = o0;
    out4[1] = o1;
    out4[2] = o2;
  }
  const int64_t p = groups * kPixelsPerThread + t;  // a pixel no group holds
  if (p < n) {
    const uint32_t v = in[p];
    out[3 * p] = static_cast<uint8_t>(v >> 16);
    out[3 * p + 1] = static_cast<uint8_t>(v >> 8);
    out[3 * p + 2] = static_cast<uint8_t>(v);
  }
}

}  // namespace

extern "C" int rcw_u32_to_rgb(const void* in, void* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0)
                       && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t groups = aligned ? n / kPixelsPerThread : 0;
  const int64_t rest = n - groups * kPixelsPerThread;
  const int64_t threads = groups > rest ? groups : rest;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  u32_to_rgb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint8_t*>(out), n, groups);
  return static_cast<int>(cudaGetLastError());
}
