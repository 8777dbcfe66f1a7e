// Threefry-2x32 (20 rounds) over a draw's counters, for NVIDIA Hopper
// (sm_90a): one launch computes one hash of `rng.py` (`_hash`, `fold_in`).
//
// It replaces no Pallas kernel: jax.random's threefry is XLA's, which fuses
// it into one op.  It was added because the plain version,
// `rng.threefry2x32` in int64 torch ops, is about 171 elementwise launches
// a hash, and those launches set the host's pace on the card's main path
// (8 hashes in every SingleRoom reset).
//
// What bounds it on this card: 78 integer operations of the hash (20
// rounds of add, rotate and xor; 5 key injections of 3 adds; 3 to set up)
// and 16-32 B of output an element.  At the main path's shapes (4096 keys
// x 1-2 elements) that is under 0.1 us of either, so its time is its
// launch latency.  At large draws (`permutation` over 2**20 elements) it
// is bound by the int32 issue rate, 64 lanes a clock per SM: the
// arithmetic stays native uint32 in registers, each rotation one funnel
// shift.  One thread per (key, element), consecutive threads on
// consecutive outputs (coalesced int64 stores), no shared memory.
//
// Element j of key l (j row-major in the local shape) hashes the counter
// words (0, c(j)), c(j) its row-major index in the draw's global shape.
// The local shape is the global one with axis `axis` cut to
// [start, start + local_len): with inner = prod(shape[axis+1:]),
//   r = j % inner, a = (j / inner) % local_len, o = j / inner / local_len,
//   c = (o * global_len + start + a) * inner + r.
// An unsharded draw is inner = 1, start = 0, local_len = global_len = n
// (c = j); fold_in is one element with start = data.  The wrapper keeps
// every global count below 2**32 (the high counter word is 0 there) and
// every launch's total below 2**32 - 256 (no thread index wraps), so
// uint32 arithmetic is exact.

#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) threefry_kernel(
    const int64_t* __restrict__ keys,  // word w of key l: keys[l * key_stride + w * word_stride]
    int64_t key_stride, int64_t word_stride,
    int64_t* __restrict__ out,         // [total] xor, or [total, 2] both words
    uint32_t total, uint32_t n_local, uint32_t inner, uint32_t local_len,
    uint32_t global_len, uint32_t start, int pair) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const uint32_t l = i / n_local;
  const uint32_t j = i - l * n_local;
  const uint32_t q = j / inner;
  const uint32_t c = ((q / local_len) * global_len + start + q % local_len) * inner + j % inner;

  const int64_t* key = keys + static_cast<int64_t>(l) * key_stride;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[word_stride]);
  const uint2 x = threefry2x32(k0, k1, c);
  if (pair) {
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2(x.x, x.y);
  } else {
    out[i] = x.x ^ x.y;
  }
}

}  // namespace

extern "C" int rcw_threefry(
    const void* keys, long long key_stride, long long word_stride, void* out,
    unsigned int total, unsigned int n_local, unsigned int inner,
    unsigned int local_len, unsigned int global_len, unsigned int start,
    int pair, void* stream) {
  const unsigned int blocks = (total + kThreads - 1) / kThreads;
  threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_stride, word_stride,
      static_cast<int64_t*>(out), total, n_local, inner, local_len, global_len, start,
      pair);
  return static_cast<int>(cudaGetLastError());
}
