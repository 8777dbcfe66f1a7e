// Reachability fill for NVIDIA Hopper (sm_90a): one launch computes
// `ops/flood.py` `flood_fill` for every env of a batch, bit for bit.
//
// It replaces no Pallas kernel: the JAX package's fill is a `fori_loop` of
// 4-neighbour dilations that XLA fuses.  It was added because the plain
// version, `flood_fill_plain` in torch ops, is about six elementwise
// launches a dilation, 130 dilations a fill on a 16x16 map, and those ~780
// launches set the host's pace in RandomRoom's reset.
//
// What bounds it on this card: the bytes are one read of the bool map and
// one write of the bool result (2 B a tile), and each round is a handful of
// integer operations a 32-tile word.  At the main path's shapes ([256, 16,
// 16] a budgeted reset, [8192, 16, 16] the first) both are well under a
// microsecond, so its time is the launch and the rounds' barriers.  The
// design keeps every round on the chip: a block packs its envs' maps into
// rows of 32-bit words in shared memory and runs the rounds there, with no
// host work between them, and stops at the first round that changes no word.
//
// Layout: an env's map is H rows of nw = ceil(W / 32) words; bit j % 32 of
// word j / 32 of row i is tile (i, j), and the bits past W stay 0 in the
// passable words, so a round never sets them.  A block holds
// E = max(1, kThreads / (H * nw)) envs (16x16: 8 envs of 16 words); its
// shared memory is the passable words and two buffers of reached words,
// 12 B a word.  A round reads one buffer and writes the other:
//   next[i] = (r[i] | r[i] << 1 | r[i] >> 1 | r[i - nw] | r[i + nw]) & pass[i],
// with the shifts carrying across the words of a row and nothing entering
// from outside the map: exactly one dilation of `flood_fill_plain`.  A round
// that changes no word of the block is a fixed point of every env in it, so
// the later rounds of the plain loop would leave it as it is; the block
// stops there or after `num_iters` rounds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// words of one env's map a block holds (H * ceil(W / 32)); 256 x 256 tiles
// is 2048.  Three buffers of 4096 words are the 48 KiB of shared memory a
// block gets without opting in.
constexpr int kMaxWords = 4096;

__global__ void __launch_bounds__(kThreads) flood_fill_kernel(
    const bool* __restrict__ passable,  // [B, H, W]
    const int32_t* __restrict__ seed,   // [B, 2]: row, column
    bool* __restrict__ out,             // [B, H, W]
    int b, int h, int w, int nw, int envs_per_block, int num_iters) {
  extern __shared__ uint32_t smem[];
  const int n = h * nw;                       // words of one env
  const int words = envs_per_block * n;       // words of the block
  uint32_t* pass = smem;
  uint32_t* cur = smem + words;
  uint32_t* nxt = smem + 2 * words;

  const int env0 = blockIdx.x * envs_per_block;
  const int envs = min(envs_per_block, b - env0);
  const int tiles = h * w;
  const int64_t base = static_cast<int64_t>(env0) * tiles;

  for (int k = threadIdx.x; k < words; k += kThreads) {
    pass[k] = 0u;
    cur[k] = 0u;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < envs * tiles; t += kThreads) {
    if (passable[base + t]) {
      const int e = t / tiles, r = t - e * tiles, i = r / w, j = r - i * w;
      atomicOr(&pass[e * n + i * nw + (j >> 5)], 1u << (j & 31));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < envs; e += kThreads) {
    const int64_t at = 2 * static_cast<int64_t>(env0 + e);
    const int si = seed[at], sj = seed[at + 1];
    if (si >= 0 && si < h && sj >= 0 && sj < w) {
      const int k = e * n + si * nw + (sj >> 5);
      cur[k] = pass[k] & (1u << (sj & 31));
    }
  }
  __syncthreads();

  for (int it = 0; it < num_iters; ++it) {
    int changed = 0;
    for (int k = threadIdx.x; k < words; k += kThreads) {
      const int q = k % n, i = q / nw, c = q - i * nw;
      const uint32_t r = cur[k];
      uint32_t v = r | (r << 1) | (r >> 1);
      if (c > 0) v |= cur[k - 1] >> 31;
      if (c < nw - 1) v |= cur[k + 1] << 31;
      if (i > 0) v |= cur[k - nw];
      if (i < h - 1) v |= cur[k + nw];
      v &= pass[k];
      nxt[k] = v;
      changed |= v != r;
    }
    uint32_t* done = cur;
    cur = nxt;
    nxt = done;
    // a barrier too: every read of the old buffer is over before the next
    // round writes it
    if (!__syncthreads_or(changed)) break;
  }

  for (int t = threadIdx.x; t < envs * tiles; t += kThreads) {
    const int e = t / tiles, r = t - e * tiles, i = r / w, j = r - i * w;
    out[base + t] = (cur[e * n + i * nw + (j >> 5)] >> (j & 31)) & 1u;
  }
}

}  // namespace

extern "C" int rcw_flood_fill(const void* passable, const void* seed, void* out, int b, int h,
                              int w, int num_iters, void* stream) {
  const int nw = (w + 31) / 32;
  const int n = h * nw;
  if (b < 1 || h < 1 || w < 1 || n > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const int envs_per_block = n >= kThreads ? 1 : kThreads / n;
  const int blocks = (b + envs_per_block - 1) / envs_per_block;
  const size_t smem = 3 * sizeof(uint32_t) * envs_per_block * n;
  flood_fill_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(passable), static_cast<const int32_t*>(seed),
      static_cast<bool*>(out), b, h, w, nw, envs_per_block, num_iters);
  return static_cast<int>(cudaGetLastError());
}
