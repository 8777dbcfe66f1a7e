// Maze's reset for NVIDIA Hopper (sm_90a): one launch computes
// `models/maze.py` `Maze.reset_batch` for every key of a batch, every field
// of the fresh `EnvState`, bit for bit with `reset_batch_plain`.
//
// It replaces no Pallas kernel: the JAX package's `models/maze.py` is `jnp`
// code that XLA fuses.  It was added because the plain generator (the
// carve, the rooms, `sampling.sample_empty_tile_pair`, the heading,
// `bitmap.pack_bits`) is about 340 launches a call, 30 of them threefry,
// and under a reset budget those launches set the host's pace on every
// step, whatever the traffic does.
//
// What bounds it on this card: about 122 hashes of 78 integer operations
// (17x17, 3 rooms), some hundred more for the map and the draws, and about
// 100 B written an env.  At the main path's shapes (512 keys a budgeted
// step, 32768 at the first reset) both are far under its launch latency,
// so the design does everything in one launch and reads nothing back to
// the host.  One warp a maze, several mazes a block:
//   * the draws that do not depend on the map go to lanes of their own
//     (lane q < 5 holds `split(key, 5)[q]`; lanes 2-4 the goal's, spawn's
//     and heading's uniform bits), the rest is read with `__shfl_sync`;
//   * the carve makes one flat word of the packed map a step: lane l takes
//     tile 32 q + l of the row-major map and a `__ballot_sync` is word q,
//     the layout of `ops/bitmap.py` (bits past H * W are 0);
//   * the rooms are drawn 32 at a time, one a lane, and cleared one after
//     another, a row a lane, with `atomicAnd` on the words in shared memory
//     (rows share words where W < 32 or a row straddles a word);
//   * the open tiles' prefix count is a `__popc` a word and a warp scan;
//     the lane whose word holds the k-th open tile picks its bit;
//   * the words are stored coalesced, lane l word 32 t + l.
//
// The draws follow `rng.py`'s counters: split(key, 5) -> next, map, goal,
// spawn, heading; split(map) -> coin, rooms; the coins are
// `uniform(coin, (CH, CW)) < float32(0.5)`; split(rooms, R)[r] is room r,
// split of it the centre's and half-extents' keys, each a `randint` of
// shape (2,) (`split` of its key, a word from each, JAX's double-width
// remainder in uint32).  The float steps are written with `__fmul_rn` /
// `__fadd_rn`, as eager torch rounds them (no FMA contraction).

#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;  // mazes a block, one warp each
constexpr int kThreads = 32 * kWarps;
// words of one maze's packed map (ceil(H * W / 32)) a warp holds in shared
// memory: every map up to 361 x 361 tiles.
constexpr int kMaxWords = 4096;
// shared memory a block gets without opting in: 48 KiB
constexpr int kSmemWords = 12288;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ Key split_key(Key k, uint32_t i) {
  const uint2 x = threefry2x32(k.k0, k.k1, i);
  return {x.x, x.y};
}

// `rng.random_bits`: 32 bits of element c.
__device__ __forceinline__ uint32_t bits(Key k, uint32_t c) {
  const uint2 x = threefry2x32(k.k0, k.k1, c);
  return x.x ^ x.y;
}

__device__ __forceinline__ Key shfl_key(Key k, int lane) {
  return {__shfl_sync(kFull, k.k0, lane), __shfl_sync(kFull, k.k1, lane)};
}

// `rng.uniform` in [0, 1): the top 23 bits fill the mantissa of a float in
// [1, 2), minus 1 (exact).  Its scale by 1 - 0 and shift by 0 are exact too.
__device__ __forceinline__ float unit_float(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// `rng.randint`'s offset in [0, span) from its two words: JAX's
// double-width remainder identity, every product wrapping at 2**32.
__device__ __forceinline__ uint32_t randint_offset(uint32_t higher, uint32_t lower,
                                                  uint32_t span) {
  uint32_t m = 65536u % span;
  m = (m * m) % span;
  return ((higher % span) * m + lower % span) % span;
}

// `rng.randint` of element c of a draw from `key`.
__device__ __forceinline__ uint32_t randint_at(Key key, uint32_t c, uint32_t span) {
  return randint_offset(bits(split_key(key, 0), c), bits(split_key(key, 1), c), span);
}

// `rng.randint` of shape (2,) from `key`: both offsets, one split.
__device__ __forceinline__ void randint2(Key key, uint32_t span0, uint32_t span1,
                                         uint32_t& o0, uint32_t& o1) {
  const Key hk = split_key(key, 0), lk = split_key(key, 1);
  o0 = randint_offset(bits(hk, 0), bits(lk, 0), span0);
  o1 = randint_offset(bits(hk, 1), bits(lk, 1), span1);
}

// randint's span of [lo, hi): 1 where hi <= lo.
__device__ __forceinline__ uint32_t span_of(long long lo, long long hi) {
  return hi <= lo ? 1u : static_cast<uint32_t>(hi - lo);
}

// `sampling._rank_draw`: clip(floor(u * n), 0, max(n - 1, 0)) in float32.
__device__ __forceinline__ float rank_draw(float u, float n) {
  const float hi = fmaxf(__fsub_rn(n, 1.0f), 0.0f);
  return fminf(fmaxf(floorf(__fmul_rn(u, n)), 0.0f), hi);
}

// The binary-tree rule at one coin: `uniform(coin, (CH, CW))[c] < 0.5`.
__device__ __forceinline__ bool coin(Key k_coin, uint32_t c) {
  return unit_float(bits(k_coin, c)) < 0.5f;
}

// Position of the k-th (0-based) set bit of m; m has more than k.
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
  for (; k > 0; --k) m &= m - 1u;
  return __ffs(m) - 1;
}

__global__ void __launch_bounds__(kThreads) maze_reset_kernel(
    const int64_t* __restrict__ keys,  // word v of key l: keys[l * key_stride + v * word_stride]
    int64_t key_stride, int64_t word_stride,
    int32_t* __restrict__ wall_words,  // [B, nw] packed walls
    int32_t* __restrict__ goal_tu,     // [B, 2]
    void* __restrict__ pos_wu,         // [B, 2] float32, or float64 (f64)
    int32_t* __restrict__ dir_au,      // [B] int32, or float32 bits (continuous)
    float* __restrict__ reward,        // [B] 0
    bool* __restrict__ done,           // [B] false
    int64_t* __restrict__ rng_key,     // [B, 2] split(key, 5)[0]
    int32_t* __restrict__ t,           // [B] 0
    float* __restrict__ episode_return,  // [B] 0
    bool* __restrict__ pending_reset,  // [B] false
    int b, int h, int w, int nw, int warps_per_block, int num_rooms, int room_max_half,
    int num_directions, int continuous, int f64) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * warps_per_block + warp;
  if (env >= b) return;  // the whole warp
  uint32_t* words = smem + warp * nw;
  const int tiles = h * w;
  const int cw = (w - 1) / 2;

  const int64_t* kp = keys + static_cast<int64_t>(env) * key_stride;
  const Key key = {static_cast<uint32_t>(kp[0]), static_cast<uint32_t>(kp[word_stride])};
  // split(key, 5): lane q < 5 holds key q (next, map, goal, spawn, heading)
  const Key sub = split_key(key, lane < 5 ? lane : 1);
  const Key k_map = shfl_key(sub, 1);
  // each lane's uniform bits from its own key: the goal's (lane 2), the
  // spawn's (lane 3) and a continuous heading's (lane 4)
  const uint32_t own_bits = bits(sub, 0);
  // a discrete heading, randint(key, (), 0, num_directions) (lane 4)
  const uint32_t own_dir = continuous ? 0u : randint_at(sub, 0, span_of(0, num_directions));
  const Key k_coin = split_key(k_map, 0);

  // the carve: flat word q of the packed map, tile 32 q + lane a lane.
  // Cells (odd, odd) are open; the north passage (2 ci, 2 cj + 1), ci >= 1,
  // is open where cj == 0 or the coin is up; the west passage (2 ci + 1,
  // 2 cj), cj >= 1, where ci == 0 or the coin is down.
  for (int q = 0; q < nw; ++q) {
    const int f = q * 32 + lane;
    bool wall = false;
    if (f < tiles) {
      const int i = f / w, j = f - i * w;
      const int ci = i >> 1, cj = j >> 1;
      wall = true;
      if (i & 1) {
        if (j & 1) {
          wall = false;
        } else if (j > 0 && j < w - 1) {
          wall = ci > 0 && coin(k_coin, ci * cw + cj);
        }
      } else if ((j & 1) && i > 0 && i < h - 1) {
        wall = cj > 0 && !coin(k_coin, ci * cw + cj);
      }
    }
    const uint32_t word = __ballot_sync(kFull, wall);
    if (lane == (q & 31)) words[q] = word;
  }
  __syncwarp();

  // the rooms, 32 at a time: lane r draws room r0 + r, then each is cleared
  // over the interior, a row a lane
  if (num_rooms > 0) {
    const Key k_rooms = split_key(k_map, 1);
    const uint32_t span_i = span_of(1, h - 1), span_j = span_of(1, w - 1);
    const uint32_t span_half = span_of(1, static_cast<long long>(room_max_half) + 1);
    for (int r0 = 0; r0 < num_rooms; r0 += 32) {
      int ci = 0, cj = 0, hi = 0, hj = 0;
      if (r0 + lane < num_rooms) {
        const Key room = split_key(k_rooms, r0 + lane);
        uint32_t oi, oj, ohi, ohj;
        randint2(split_key(room, 0), span_i, span_j, oi, oj);
        randint2(split_key(room, 1), span_half, span_half, ohi, ohj);
        ci = 1 + static_cast<int>(oi);
        cj = 1 + static_cast<int>(oj);
        // 1 + offset, held to the map (the interior bounds the room anyway)
        hi = 1 + static_cast<int>(min(ohi, static_cast<uint32_t>(h)));
        hj = 1 + static_cast<int>(min(ohj, static_cast<uint32_t>(w)));
      }
      const int n = min(32, num_rooms - r0);
      for (int r = 0; r < n; ++r) {
        const int rci = __shfl_sync(kFull, ci, r), rcj = __shfl_sync(kFull, cj, r);
        const int rhi = __shfl_sync(kFull, hi, r), rhj = __shfl_sync(kFull, hj, r);
        const int i0 = max(rci - rhi, 1), i1 = min(rci + rhi, h - 2);
        const int j0 = max(rcj - rhj, 1), j1 = min(rcj + rhj, w - 2);
        for (int i = i0 + lane; i <= i1 && j0 <= j1; i += 32) {
          const int s = i * w + j0, e = i * w + j1;  // flat bits s..e
          for (int q = s >> 5; q <= e >> 5; ++q) {
            const int lo = max(s, q * 32) - q * 32, top = min(e, q * 32 + 31) - q * 32;
            atomicAnd(&words[q], ~((kFull >> (31 - (top - lo))) << lo));
          }
        }
      }
    }
    __syncwarp();
  }

  // the open tiles: n, then the goal's rank k1 and the spawn's k2 over
  // n - 1, bumped past k1 (`sampling.sample_empty_tile_pair`)
  int count = 0;
  for (int q = lane; q < nw; q += 32) {
    const int rest = tiles - q * 32;
    count += __popc(~words[q] & (rest < 32 ? (1u << rest) - 1u : kFull));
  }
  const float n = static_cast<float>(__reduce_add_sync(kFull, count));
  const float k1 = rank_draw(unit_float(__shfl_sync(kFull, own_bits, 2)), n);
  float k2 = rank_draw(unit_float(__shfl_sync(kFull, own_bits, 3)), __fsub_rn(n, 1.0f));
  k2 = __fadd_rn(k2, k1 <= k2 ? 1.0f : 0.0f);
  const int rank1 = static_cast<int>(k1), rank2 = static_cast<int>(k2);

  // the k-th open tile: the lane whose word holds it (a warp scan of the
  // words' counts, 32 words a pass) picks its bit; a rank of n or more
  // finds none and gives tile 0
  int found1 = -1, found2 = -1, before = 0;
  for (int q0 = 0; q0 < nw; q0 += 32) {
    const int q = q0 + lane;
    const int rest = tiles - q * 32;
    const uint32_t open = q < nw ? ~words[q] & (rest < 32 ? (1u << rest) - 1u : kFull) : 0u;
    const int c = __popc(open);
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int excl = before + incl - c;
    if (rank1 >= excl && rank1 < excl + c) found1 = q * 32 + nth_bit(open, rank1 - excl);
    if (rank2 >= excl && rank2 < excl + c) found2 = q * 32 + nth_bit(open, rank2 - excl);
    before += __shfl_sync(kFull, incl, 31);
  }
  const int goal = max(__reduce_max_sync(kFull, found1), 0);
  const int spawn = max(__reduce_max_sync(kFull, found2), 0);
  const uint32_t dir_bits = __shfl_sync(kFull, own_bits, 4);
  const uint32_t dir_int = __shfl_sync(kFull, own_dir, 4);

  const int64_t row = static_cast<int64_t>(env);
  for (int q = lane; q < nw; q += 32) wall_words[row * nw + q] = static_cast<int32_t>(words[q]);
  if (lane == 0) {
    const int gi = goal / w, si = spawn / w;
    goal_tu[2 * row] = gi;
    goal_tu[2 * row + 1] = goal - gi * w;
    const int sj = spawn - si * w;
    if (f64) {
      static_cast<double*>(pos_wu)[2 * row] = static_cast<double>(si) + 0.5;
      static_cast<double*>(pos_wu)[2 * row + 1] = static_cast<double>(sj) + 0.5;
    } else {
      static_cast<float*>(pos_wu)[2 * row] = static_cast<float>(si) + 0.5f;
      static_cast<float*>(pos_wu)[2 * row + 1] = static_cast<float>(sj) + 0.5f;
    }
    if (continuous) {
      // uniform(key, (), 0, num_directions): max(0, u * (hi - 0) + 0)
      const float heading = fmaxf(
          0.0f, __fadd_rn(__fmul_rn(unit_float(dir_bits), static_cast<float>(num_directions)),
                          0.0f));
      dir_au[row] = __float_as_int(heading);
    } else {
      dir_au[row] = static_cast<int32_t>(dir_int);
    }
    rng_key[2 * row] = sub.k0;
    rng_key[2 * row + 1] = sub.k1;
    reward[row] = 0.0f;
    done[row] = false;
    t[row] = 0;
    episode_return[row] = 0.0f;
    pending_reset[row] = false;
  }
}

}  // namespace

extern "C" int rcw_maze_reset(const void* keys, long long key_stride, long long word_stride,
                              void* wall_words, void* goal_tu, void* pos_wu, void* dir_au,
                              void* reward, void* done, void* rng_key, void* t,
                              void* episode_return, void* pending_reset, int b, int h, int w,
                              int num_rooms, int room_max_half, int num_directions,
                              int continuous, int f64, void* stream) {
  const long long tiles = static_cast<long long>(h) * w;
  if (b < 1 || h < 5 || w < 5 || num_rooms < 0 || num_directions < 1 ||
      tiles > 32LL * kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nw = static_cast<int>((tiles + 31) / 32);
  const int warps_per_block = min(kWarps, kSmemWords / nw);
  const int blocks = (b + warps_per_block - 1) / warps_per_block;
  const size_t smem = sizeof(uint32_t) * warps_per_block * nw;
  maze_reset_kernel<<<blocks, 32 * warps_per_block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_stride, word_stride,
      static_cast<int32_t*>(wall_words), static_cast<int32_t*>(goal_tu), pos_wu,
      static_cast<int32_t*>(dir_au), static_cast<float*>(reward), static_cast<bool*>(done),
      static_cast<int64_t*>(rng_key), static_cast<int32_t*>(t),
      static_cast<float*>(episode_return), static_cast<bool*>(pending_reset), b, h, w, nw,
      warps_per_block, num_rooms, room_max_half, num_directions, continuous, f64);
  return static_cast<int>(cudaGetLastError());
}
