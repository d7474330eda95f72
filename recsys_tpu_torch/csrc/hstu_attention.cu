// HSTU's jagged causal SiLU attention for Hopper (sm_90a): kernel row 11
// (the forward) and row 12 (the backward). No TPU kernel corresponds: the
// JAX package has no sequential model; these serve HSTU (models/hstu.py).
//
// A batch is jagged: the events of every sequence lie end to end (sequence
// b in rows [offsets[b], offsets[b + 1]) of every [events, ...] tensor, n_b
// of them), with no padding. Per sequence and head h, with q, k, v its
// rows of the [events, 3 H 64] bf16 operand (columns: v of every head, q,
// then k; 64 a head):
//   s_ij = q_i . k_j + p[j - i + N - 1] + w[bucket(t'_i - t_j)]
//   a_ij = silu(s_ij) / N  for j <= i, else 0;   o_i = sum_j a_ij v_j
// where N is the configuration's max_sequence_length, p [2N - 1] and w
// [129] the block's learned position and time weights (one bias for every
// head), t' the timestamp of the next event of the sequence (the last
// event's own), and bucket(x) = min(128, (int)(logf(max(|x|, 1)) * (1 / 0.301f))):
// the source's log(|x|) / 0.301 as PyTorch computes it on the card, by the
// fp32 reciprocal of the divisor.
// The bias is computed in the kernels from the int64 timestamps and each
// event's position in its sequence (from the int32 offsets); no [n, n]
// tensor ever reaches device memory.
//
// The backward, with do the incoming gradient of o:
//   dv_j = sum_i a_ij do_i;   da_ij = do_i . v_j
//   ds_ij = da_ij silu'(s_ij) / N  (j <= i, else 0)
//   dq_i = sum_j ds_ij k_j;   dk_j = sum_i ds_ij q_i
//   dp[j - i + N - 1] += sum_h ds_ij;   dw[bucket(t'_i - t_j)] += sum_h ds_ij
// Operands of every product are bf16 with fp32 sums: q, k, v, do as given,
// a and ds rounded to bf16 where they feed a product; ds enters dp and dw
// in fp32.
//
// Design. The products run on wgmma fed by TMA (hopper.cuh): 64 x 64 tiles
// of 64-wide bf16 rows (one 128-byte-swizzled chunk), the swept tiles in a
// ring of two stages loaded by thread 0 a tile ahead. Tiles are cut from
// each sequence's first event, so a query tile i and key tile j meet only
// when j <= i, and the causal mask cuts only the diagonal tile; rows a tile
// reads past its sequence belong to the next one (or lie past the tensor,
// zero) and are masked where they would reach a written row: in the
// diagonal tile, and in the backward's last query tile. A table of
// (sequence, tile) a block, longest sweeps first, is made by the caller
// (ops/hstu_attention.py).
//   The bias is one for every head, and its bucket's exact logf is most of
// a pair's arithmetic. So rows 11 and 12's dK/dV kernel are one block a
// tile over all H <= 4 heads, a warpgroup a head: for each swept tile the
// block's threads compute the tile's fp32 bias (0 where masked) once, each
// warpgroup a share, into shared memory in the accumulators' order (float4
// j of a warpgroup's thread t at [j][t]: its columns 8j + 2 t4 + {0, 1} of
// its two rows), and every head reads it there. The next tile's bias is
// computed while this tile's products run (two buffers); one barrier a
// tile frees the ring's stage and the bias buffer.
//   * hstu_attn_fwd_kernel (row 11): a block a query tile, warpgroup h head
//     h: S = Q K^T [64 x 64] on wgmma from shared memory, x = S + bias, SiLU
//     and (in the diagonal tile) the mask in registers, A packed to bf16
//     straight into the register A operand of O += A V; O written once in
//     fp32. Shared: Q of every head, two stages of K and V of every head,
//     two bias tiles (~194 KB at H = 4, one block an SM).
//   * hstu_attn_bwd_dkv_kernel (row 12): a block a key tile sweeping its
//     query tiles, warpgroup h head h, in two halves of 32 queries a tile
//     (so dK and dV of a head, S^T and dA^T fit a thread's 128 registers):
//     S^T = K Q^T and dA^T = V dO^T on m64n32 products, then dV += A^T dO
//     and dK += dS^T Q, A^T and dS^T from registers. Shared: K and V of
//     every head, two stages of Q and dO of every head, two bias tiles
//     (~226 KB at H = 4).
//   * hstu_attn_bwd_dq_kernel (row 12): a block a query tile, two
//     warpgroups of two heads each, sweeping its key tiles: the bias and
//     mask of a tile once a warpgroup, then per head S = Q K^T, dA = dO V^T,
//     dS, dQ += dS K, dS summed over the heads in registers; the tile's
//     summed fp32 dS goes to shared memory once, where the block adds it
//     into its own dp (a thread a diagonal) and dw (a thread a row, its
//     runs of one bucket four columns at a time, into the thread's own
//     bucket sums) in a fixed order (one block an SM, ~200 KB of shared
//     memory); the block writes its partial sums, and
//     hstu_bias_grad_kernel adds the blocks' partials in block order. No
//     atomics anywhere: two calls give the same bits.
//   The dQ and dK/dV kernels each recompute S (and dA): 7 products a pair
// and head against the forward's 2, where one kernel with dQ summed by
// atomics would run 5.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int HT = 64;                  // rows of a query or key tile
constexpr int HD = 64;                  // dqk = dv
constexpr int NB = 129;                 // time buckets: 128 and the clamp
constexpr int HTHREADS = 128;           // one warpgroup
constexpr int TILE = HT * HD * 2;       // bytes of a 64 x 64 bf16 tile
constexpr int DS_LD = HT + 4;           // row pitch of the fp32 dS tile (floats; rows on 16 bytes)
constexpr int BK_LD = HT + 4;           // and of its buckets (bytes)
constexpr int NO_BUCKET = 255;          // a masked pair's bucket in the dQ kernel's tile
constexpr int MAX_HEADS = 4;            // a warpgroup a head (the dQ kernel: two heads a warpgroup)
constexpr int BIAS_TILE = HT * HT;      // floats of a tile's bias

// the tile of a block: x the sequence (< 0: no tile), y its tile
__device__ __forceinline__ bool tile_of(const int2* tiles, int slot, const int* offsets,
                                        int& start, int& n, int& t) {
  const int2 tl = tiles[slot];
  if (tl.x < 0) return false;
  start = offsets[tl.x];
  n = offsets[tl.x + 1] - start;
  t = tl.y;
  return true;
}

__device__ __forceinline__ int bucket_of(long long dt) {
  long long a = dt < 0 ? -dt : dt;
  if (a < 1) a = 1;
  const int b = static_cast<int>(logf(static_cast<float>(a)) * (1.f / 0.301f));
  return b < NB - 1 ? b : NB - 1;
}

__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.f + __expf(-x)); }

// the timestamp a query position i of a sequence of n at `start` compares
// with: the next event's, the last event's own (i < n)
__device__ __forceinline__ long long next_ts(const long long* ts, int start, int n, int i) {
  return ts[start + (i + 1 < n ? i + 1 : i)];
}

// the aligned dynamic shared memory (tiles on the swizzle's 1024 bytes)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// d[64 x 64] = A[64 x 64] B[64 x 64]^T of two K-major tiles
__device__ __forceinline__ void product_ss(float (&d)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<64>(d, sw128_desc(a + kk * 32, 16, 1024), sw128_desc(b + kk * 32, 16, 1024),
                 kk > 0);
}

// d[64 x 64] += A[64 x 64] B[64 x 64], A from registers, B a tile read
// MN-major (its rows the reduction axis)
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HT / 16; ++kk)
    wgmma_rs<64>(d, a[kk], sw128_desc(b + kk * 16 * 128, TILE, 1024));
}

// d[64 x 32] = A[64 x 64] B[32 x 64]^T of a K-major tile and rows 32 half..
// of another
__device__ __forceinline__ void product_ss_half(float (&d)[16], const unsigned char* a,
                                                const unsigned char* b, int half) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<32>(d, sw128_desc(a + kk * 32, 16, 1024),
                 sw128_desc(b + half * 32 * 128 + kk * 32, 16, 1024), kk > 0);
}

// d[64 x 64] += A[64 x 32] B[32 x 64], A from registers, B rows 32 half..
// of a tile read MN-major
__device__ __forceinline__ void product_rs_half(float (&d)[32], const uint32_t (&a)[2][4],
                                                const unsigned char* b, int half) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs<64>(d, a[kk], sw128_desc(b + (2 * half + kk) * 16 * 128, TILE, 1024));
}

// the block's mbarriers: [0] its own tiles, [1 + s] ring stage s
__device__ __forceinline__ void init_bars(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
}

// the float4s j of a bias tile that warpgroup g of `groups` computes
// (j % groups == g), as a mask of bits j
__device__ __forceinline__ uint32_t bias_share(int g, int groups) {
  uint32_t m = 0;
  for (int j = g; j < 8; j += groups) m |= 1u << j;
  return m;
}

// This thread's share (`mine`) of a tile's bias into dst, in the
// accumulators' order: float4 j of the thread wt of every warpgroup holds
// rows row[r] against columns col0 + 8j + 2 t4 + e at 2r + e. The rows are
// queries (the forward) or keys (KEY_ROWS, the dK/dV kernel), rts their
// timestamps: a query's next event's, a key's own. 0 where masked.
// Returns the values this thread computed.
template <bool KEY_ROWS>
__device__ __forceinline__ int bias_tile(float4* dst, uint32_t mine, int wt, int t4,
                                          const long long* ts, int start, int n, int col0,
                                          int n_max, const float* pos_w, const float* w_s,
                                          const int (&row)[2], const long long (&rts)[2]) {
  int done = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!((mine >> j) & 1u)) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + 2 * t4 + e;
      const long long cts = ts[start + min(KEY_ROWS ? col + 1 : col, n - 1)];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = KEY_ROWS ? col : row[r], kj = KEY_ROWS ? row[r] : col;
        float b = 0.f;
        if (kj <= qi && qi < n)
          b = __ldg(pos_w + (kj - qi + n_max - 1)) + w_s[bucket_of(rts[r] - cts)];
        v[2 * r + e] = b;
      }
    }
    dst[j * HTHREADS + wt] = make_float4(v[0], v[1], v[2], v[3]);
    done += 4;
  }
  return done;
}

// The bias values a bias_tile call computed (each thread's `done`) added
// to its warp's count in shared memory (lane 0 the warp's only writer;
// cnt_s static, at an address no register holds)
__device__ __forceinline__ void count_bias(int* cnt_s, int done) {
  const int w = __reduce_add_sync(0xffffffffu, done);
  if ((threadIdx.x & 31) == 0) cnt_s[threadIdx.x >> 5] += w;
}

// The warps' counts, whole after the sweep's last barrier, into
// counts[blockIdx.x]: one plain store a block
__device__ __forceinline__ void store_count(const int* cnt_s, int* counts) {
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) sum += cnt_s[i];
    counts[blockIdx.x] = sum;
  }
}

// A of one tile and head: x = s + the bias (bias_t: this thread's float4s
// of the tile), a = silu(x) / N, 0 where the key (column kj0 + 8j + e)
// lies past the query (MASK: the diagonal tile), packed to bf16 as the
// register A operand of O += A V
template <bool MASK>
__device__ __forceinline__ void fwd_a(const float (&s)[32], uint32_t (&pa)[4][4],
                                      const float4* bias_t, const int (&qi)[2], int kj0,
                                      float inv_n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 b4 = bias_t[j * HTHREADS];
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float pf[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = s[4 * j + 2 * r + e] + b[2 * r + e];
        const float a = x * sigmoid(x) * inv_n;
        pf[r][e] = MASK && kj0 + 8 * j + e > qi[r] ? 0.f : a;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) pa[j >> 1][(j & 1) * 2 + r] = pack_bf16(pf[r][0], pf[r][1]);
  }
}

// A^T and dS^T of half a tile and one head (32 queries, from column qi0 +
// 8jj + e): x = s + the bias, a = silu(x) / N, ds = da silu'(x) / N, both
// 0 where the query lies before the key or past the sequence (MASK: the
// diagonal and the last query tile), packed to bf16 as the register A
// operands of dV += A^T dO and dK += dS^T Q
template <bool MASK>
__device__ __forceinline__ void dkv_a_ds(const float (&s)[16], const float (&da)[16],
                                         uint32_t (&pa)[2][4], uint32_t (&pd)[2][4],
                                         const float4* bias_t, const int (&kj)[2], int qi0,
                                         int n, float inv_n) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float4 b4 = bias_t[jj * HTHREADS];
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float af[2][2], df[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = qi0 + 8 * jj + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = 4 * jj + 2 * r + e;
        const float x = s[c] + b[2 * r + e];
        const float sg = sigmoid(x);
        const bool off = MASK && !(qi < n && kj[r] <= qi);
        af[r][e] = off ? 0.f : x * sg * inv_n;
        df[r][e] = off ? 0.f : da[c] * sg * (1.f + x * (1.f - sg)) * inv_n;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pa[jj >> 1][(jj & 1) * 2 + r] = pack_bf16(af[r][0], af[r][1]);
      pd[jj >> 1][(jj & 1) * 2 + r] = pack_bf16(df[r][0], df[r][1]);
    }
  }
}

// shared memory of the forward: Q of every head, two ring stages of K and
// V of every head, two bias tiles
size_t fwd_smem(int heads) {
  return 1024 + 5 * heads * TILE + 2 * BIAS_TILE * 4 + NB * 4 + 3 * 8 + 16;
}

// Row 11. Grid (tile slots): a block a query tile, warpgroup h head h;
// bias_counts [slots]: the bias values each block computed (0 where the
// slot has no tile, as the launch set it).
__global__ void __launch_bounds__(MAX_HEADS * HTHREADS, 1) hstu_attn_fwd_kernel(
    const __grid_constant__ CUtensorMap qkv_map, const int2* __restrict__ tiles,
    const int* __restrict__ offsets, const long long* __restrict__ ts,
    const float* __restrict__ pos_w, const float* __restrict__ ts_w, int heads, int n_max,
    float inv_n, float* __restrict__ out, int* __restrict__ bias_counts) {
  int start, n, qt;
  if (!tile_of(tiles, blockIdx.x, offsets, start, n, qt)) return;
  const int tid = threadIdx.x, h = tid >> 7, wt = tid & 127;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);                        // [heads] Q
  unsigned char* ring = q_s + heads * TILE;                            // [2][heads][K, V]
  float4* bias_s = reinterpret_cast<float4*>(ring + 4 * heads * TILE);  // [2][8][HTHREADS]
  float* w_s = reinterpret_cast<float*>(bias_s + 2 * BIAS_TILE / 4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(w_s + NB + 3);
  __shared__ int cnt_s[MAX_HEADS * HTHREADS / 32];                      // [warps]
  init_bars(bar);
  for (int b = tid; b < NB; b += blockDim.x) w_s[b] = ts_w[b];
  if (tid < heads * 4) cnt_s[tid] = 0;
  __syncthreads();
  const int i0 = qt * HT, n_kt = qt + 1, stage = 2 * heads * TILE;
  // the ring's tile it: K and V of key tile it, every head
  auto load = [&](int it) {
    unsigned char* dst = ring + (it & 1) * stage;
    uint64_t* fb = bar + 1 + (it & 1);
    mbar_arrive_expect_tx(fb, stage);
    for (int k = 0; k < heads; ++k) {
      tma_load_2d(dst + 2 * k * TILE, &qkv_map, (2 * heads + k) * HD, start + it * HT, fb);
      tma_load_2d(dst + (2 * k + 1) * TILE, &qkv_map, k * HD, start + it * HT, fb);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, heads * TILE);
    for (int k = 0; k < heads; ++k)
      tma_load_2d(q_s + k * TILE, &qkv_map, (heads + k) * HD, start + i0, bar);
    load(0);
  }
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const uint32_t mine = bias_share(h, heads);
  int qi[2];
  long long tn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = i0 + 16 * warp + gq + 8 * r;
    tn[r] = qi[r] < n ? next_ts(ts, start, n, qi[r]) : 0;
  }
  count_bias(cnt_s,
             bias_tile<false>(bias_s, mine, wt, t4, ts, start, n, 0, n_max, pos_w, w_s, qi, tn));
  __syncthreads();  // key tile 0's bias is whole
  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t pa[4][4];
  const unsigned char* q_h = q_s + h * TILE;
  mbar_wait(bar, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (tid == 0 && it + 1 < n_kt) load(it + 1);
    mbar_wait(bar + 1 + st, (it >> 1) & 1);
    const unsigned char* k_t = ring + st * stage + 2 * h * TILE;
    wgmma_fence();
    product_ss(s, q_h, k_t);
    wgmma_commit();
    // the next key tile's bias while the product runs
    int done = 0;
    if (it + 1 < n_kt)
      done = bias_tile<false>(bias_s + (st ^ 1) * (BIAS_TILE / 4), mine, wt, t4, ts, start, n,
                              (it + 1) * HT, n_max, pos_w, w_s, qi, tn);
    wgmma_wait<0>();
    keep(s);
    if (it + 1 < n_kt) count_bias(cnt_s, done);
    const float4* bias_t = bias_s + st * (BIAS_TILE / 4) + wt;
    if (it == n_kt - 1)
      fwd_a<true>(s, pa, bias_t, qi, it * HT + 2 * t4, inv_n);
    else
      fwd_a<false>(s, pa, bias_t, qi, it * HT + 2 * t4, inv_n);
    wgmma_fence();
    product_rs(o, pa, k_t + TILE);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    __syncthreads();  // stage st and bias tile st are read, bias tile st ^ 1 is whole
  }
  const int ld = heads * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= n) continue;
    float* dst = out + static_cast<long long>(start + qi[r]) * ld + h * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
  store_count(cnt_s, bias_counts);
}

// shared memory of the dK/dV kernel: K and V of every head, two ring
// stages of Q and dO of every head, two bias tiles
size_t dkv_smem(int heads) {
  return 1024 + 6 * heads * TILE + 2 * BIAS_TILE * 4 + NB * 4 + 3 * 8 + 16;
}

// Row 12, dK and dV. Grid (tile slots): a block a key tile, warpgroup h
// head h; bias_counts [slots]: the bias values each block computed (0
// where the slot has no tile, as the launch set it).
__global__ void __launch_bounds__(MAX_HEADS * HTHREADS, 1) hstu_attn_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
    const int2* __restrict__ tiles, const int* __restrict__ offsets,
    const long long* __restrict__ ts, const float* __restrict__ pos_w,
    const float* __restrict__ ts_w, int heads, int n_max, float inv_n,
    float* __restrict__ dqkv, int* __restrict__ bias_counts) {
  int start, n, kt;
  if (!tile_of(tiles, blockIdx.x, offsets, start, n, kt)) return;
  const int tid = threadIdx.x, h = tid >> 7, wt = tid & 127;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv_s = aligned_smem(smem_raw);                        // [heads][K, V]
  unsigned char* ring = kv_s + 2 * heads * TILE;                        // [2][heads][Q, dO]
  float4* bias_s = reinterpret_cast<float4*>(ring + 4 * heads * TILE);  // [2][8][HTHREADS]
  float* w_s = reinterpret_cast<float*>(bias_s + 2 * BIAS_TILE / 4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(w_s + NB + 3);
  __shared__ int cnt_s[MAX_HEADS * HTHREADS / 32];                      // [warps]
  init_bars(bar);
  for (int b = tid; b < NB; b += blockDim.x) w_s[b] = ts_w[b];
  if (tid < heads * 4) cnt_s[tid] = 0;
  __syncthreads();
  const int j0 = kt * HT, n_qt = (n + HT - 1) / HT - kt, stage = 2 * heads * TILE;
  // the ring's tile it: Q and dO of query tile kt + it, every head
  auto load = [&](int it) {
    unsigned char* dst = ring + (it & 1) * stage;
    uint64_t* fb = bar + 1 + (it & 1);
    mbar_arrive_expect_tx(fb, stage);
    for (int k = 0; k < heads; ++k) {
      tma_load_2d(dst + 2 * k * TILE, &qkv_map, (heads + k) * HD, start + j0 + it * HT, fb);
      tma_load_2d(dst + (2 * k + 1) * TILE, &do_map, k * HD, start + j0 + it * HT, fb);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * heads * TILE);
    for (int k = 0; k < heads; ++k) {
      tma_load_2d(kv_s + 2 * k * TILE, &qkv_map, (2 * heads + k) * HD, start + j0, bar);
      tma_load_2d(kv_s + (2 * k + 1) * TILE, &qkv_map, k * HD, start + j0, bar);
    }
    load(0);
  }
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const uint32_t mine = bias_share(h, heads);
  int kj[2];
  long long tk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = j0 + 16 * warp + gq + 8 * r;
    tk[r] = ts[start + min(kj[r], n - 1)];
  }
  count_bias(cnt_s,
             bias_tile<true>(bias_s, mine, wt, t4, ts, start, n, j0, n_max, pos_w, w_s, kj, tk));
  __syncthreads();  // query tile 0's bias is whole
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const unsigned char* k_h = kv_s + 2 * h * TILE;
  mbar_wait(bar, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    if (tid == 0 && it + 1 < n_qt) load(it + 1);
    mbar_wait(bar + 1 + st, (it >> 1) & 1);
    const unsigned char* q_t = ring + st * stage + 2 * h * TILE;
    const unsigned char* do_t = q_t + TILE;
    const int i0 = j0 + it * HT;
    const bool edge = it == 0 || it == n_qt - 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[16], da[16];
      uint32_t pa[2][4], pd[2][4];
      wgmma_fence();
      product_ss_half(s, k_h, q_t, half);
      product_ss_half(da, k_h + TILE, do_t, half);
      wgmma_commit();
      wgmma_wait<0>();
      keep(s);
      keep(da);
      const float4* bias_t = bias_s + st * (BIAS_TILE / 4) + half * 4 * HTHREADS + wt;
      if (edge)
        dkv_a_ds<true>(s, da, pa, pd, bias_t, kj, i0 + 32 * half + 2 * t4, n, inv_n);
      else
        dkv_a_ds<false>(s, da, pa, pd, bias_t, kj, i0 + 32 * half + 2 * t4, n, inv_n);
      wgmma_fence();
      product_rs_half(dv, pa, do_t, half);
      product_rs_half(dk, pd, q_t, half);
      wgmma_commit();
      // the next query tile's bias while the last products run
      int done = 0;
      if (half == 1 && it + 1 < n_qt)
        done = bias_tile<true>(bias_s + (st ^ 1) * (BIAS_TILE / 4), mine, wt, t4, ts, start, n,
                               i0 + HT, n_max, pos_w, w_s, kj, tk);
      wgmma_wait<0>();
      keep(dv);
      keep(dk);
      keep(pa);
      keep(pd);
      // counted once the products' registers are free
      if (half == 1 && it + 1 < n_qt) count_bias(cnt_s, done);
    }
    __syncthreads();  // stage st and bias tile st are read, bias tile st ^ 1 is whole
  }
  const long long ld = 3LL * heads * HD;
  const int vc = h * HD, kc = (2 * heads + h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= n) continue;
    float* row = dqkv + (start + kj[r]) * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(row + vc + c) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(row + kc + c) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
    }
  }
  store_count(cnt_s, bias_counts);
}

constexpr int DQ_THREADS = 256;        // the dQ kernel: two warpgroups
constexpr int DW_ROWS = HT;            // its threads that sum dw, a row each

// shared memory of the dQ kernel: Q and dO of every head, the ring (two
// stages of K and V of two heads), the dS tile and its buckets, the
// block's dp (n_max + 64) and each dw thread's bucket sums
size_t dq_smem(int heads, int n_max) {
  return 1024 + 2 * heads * TILE + 2 * 4 * TILE + HT * DS_LD * 4 + HT * BK_LD +
         (n_max + HT) * 4 + DW_ROWS * NB * 4 + NB * 4 + 3 * 8 + 16;
}

// dw of one tile, thread r < DW_ROWS: row r in column order, a run of one
// bucket at a time (four columns at once where they share the run's
// bucket), each run's sum added to the thread's bucket sums dw_t; a masked
// pair (NO_BUCKET, dS 0) adds nothing
__device__ __forceinline__ void tile_dw(const float* ds_s, const uint8_t* bk_s, float* dw_t,
                                        int r) {
  const float* row = ds_s + r * DS_LD;
  const uint8_t* brow = bk_s + r * BK_LD;
  int cur = brow[0];
  float run = 0.f;
#pragma unroll 4
  for (int c = 0; c < HT; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    const uint32_t b4 = *reinterpret_cast<const uint32_t*>(brow + c);
    if (b4 == static_cast<uint32_t>(cur) * 0x01010101u) {
      run += (v.x + v.y) + (v.z + v.w);
      continue;
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = (b4 >> (8 * e)) & 0xff;
      if (b != cur) {
        if (cur != NO_BUCKET) dw_t[cur] += run;
        cur = b;
        run = 0.f;
      }
      run += vs[e];
    }
  }
  if (cur != NO_BUCKET) dw_t[cur] += run;
}

// dp of one tile: the diagonal c - r = dg (in [-63, 63]) of the dS tile,
// rows in a fixed order (four partial sums), into the block's dp at
// d = i - j = base - dg
__device__ __forceinline__ void tile_dp(const float* ds_s, float* dp_s, int dg, int base,
                                        int dp_len) {
  const int r0 = max(0, -dg), r1 = min(HT, HT - dg);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < r1; ++r) acc[(r - r0) & 3] += ds_s[r * DS_LD + r + dg];
  const int d = base - dg;
  if (d >= 0 && d < dp_len) dp_s[d] += (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Row 12, dQ and the blocks' partial dp, dw. Grid (tile slots): a block a
// query tile, two warpgroups; warpgroup g takes heads g and g + 2. Per key
// tile J the ring brings K and V of heads 0 and 1, then of heads 2 and 3;
// each warpgroup computes the bias and mask of its rows once, then for
// each of its heads S = Q K^T, dA = dO V^T, dS, and dQ += dS K, summing dS
// over its heads in registers. The two warpgroups' sums meet in shared
// memory (warpgroup 0's, then warpgroup 1's added), where the block sums
// the tile into its own dp (a thread a diagonal) and dw (a thread a row,
// into its own bucket sums), once a tile for every head. dp_part [slots,
// n_max] (d = i - j, the block's first 64 (tile + 1) entries), dw_part
// [slots, NB].
__global__ void __launch_bounds__(DQ_THREADS, 1) hstu_attn_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
    const int2* __restrict__ tiles, const int* __restrict__ offsets,
    const long long* __restrict__ ts, const float* __restrict__ pos_w,
    const float* __restrict__ ts_w, int heads, int n_max, float inv_n,
    float* __restrict__ dqkv, float* __restrict__ dp_part, float* __restrict__ dw_part) {
  int start, n, qt;
  if (!tile_of(tiles, blockIdx.x, offsets, start, n, qt)) return;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int pairs = (heads + 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own = aligned_smem(smem_raw);     // [heads][Q, dO]
  unsigned char* ring = own + 2 * heads * TILE;     // [2][K, V of the pair's first head, ...]
  float* ds_s = reinterpret_cast<float*>(ring + 8 * TILE);       // [HT][DS_LD]
  uint8_t* bk_s = reinterpret_cast<uint8_t*>(ds_s + HT * DS_LD);  // [HT][BK_LD]
  float* dp_s = reinterpret_cast<float*>(bk_s + HT * BK_LD);     // [n_max + HT]
  float* dw_s = dp_s + n_max + HT;                                // [DW_ROWS][NB]
  float* w_s = dw_s + DW_ROWS * NB;                               // [NB]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(w_s + NB) + 7) & ~static_cast<uintptr_t>(7));
  init_bars(bar);
  const int i0 = qt * HT, n_kt = qt + 1, dp_len = min(n_max, HT * n_kt);
  for (int b = tid; b < NB; b += DQ_THREADS) w_s[b] = ts_w[b];
  for (int d = tid; d < dp_len; d += DQ_THREADS) dp_s[d] = 0.f;
  for (int d = tid; d < DW_ROWS * NB; d += DQ_THREADS) dw_s[d] = 0.f;
  __syncthreads();
  const int total = n_kt * pairs;  // ring tiles: (key tile, pair)
  // the ring's tile g: K and V of pair g % pairs' heads, key tile g / pairs
  auto load = [&](int g) {
    const int jt = g / pairs, p = g % pairs, nh = min(2, heads - 2 * p);
    unsigned char* dst = ring + (g & 1) * 4 * TILE;
    uint64_t* fb = bar + 1 + (g & 1);
    mbar_arrive_expect_tx(fb, 2 * nh * TILE);
    for (int k = 0; k < nh; ++k) {
      const int h = 2 * p + k;
      tma_load_2d(dst + 2 * k * TILE, &qkv_map, (2 * heads + h) * HD, start + jt * HT, fb);
      tma_load_2d(dst + (2 * k + 1) * TILE, &qkv_map, h * HD, start + jt * HT, fb);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * heads * TILE);
    for (int h = 0; h < heads; ++h) {
      tma_load_2d(own + 2 * h * TILE, &qkv_map, (heads + h) * HD, start + i0, bar);
      tma_load_2d(own + (2 * h + 1) * TILE, &do_map, h * HD, start + i0, bar);
    }
    load(0);
    if (total > 1) load(1);
  }
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  int qi[2], rr[2];
  long long tn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rr[r] = 16 * warp + gq + 8 * r;
    qi[r] = i0 + rr[r];
    tn[r] = qi[r] < n ? next_ts(ts, start, n, qi[r]) : 0;
  }
  float dq[2][32], s[32], da[32], bias[32], dsum[32];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
  uint32_t pd[4][4];
  mbar_wait(bar, 0);
  for (int jt = 0; jt < n_kt; ++jt) {
    const int j0 = jt * HT;
    // the bias of the warpgroup's rows (every head's), NaN-free zero where masked
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * j + 2 * t4 + e, kj = j0 + cl;
        const long long tk = ts[start + min(kj, n - 1)];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = 4 * j + 2 * r + e;
          int b = NO_BUCKET;
          bias[c] = 0.f;
          if (kj <= qi[r] && qi[r] < n) {
            b = bucket_of(tn[r] - tk);
            bias[c] = __ldg(pos_w + (kj - qi[r] + n_max - 1)) + w_s[b];
            valid |= 1u << c;
          }
          if (wg == 0) bk_s[rr[r] * BK_LD + cl] = static_cast<uint8_t>(b);
          dsum[c] = 0.f;
        }
      }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= pairs) break;
      const int g = jt * pairs + p, h = 2 * p + wg;
      mbar_wait(bar + 1 + (g & 1), (g >> 1) & 1);
      if (h < heads) {
        const unsigned char* kv = ring + (g & 1) * 4 * TILE + 2 * wg * TILE;
        const unsigned char* q_s = own + 2 * h * TILE;
        wgmma_fence();
        product_ss(s, q_s, kv);
        product_ss(da, q_s + TILE, kv + TILE);
        wgmma_commit();
        wgmma_wait<0>();
        keep(s);
        keep(da);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float df[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int c = 4 * j + 2 * r + e;
              const float x = s[c] + bias[c];
              const float sg = sigmoid(x);
              const float gr = (valid >> c) & 1u ? da[c] * sg * (1.f + x * (1.f - sg)) * inv_n
                                                 : 0.f;
              dsum[c] += gr;
              df[r][e] = gr;
            }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            pd[j >> 1][(j & 1) * 2 + r] = pack_bf16(df[r][0], df[r][1]);
        }
        wgmma_fence();
        product_rs(dq[p], pd, kv);
        wgmma_commit();
        wgmma_wait<0>();
        keep(dq[p]);
        keep(pd);
      }
      __syncthreads();  // the stage is read: its next tile may come
      if (tid == 0 && g + 2 < total) load(g + 2);
    }
    // the tile's dS summed over every head: warpgroup 0's, then 1's added
    if (wg == 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            ds_s[rr[r] * DS_LD + 8 * j + 2 * t4 + e] = dsum[4 * j + 2 * r + e];
    __syncthreads();
    if (wg == 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            ds_s[rr[r] * DS_LD + 8 * j + 2 * t4 + e] += dsum[4 * j + 2 * r + e];
    __syncthreads();
    if (tid < DW_ROWS)
      tile_dw(ds_s, bk_s, dw_s + tid * NB, tid);
    else if (tid < DW_ROWS + 2 * HT - 1)
      tile_dp(ds_s, dp_s, tid - DW_ROWS - (HT - 1), i0 - j0, dp_len);
    __syncthreads();
  }
  const long long ld = 3LL * heads * HD;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int h = 2 * p + wg;
    if (p >= pairs || h >= heads) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= n) continue;
      float* row = dqkv + (start + qi[r]) * ld + (heads + h) * HD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
            make_float2(dq[p][4 * j + 2 * r], dq[p][4 * j + 2 * r + 1]);
    }
  }
  float* dpo = dp_part + static_cast<long long>(blockIdx.x) * n_max;
  for (int d = tid; d < dp_len; d += DQ_THREADS) dpo[d] = dp_s[d];
  for (int b = tid; b < NB; b += DQ_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < DW_ROWS; ++r) acc += dw_s[r * NB + b];
    dw_part[static_cast<long long>(blockIdx.x) * NB + b] = acc;
  }
}

// dp [2 n_max - 1] and dw [NB]: the blocks' partials added in slot order
__global__ void hstu_bias_grad_kernel(const int2* __restrict__ tiles, int slots, int n_max,
                                      const float* __restrict__ dp_part,
                                      const float* __restrict__ dw_part, float* __restrict__ dp,
                                      float* __restrict__ dw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 2 * n_max - 1) {
    const int d = n_max - 1 - t;  // i - j of p[t]
    float acc = 0.f;
    if (d >= 0) {
      for (int k = 0; k < slots; ++k) {
        const int2 tl = tiles[k];
        if (tl.x >= 0 && d < HT * (tl.y + 1)) acc += dp_part[static_cast<long long>(k) * n_max + d];
      }
    }
    dp[t] = acc;
  } else if (t < 2 * n_max - 1 + NB) {
    const int b = t - (2 * n_max - 1);
    float acc = 0.f;
    for (int k = 0; k < slots; ++k)
      if (tiles[k].x >= 0) acc += dw_part[static_cast<long long>(k) * NB + b];
    dw[b] = acc;
  }
}

}  // namespace

// qkv [events, 3 heads 64] bf16 (v, q, k of every head); tiles [slots] int2
// (sequence, query tile; -1: none); offsets [sequences + 1] int32; ts
// [events] int64; pos_w [2 n_max - 1], ts_w [129] fp32 -> out [events,
// heads 64] fp32, and bias_counts [slots] int32: the bias values each block
// computed (TILE^2 a (query tile, key tile) pair for all heads). Every
// sequence at most n_max events, 1 <= heads <= 4. Returns the cudaError_t
// of the launch.
extern "C" int hstu_attn_fwd(const void* qkv, const int* tiles, int slots, const int* offsets,
                             const long long* ts, const float* pos_w, const float* ts_w,
                             int events, int heads, int n_max, float* out, int* bias_counts,
                             void* stream) {
  if (heads <= 0 || heads > MAX_HEADS || n_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slots <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zero = cudaMemsetAsync(bias_counts, 0, slots * sizeof(int), s);
  if (zero != cudaSuccess || events <= 0) return static_cast<int>(zero);
  CUtensorMap map;
  if (!rows_map(&map, qkv, events, 3 * heads * HD, HT))
    return static_cast<int>(cudaErrorNotSupported);
  return launch(hstu_attn_fwd_kernel, dim3(slots), heads * HTHREADS, fwd_smem(heads), s, map,
                reinterpret_cast<const int2*>(tiles), offsets, ts, pos_w, ts_w, heads, n_max,
                1.f / static_cast<float>(n_max), out, bias_counts);
}

// The backward of hstu_attn_fwd with dout [events, heads 64] bf16: dqkv
// [events, 3 heads 64] fp32 (dv, dq, dk as qkv's columns), dp [2 n_max - 1]
// and dw [129] fp32; q_tiles and k_tiles: the slots of the dQ and the dK/dV
// kernels; scratch dp_part [slots, n_max] and dw_part [slots, 129] fp32;
// bias_counts [slots] int32: the bias values each block of the dK/dV
// kernel computed.
extern "C" int hstu_attn_bwd(const void* qkv, const void* dout, const int* q_tiles,
                             const int* k_tiles, int slots, const int* offsets,
                             const long long* ts, const float* pos_w, const float* ts_w,
                             int events, int heads, int n_max, float* dqkv, float* dp_part,
                             float* dw_part, float* dp, float* dw, int* bias_counts,
                             void* stream) {
  if (heads <= 0 || heads > MAX_HEADS || n_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots > 0) {
    const cudaError_t zero = cudaMemsetAsync(bias_counts, 0, slots * sizeof(int), s);
    if (zero != cudaSuccess) return static_cast<int>(zero);
  }
  if (events > 0 && slots > 0) {
    CUtensorMap map, do_map;
    if (!rows_map(&map, qkv, events, 3 * heads * HD, HT) ||
        !rows_map(&do_map, dout, events, heads * HD, HT))
      return static_cast<int>(cudaErrorNotSupported);
    const float inv_n = 1.f / static_cast<float>(n_max);
    int err = launch(hstu_attn_bwd_dkv_kernel, dim3(slots), heads * HTHREADS, dkv_smem(heads),
                     s, map, do_map, reinterpret_cast<const int2*>(k_tiles), offsets, ts, pos_w,
                     ts_w, heads, n_max, inv_n, dqkv, bias_counts);
    if (err != 0) return err;
    err = launch(hstu_attn_bwd_dq_kernel, dim3(slots), DQ_THREADS, dq_smem(heads, n_max), s, map,
                 do_map, reinterpret_cast<const int2*>(q_tiles), offsets, ts, pos_w, ts_w, heads,
                 n_max, inv_n, dqkv, dp_part, dw_part);
    if (err != 0) return err;
  }
  const int total = 2 * n_max - 1 + NB;
  hstu_bias_grad_kernel<<<(total + 127) / 128, 128, 0, s>>>(
      reinterpret_cast<const int2*>(q_tiles), events > 0 ? slots : 0, n_max, dp_part, dw_part,
      dp, dw);
  return static_cast<int>(cudaGetLastError());
}
