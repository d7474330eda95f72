// MLA's jagged causal softmax attention for Hopper (sm_90a): kernel row 14
// (the forward) and row 15 (the backward). No TPU kernel corresponds: the
// JAX package has no sequential model; these serve models/mla_moe.py
// (DeepSeek-V2's multi-head latent attention, arXiv:2405.04434, section 2.1).
//
// A batch is jagged: the events of every sequence lie end to end (sequence
// b in rows [offsets[b], offsets[b + 1]), n_b of them), with no padding. Per
// sequence and head h, with q, k its rows of the [events, H 192] bf16
// operands (192 = 128 nope + 64 rope columns a head) and v of the [events,
// H 128] one:
//   x_ij = c q_i . k_j  (c = tau log2 e)
//   p_ij = 2^(x_ij - lse_i) over j <= i, lse_i = log2 sum_{j <= i} 2^x_ij
//   o_i = sum_j p_ij v_j
// The backward, with do the incoming gradient of o and delta_i = do_i . o_i
// (fp32, given):
//   ds_ij = tau p_ij (do_i . v_j - delta_i)
//   dq_i = sum_j ds_ij k_j;   dk_j = sum_i ds_ij q_i;   dv_j = sum_i p_ij do_i
// Operands of every product are bf16 with fp32 sums: q, k, v, do as given,
// p and ds rounded to bf16 where they feed a product. The softmax runs
// online in fp32 (the running maximum and sum of each row), and the forward
// writes o (fp32) and lse (fp32, log2 units); no [n, n] tensor reaches
// device memory.
//
// Design. The products run on wgmma fed by TMA (hopper.cuh): 64-row tiles
// of 64-column chunks (three chunks of a head's q or k, two of its v or do),
// each a 128-byte-swizzled 8 KB tile, the swept tiles in a ring of two
// stages loaded by thread 0 a tile ahead. A block is one warpgroup: one
// tile of one head. Tiles are cut from each sequence's first event
// (ops/hstu_attention.py's make_layout: the tiles longest sweeps first), so
// a query tile i and key tile j meet only when j <= i and the causal mask
// cuts only the diagonal tile; rows a tile reads past its sequence belong to
// the next one (or lie past the tensor, zero) and are masked where they
// would reach a written row.
//   * mla_attn_fwd_kernel (row 14): a block a query tile and head, sweeping
//     its key tiles: S = Q K^T [64 x 64] (12 k-steps over the three chunks),
//     the online softmax in registers, P packed to bf16 straight into the
//     register A operand of O += P V (two 64-column products). Shared: Q,
//     two stages of K and V (~105 KB, two blocks an SM).
//   * mla_attn_bwd_dq_kernel (row 15): a block a query tile and head,
//     sweeping its key tiles: S = Q K^T, dP = dO V^T, dS, dQ += dS K (three
//     64-column products, dS from registers). Shared: Q, dO, two stages of K
//     and V (~121 KB).
//   * mla_attn_bwd_dkv_kernel (row 15): a block a key tile and head,
//     sweeping its query tiles in two halves of 32 queries (so S^T, dP^T,
//     dK and dV fit a thread's registers): S^T = K Q^T and dP^T = V dO^T on
//     m64n32 products, then dV += P^T dO and dK += dS^T Q, P^T and dS^T from
//     registers. Shared: K, V, two stages of Q and dO (~121 KB).
//   Every output row is written by one block: no atomics, two calls give the
// same bits. The dQ and dK/dV kernels each recompute S and dP.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int MT = 64;                  // rows of a query or key tile
constexpr int QK = 192;                 // query-key width a head
constexpr int VD = 128;                 // value width a head
constexpr int QC = QK / 64;             // 64-column chunks of a q or k tile
constexpr int VC = VD / 64;             // and of a v or do tile
constexpr int MTHREADS = 128;           // one warpgroup
constexpr int CHUNK = MT * 64 * 2;      // bytes of a 64 x 64 bf16 chunk

// the tile of slot `slot`: x the sequence (< 0: no tile), y its tile
__device__ __forceinline__ bool tile_of(const int2* tiles, int slot, const int* offsets,
                                        int& start, int& n, int& t) {
  const int2 tl = tiles[slot];
  if (tl.x < 0) return false;
  start = offsets[tl.x];
  n = offsets[tl.x + 1] - start;
  t = tl.y;
  return true;
}

// the aligned dynamic shared memory (tiles on the swizzle's 1024 bytes)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// the block's mbarriers: [0] its own tiles, [1 + s] ring stage s
__device__ __forceinline__ void init_bars(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
}

// d[64 x 64] = A[64 x 64 C] B[64 x 64 C]^T of two K-major tiles of C chunks
template <int C>
__device__ __forceinline__ void prod_ss(float (&d)[32], const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64>(d, sw128_desc(a + c * CHUNK + kk * 32, 16, 1024),
                   sw128_desc(b + c * CHUNK + kk * 32, 16, 1024), (c | kk) > 0);
}

// d[64 x 32] = A[64 x 64 C] B[32 x 64 C]^T: rows 32 half.. of B's tile
template <int C>
__device__ __forceinline__ void prod_ss_half(float (&d)[16], const unsigned char* a,
                                             const unsigned char* b, int half) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<32>(d, sw128_desc(a + c * CHUNK + kk * 32, 16, 1024),
                   sw128_desc(b + c * CHUNK + half * 32 * 128 + kk * 32, 16, 1024),
                   (c | kk) > 0);
}

// d[c] [64 x 64] += A[64 x 16 KS] B[16 KS x 64] for each chunk c of B, A
// from registers (KS k16 fragments), B's rows k0 16.. read MN-major (its
// rows the reduction axis)
template <int C, int KS>
__device__ __forceinline__ void prod_rs(float (&d)[C][32], const uint32_t (&a)[KS][4],
                                        const unsigned char* b, int k0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int c = 0; c < C; ++c)
      wgmma_rs<64>(d[c], a[kk], sw128_desc(b + c * CHUNK + (k0 + kk) * 16 * 128, CHUNK, 1024));
}

template <int C>
__device__ __forceinline__ void keep_all(float (&d)[C][32]) {
#pragma unroll
  for (int c = 0; c < C; ++c) keep(d[c]);
}

// the C chunks of head h's columns (width 64 C) of rows `row`.. into dst
template <int C>
__device__ __forceinline__ void load_chunks(unsigned char* dst, const CUtensorMap* map, int h,
                                            int row, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < C; ++c) tma_load_2d(dst + c * CHUNK, map, (h * C + c) * 64, row, bar);
}

// an accumulator row's values (rows r of a thread: C chunks) written to
// dst (fp32, the head's first column) times `mul`
template <int C>
__device__ __forceinline__ void store_row(float* dst, const float (&d)[C][32], int r, int t4,
                                          float mul) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + c * 64 + 8 * j + 2 * t4) =
          make_float2(d[c][4 * j + 2 * r] * mul, d[c][4 * j + 2 * r + 1] * mul);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// shared memory of the forward (Q and the ring) and of the backward's
// kernels (two tiles of their own and the ring)
constexpr size_t FWD_SMEM = 1024 + (QC + 2 * (QC + VC)) * CHUNK + 3 * 8 + 16;
constexpr size_t BWD_SMEM = 1024 + (QC + VC + 2 * (QC + VC)) * CHUNK + 3 * 8 + 16;

// Row 14. Grid (heads, tile slots): a block a query tile of a head.
__global__ void __launch_bounds__(MTHREADS, 1) mla_attn_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const int2* __restrict__ tiles,
    const int* __restrict__ offsets, int heads, float c, float* __restrict__ out,
    float* __restrict__ lse) {
  int start, n, qt;
  if (!tile_of(tiles, blockIdx.y, offsets, start, n, qt)) return;
  const int h = blockIdx.x, tid = threadIdx.x;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);                  // Q
  unsigned char* ring = q_s + QC * CHUNK;                        // [2][K, V]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * (QC + VC) * CHUNK);
  init_bars(bar);
  __syncthreads();
  const int i0 = qt * MT, n_kt = qt + 1, stage = (QC + VC) * CHUNK;
  auto load = [&](int it) {
    unsigned char* dst = ring + (it & 1) * stage;
    uint64_t* fb = bar + 1 + (it & 1);
    mbar_arrive_expect_tx(fb, stage);
    load_chunks<QC>(dst, &k_map, h, start + it * MT, fb);
    load_chunks<VC>(dst + QC * CHUNK, &v_map, h, start + it * MT, fb);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, QC * CHUNK);
    load_chunks<QC>(q_s, &q_map, h, start + i0, bar);
    load(0);
  }
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  int qi[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = i0 + 16 * warp + gq + 8 * r;
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }
  float s[32], o[VC][32];
#pragma unroll
  for (int cc = 0; cc < VC; ++cc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cc][i] = 0.f;
  uint32_t pa[4][4];
  mbar_wait(bar, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (tid == 0 && it + 1 < n_kt) load(it + 1);
    mbar_wait(bar + 1 + st, (it >> 1) & 1);
    const unsigned char* k_t = ring + st * stage;
    wgmma_fence();
    prod_ss<QC>(s, q_s, k_t);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    const bool diag = it == n_kt - 1;
    const int kj0 = it * MT + 2 * t4;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float x = diag && kj0 + 8 * j + e > qi[r] ? -CUDART_INF_F : s[i] * c;
          s[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = row_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pf[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pf[r][e] = exp2f(s[4 * j + 2 * r + e] - m[r]);
          l[r] += pf[r][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) pa[j >> 1][(j & 1) * 2 + r] = pack_bf16(pf[r][0], pf[r][1]);
    }
#pragma unroll
    for (int cc = 0; cc < VC; ++cc)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[cc][4 * j + 2 * r] *= alpha[r];
          o[cc][4 * j + 2 * r + 1] *= alpha[r];
        }
    wgmma_fence();
    prod_rs<VC, 4>(o, pa, k_t + QC * CHUNK, 0);
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(o);
    keep(pa);
    __syncthreads();  // stage st is read
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = row_sum(l[r]);
    if (qi[r] >= n) continue;
    const long long row = start + qi[r];
    store_row<VC>(out + row * heads * VD + h * VD, o, r, t4, 1.f / sum);
    if (t4 == 0) lse[row * heads + h] = m[r] + log2f(sum);
  }
}

// Row 15, dQ. Grid (heads, tile slots): a block a query tile of a head.
__global__ void __launch_bounds__(MTHREADS, 1) mla_attn_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const int2* __restrict__ tiles, const int* __restrict__ offsets,
    const float* __restrict__ lse, const float* __restrict__ delta, int heads, float c,
    float tau, float* __restrict__ dq) {
  int start, n, qt;
  if (!tile_of(tiles, blockIdx.y, offsets, start, n, qt)) return;
  const int h = blockIdx.x, tid = threadIdx.x;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = aligned_smem(smem_raw);                  // Q, dO
  unsigned char* do_s = q_s + QC * CHUNK;
  unsigned char* ring = do_s + VC * CHUNK;                       // [2][K, V]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * (QC + VC) * CHUNK);
  init_bars(bar);
  __syncthreads();
  const int i0 = qt * MT, n_kt = qt + 1, stage = (QC + VC) * CHUNK;
  auto load = [&](int it) {
    unsigned char* dst = ring + (it & 1) * stage;
    uint64_t* fb = bar + 1 + (it & 1);
    mbar_arrive_expect_tx(fb, stage);
    load_chunks<QC>(dst, &k_map, h, start + it * MT, fb);
    load_chunks<VC>(dst + QC * CHUNK, &v_map, h, start + it * MT, fb);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, (QC + VC) * CHUNK);
    load_chunks<QC>(q_s, &q_map, h, start + i0, bar);
    load_chunks<VC>(do_s, &do_map, h, start + i0, bar);
    load(0);
  }
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  int qi[2];
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = i0 + 16 * warp + gq + 8 * r;
    const bool in = qi[r] < n;
    ls[r] = in ? lse[(start + qi[r]) * static_cast<long long>(heads) + h] : 0.f;
    dl[r] = in ? delta[(start + qi[r]) * static_cast<long long>(heads) + h] : 0.f;
  }
  float s[32], dp[32], acc[QC][32];
#pragma unroll
  for (int cc = 0; cc < QC; ++cc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cc][i] = 0.f;
  uint32_t pd[4][4];
  mbar_wait(bar, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (tid == 0 && it + 1 < n_kt) load(it + 1);
    mbar_wait(bar + 1 + st, (it >> 1) & 1);
    const unsigned char* k_t = ring + st * stage;
    wgmma_fence();
    prod_ss<QC>(s, q_s, k_t);
    prod_ss<VC>(dp, do_s, k_t + QC * CHUNK);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);
    const bool diag = it == n_kt - 1;
    const int kj0 = it * MT + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float df[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const bool off = qi[r] >= n || (diag && kj0 + 8 * j + e > qi[r]);
          const float p = off ? 0.f : exp2f(s[i] * c - ls[r]);
          df[r][e] = tau * p * (dp[i] - dl[r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) pd[j >> 1][(j & 1) * 2 + r] = pack_bf16(df[r][0], df[r][1]);
    }
    wgmma_fence();
    prod_rs<QC, 4>(acc, pd, k_t, 0);
    wgmma_commit();
    wgmma_wait<0>();
    keep_all(acc);
    keep(pd);
    __syncthreads();  // stage st is read
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= n) continue;
    store_row<QC>(dq + (start + qi[r]) * static_cast<long long>(heads) * QK + h * QK, acc, r,
                  t4, 1.f);
  }
}

// Row 15, dK and dV. Grid (heads, tile slots): a block a key tile of a
// head, sweeping its query tiles (the diagonal first) in halves of 32.
__global__ void __launch_bounds__(MTHREADS, 1) mla_attn_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const int2* __restrict__ tiles, const int* __restrict__ offsets,
    const float* __restrict__ lse, const float* __restrict__ delta, int heads, float c,
    float tau, float* __restrict__ dk, float* __restrict__ dv) {
  int start, n, kt;
  if (!tile_of(tiles, blockIdx.y, offsets, start, n, kt)) return;
  const int h = blockIdx.x, tid = threadIdx.x;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = aligned_smem(smem_raw);                  // K, V
  unsigned char* v_s = k_s + QC * CHUNK;
  unsigned char* ring = v_s + VC * CHUNK;                        // [2][Q, dO]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * (QC + VC) * CHUNK);
  init_bars(bar);
  __syncthreads();
  const int j0 = kt * MT, n_qt = (n + MT - 1) / MT - kt, stage = (QC + VC) * CHUNK;
  auto load = [&](int it) {
    unsigned char* dst = ring + (it & 1) * stage;
    uint64_t* fb = bar + 1 + (it & 1);
    mbar_arrive_expect_tx(fb, stage);
    load_chunks<QC>(dst, &q_map, h, start + j0 + it * MT, fb);
    load_chunks<VC>(dst + QC * CHUNK, &do_map, h, start + j0 + it * MT, fb);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, (QC + VC) * CHUNK);
    load_chunks<QC>(k_s, &k_map, h, start + j0, bar);
    load_chunks<VC>(v_s, &v_map, h, start + j0, bar);
    load(0);
  }
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  int kj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kj[r] = j0 + 16 * warp + gq + 8 * r;
  float acc_k[QC][32], acc_v[VC][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int cc = 0; cc < QC; ++cc) acc_k[cc][i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < VC; ++cc) acc_v[cc][i] = 0.f;
  }
  mbar_wait(bar, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    if (tid == 0 && it + 1 < n_qt) load(it + 1);
    mbar_wait(bar + 1 + st, (it >> 1) & 1);
    const unsigned char* q_t = ring + st * stage;
    const unsigned char* do_t = q_t + QC * CHUNK;
    const int i0 = j0 + it * MT;
    const bool edge = it == 0 || it == n_qt - 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[16], dp[16];
      uint32_t pa[2][4], pd[2][4];
      wgmma_fence();
      prod_ss_half<QC>(s, k_s, q_t, half);
      prod_ss_half<VC>(dp, v_s, do_t, half);
      wgmma_commit();
      wgmma_wait<0>();
      keep(s);
      keep(dp);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float af[2][2], df[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = i0 + 32 * half + 8 * jj + 2 * t4 + e;
          const bool in = qi < n;
          const long long at = (start + qi) * static_cast<long long>(heads) + h;
          const float ls = in ? lse[at] : 0.f, dl = in ? delta[at] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * jj + 2 * r + e;
            const bool off = edge && !(in && kj[r] <= qi);
            const float p = off ? 0.f : exp2f(s[i] * c - ls);
            af[r][e] = p;
            df[r][e] = tau * p * (dp[i] - dl);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[jj >> 1][(jj & 1) * 2 + r] = pack_bf16(af[r][0], af[r][1]);
          pd[jj >> 1][(jj & 1) * 2 + r] = pack_bf16(df[r][0], df[r][1]);
        }
      }
      wgmma_fence();
      prod_rs<VC, 2>(acc_v, pa, do_t, 2 * half);
      prod_rs<QC, 2>(acc_k, pd, q_t, 2 * half);
      wgmma_commit();
      wgmma_wait<0>();
      keep_all(acc_v);
      keep_all(acc_k);
      keep(pa);
      keep(pd);
    }
    __syncthreads();  // stage st is read
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= n) continue;
    const long long row = start + kj[r];
    store_row<QC>(dk + row * heads * QK + h * QK, acc_k, r, t4, 1.f);
    store_row<VC>(dv + row * heads * VD + h * VD, acc_v, r, t4, 1.f);
  }
}

}  // namespace

// q, k [events, heads 192] and v [events, heads 128] bf16; tiles [slots]
// int2 (sequence, query tile; -1: none); offsets [sequences + 1] int32; c =
// tau log2 e -> out [events, heads 128] fp32 and lse [events, heads] fp32
// (log2 units). Returns the cudaError_t of the launch.
extern "C" int mla_attn_fwd(const void* q, const void* k, const void* v, const int* tiles,
                            int slots, const int* offsets, int events, int heads, float c,
                            float* out, float* lse, void* stream) {
  if (heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (slots <= 0 || events <= 0) return 0;
  CUtensorMap qm, km, vm;
  if (!rows_map(&qm, q, events, heads * QK, MT) || !rows_map(&km, k, events, heads * QK, MT) ||
      !rows_map(&vm, v, events, heads * VD, MT))
    return static_cast<int>(cudaErrorNotSupported);
  return launch(mla_attn_fwd_kernel, dim3(heads, slots), MTHREADS, FWD_SMEM,
                static_cast<cudaStream_t>(stream), qm, km, vm,
                reinterpret_cast<const int2*>(tiles), offsets, heads, c, out, lse);
}

// The backward of mla_attn_fwd with dout [events, heads 128] bf16, lse and
// delta [events, heads] fp32: dq, dk [events, heads 192] and dv [events,
// heads 128] fp32; q_tiles and k_tiles: the slots of the dQ and the dK/dV
// kernels.
extern "C" int mla_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* q_tiles,
                            const int* k_tiles, int slots, const int* offsets, int events,
                            int heads, float c, float tau, float* dq, float* dk, float* dv,
                            void* stream) {
  if (heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (slots <= 0 || events <= 0) return 0;
  CUtensorMap qm, km, vm, dm;
  if (!rows_map(&qm, q, events, heads * QK, MT) || !rows_map(&km, k, events, heads * QK, MT) ||
      !rows_map(&vm, v, events, heads * VD, MT) || !rows_map(&dm, dout, events, heads * VD, MT))
    return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch(mla_attn_bwd_dkv_kernel, dim3(heads, slots), MTHREADS, BWD_SMEM, s, qm, km,
                         vm, dm, reinterpret_cast<const int2*>(k_tiles), offsets, lse, delta,
                         heads, c, tau, dk, dv);
  if (err != 0) return err;
  return launch(mla_attn_bwd_dq_kernel, dim3(heads, slots), MTHREADS, BWD_SMEM, s, qm, km, vm, dm,
                reinterpret_cast<const int2*>(q_tiles), offsets, lse, delta, heads, c, tau, dq);
}
