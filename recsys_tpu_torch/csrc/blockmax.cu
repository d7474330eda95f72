// Group-max sieve, pass 1, for Hopper (sm_90a): for each query and each
// group of g consecutive items, the max of the fp32-accumulated dots.
//
// Replaces: recsys_tpu/ops/pallas/topk_flash.py::_blockmax_kernel (the TPU
// kernel reached through blockmax_topk).
//
// Computes out[q, j] = max over items i in [j*g, min((j+1)*g, N)) of
// u_q . v_i, for u [Q, d] and v [N, d] both bf16 (the served route's
// operands), into out [Q, ceil(N / g)] fp32. Every group holds at least
// one real item; items past N are never scored, so a padded item never
// wins a group (the TPU kernel scores them -1e30 for the same effect).
//
// What bounds it on the H100: at serving shapes, bytes. With Q <= 64 the
// product is 2*Q*N*d operations against N*d*2 bytes of bf16 catalog: at
// N = 1,048,576, d = 128 that is 268 MB, 0.080 ms at 3.35 TB/s, far above
// the 0.0035 ms of 17 GFLOP at the 989 TFLOP/s bf16 tensor-core rate. At
// Q = 4,096, N = 8,388,608 it is operations: 8.8 TFLOP, 8.9 ms at the bf16
// tensor-core rate.
//
// The kernel (blockmax_tc_kernel) runs on the tensor cores: warp-level
// mma.sync.m16n8k16 with fp32 sums (a product of two bf16 values is exact
// in fp32, so each dot equals the TPU's fp32-accumulated bf16 dot up to
// summation order). The block's queries live in registers as A fragments
// for the whole sweep, and the catalog streams through shared memory in
// 64-item tiles, cp.async 16-byte copies three stages deep, so that at
// Q <= 64 the copies, not the products, set the pace. The query tile is
// sized to Q by the wrapper's plan (16 rows where Q <= 16, else 64): at
// Q = 1 a 64-row tile would multiply 63 rows of padding. fp32 operands
// have no kernel here: their plain version (ops/topk_flash.py) serves the
// CPU only.
//
// Design, and how it departs from the TPU kernel:
// * Blocks run in no order, so a block owns one query tile and
//   groups_per_block whole groups: no sum and no max crosses blocks, and
//   each output element is written once. A group's items are swept in
//   64-item tiles starting at the group's first item, so a tile never
//   straddles two groups; the running max of each row is kept in
//   registers over the group's tiles and reduced across the four lanes of
//   an accumulator's row (and, with a 16-row tile, across the warps that
//   split the tile's items) when the group ends.
// * The output is [Q, n_groups] directly: the TPU's transposed
//   [n_groups, Q] layout only served Mosaic's reshape rules. Ragged Q and N
//   are masked here, so no padding to the TPU's tile multiples (tb a
//   multiple of 8*g, tq of 128) and any N and g work.
// * Re-streaming the catalog once per query tile would read it
//   ceil(Q / tile) times (64 x 2.1 GB at Q = 4,096, N = 8M). The grid is one
//   dimension with the query tile varying fastest, so the ceil(Q / tile)
//   blocks of one group chunk are dispatched together: the first reads the
//   chunk from device memory and the others find it in the 50 MB L2. The
//   queries (1 MB at Q = 4,096 in bf16) stay in L2 throughout.
// * Any d up to 256: the kernel pads d to DP in {32, 64, 128, 256} with
//   zeros in shared memory (16-byte copies where d % 8 == 0, element by
//   element otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TB = 64;  // items per scoring tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_STAGES = 3;  // catalog tiles in flight

template <int TQB, int DP>
constexpr size_t tc_smem() {
  return sizeof(__nv_bfloat16) * (TQB + TC_STAGES * TB) * (DP + 8) +
         sizeof(float) * TC_WARPS * 16;
}

// Block b owns query tile b % n_qtiles (TQB rows) and groups_per_block
// whole groups of chunk b / n_qtiles, swept as one sequence of 64-item
// tiles (each group's tiles start at its first item). The warps form a
// (TQB / 16) x WN grid: warp (wm, wn) holds the A fragments of query rows
// 16wm.. and scores items wn * IW.. of every tile, so with TQB = 16 the
// four warps split the tile's items and with TQB = 64 each warp scores
// the whole tile for its own rows.
template <int TQB, int DP>
__global__ void __launch_bounds__(TC_THREADS) blockmax_tc_kernel(
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ v, int q_n,
    int n, int d, int g, int n_groups, int groups_per_block, int n_qtiles, int vec,
    float* __restrict__ out) {
  constexpr int LD = DP + 8;  // 16-byte rows on distinct banks for ldmatrix
  constexpr int WM = TQB / 16, WN = TC_WARPS / WM, IW = TB / WN, NTI = IW / 8, KS = DP / 16;
  static_assert(WM * WN == TC_WARPS && NTI % 2 == 0, "warp grid");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQB][LD]
  __nv_bfloat16* Vs = Us + TQB * LD;                                // [TC_STAGES][TB][LD]
  float* red = reinterpret_cast<float*>(Vs + TC_STAGES * TB * LD);  // [WN][16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row group and column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix and row of this lane
  const int wm = warp / WN, wn = warp % WN;
  const int q0 = (blockIdx.x % n_qtiles) * TQB;
  const int grp_begin = (blockIdx.x / n_qtiles) * groups_per_block;
  const int grp_end = min(n_groups, grp_begin + groups_per_block);
  const int tpg = (g + TB - 1) / TB;  // tiles per group
  const int n_t = (grp_end - grp_begin) * tpg;

  // tile i of the block's sequence: its group, first item and end of group
  auto tile_of = [&](int i, int& grp, int& t0, int& item_end) {
    grp = grp_begin + i / tpg;
    t0 = grp * g + (i % tpg) * TB;
    item_end = min(n, (grp + 1) * g);
  };
  auto stage = [&](int i) {
    if (i < n_t) {
      int grp, t0, item_end;
      tile_of(i, grp, t0, item_end);
      if (t0 < item_end)
        stage_rows<DP, TC_THREADS>(Vs + (i % TC_STAGES) * TB * LD, LD, v, t0, item_end, TB,
                                   d, vec != 0);
    }
    cp_async_commit();  // one group per tile, empty or not
  };

  stage_rows<DP, TC_THREADS>(Us, LD, u, q0, q_n, TQB, d, vec != 0);
  for (int i = 0; i < TC_STAGES - 1; ++i) stage(i);  // the queries ride with tile 0

  uint32_t qa[KS][4];  // the warp's A fragments of its 16 query rows
  float rmax[2] = {NEG_INF, NEG_INF};  // rows 16wm + gq and 16wm + gq + 8

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait_one();  // tile i has landed (tile i + 1 may be in flight)
    __syncthreads();      // for every thread; tile i - 1's readers are done
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qa[kk], Us + (16 * wm + (lm & 1) * 8 + lr) * LD + kk * 16 + (lm >> 1) * 8);
    }
    stage(i + TC_STAGES - 1);  // into the stage that tile i - 1 used

    int grp, t0, item_end;
    tile_of(i, grp, t0, item_end);
    if (t0 < item_end) {  // block-uniform: the last group may end early
      const __nv_bfloat16* Vb = Vs + (i % TC_STAGES) * TB * LD + wn * IW * LD;
      // s[nt][2h + e]: row 16wm + gq + 8h, item t0 + wn*IW + nt*8 + 2*t4 + e
      float s[NTI][4];
#pragma unroll
      for (int nt = 0; nt < NTI; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NTI / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, Vb + (np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
        }
      }
      const int lim = item_end - t0 - wn * IW;  // items of this warp that are real
#pragma unroll
      for (int nt = 0; nt < NTI; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nt * 8 + 2 * t4 + e < lim) {
#pragma unroll
            for (int h = 0; h < 2; ++h) rmax[h] = fmaxf(rmax[h], s[nt][2 * h + e]);
          }
    }

    if (i % tpg == tpg - 1) {  // the group's last tile: reduce and write
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = rmax[h];
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
        rmax[h] = m;
      }
      if (WN == 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 16 * wm + gq + 8 * h;
          if (t4 == 0 && q < q_n) out[static_cast<long long>(q) * n_groups + grp] = rmax[h];
        }
      } else {
        if (t4 == 0) {
          red[wn * 16 + gq] = rmax[0];
          red[wn * 16 + gq + 8] = rmax[1];
        }
        __syncthreads();  // block-uniform: every warp ends the group together
        if (tid < 16) {
          float m = red[tid];
#pragma unroll
          for (int w = 1; w < WN; ++w) m = fmaxf(m, red[w * 16 + tid]);
          const int q = q0 + tid;
          if (q < q_n) out[static_cast<long long>(q) * n_groups + grp] = m;
        }
      }
      rmax[0] = rmax[1] = NEG_INF;
    }
  }
  cp_async_wait_all();  // no copy may outlive the block
}

template <int TQB, int DP>
int launch_tc(const __nv_bfloat16* u, const __nv_bfloat16* v, int q_n, int n, int d, int g,
              int groups_per_block, int vec, float* out, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem<TQB, DP>();
  // the attribute belongs to the current device: set it on every launch
  cudaError_t e = cudaFuncSetAttribute(blockmax_tc_kernel<TQB, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_groups = static_cast<int>((static_cast<long long>(n) + g - 1) / g);
  const int n_qtiles = (q_n + TQB - 1) / TQB;
  const long long n_chunks = (n_groups + groups_per_block - 1) / groups_per_block;
  const long long n_blocks = n_chunks * n_qtiles;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  blockmax_tc_kernel<TQB, DP><<<static_cast<unsigned>(n_blocks), TC_THREADS, bytes, stream>>>(
      u, v, q_n, n, d, g, n_groups, groups_per_block, n_qtiles, vec, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TQB>
int dispatch_tc(const __nv_bfloat16* u, const __nv_bfloat16* v, int q_n, int n, int d,
                int g, int groups_per_block, int vec, float* out, cudaStream_t s) {
  if (d <= 32) return launch_tc<TQB, 32>(u, v, q_n, n, d, g, groups_per_block, vec, out, s);
  if (d <= 64) return launch_tc<TQB, 64>(u, v, q_n, n, d, g, groups_per_block, vec, out, s);
  if (d <= 128) return launch_tc<TQB, 128>(u, v, q_n, n, d, g, groups_per_block, vec, out, s);
  if (d <= 256) return launch_tc<TQB, 256>(u, v, q_n, n, d, g, groups_per_block, vec, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// u [q_n, d], v [n, d] contiguous, both bf16; out [q_n, ceil(n / g)]
// fp32. The tensor-core kernel takes a query tile of tq in {16, 64} and
// 1 <= d <= 256 (vec != 0 when d % 8 == 0 and u, v start on 16 bytes).
// Returns the cudaError_t of the launch.
extern "C" int blockmax_group_max(const void* u, const void* v, int q_n, int n, int d,
                                  int g, int groups_per_block, int tq, int vec, float* out,
                                  void* stream) {
  if (q_n <= 0 || n <= 0) return 0;
  if (d <= 0 || d > 256 || g <= 0 || groups_per_block <= 0 || (tq != 16 && tq != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ub = static_cast<const __nv_bfloat16*>(u);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  return tq == 16 ? dispatch_tc<16>(ub, vb, q_n, n, d, g, groups_per_block, vec, out, s)
                  : dispatch_tc<64>(ub, vb, q_n, n, d, g, groups_per_block, vec, out, s);
}
