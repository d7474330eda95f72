// Flash in-batch softmax cross-entropy for Hopper (sm_90a): the forward
// pass, the fused backward pass and the two-kernel backward.
//
// Replaces: recsys_tpu/ops/pallas/flash_ce.py::_fwd_kernel (reached
// through _flash_fwd_raw), ::_bwd_fused_kernel (reached through
// _flash_bwd_fused_raw), and ::_bwd_du_kernel and ::_bwd_dv_kernel (both
// reached through _flash_bwd_twokernel_raw, the TPU's backward when the
// fused kernel's dU partials would pass _FUSED_BWD_PARTIALS_CAP).
//
// All four work on the corrected, accidental-masked logits
//     s_ij = u_i . v_j + colcorr_j,   s_ij = -1e9 where ids_q[i] == ids_k[j]
//                                      and j != pos[i]
// of Bq query rows u [Bq, D] against Bk candidate rows v [Bk, D] (bf16 or
// fp32), without ever writing the [Bq, Bk] matrix to device memory
// (masked_logit below is their one shared logit code):
//   * forward: lse_i = log sum_j exp(s_ij) (online max / sum-exp over
//     candidate tiles, m starting at -1e9 and the sum floored at 1e-30
//     before the log, as on the TPU) and the positive logit s_{i,pos_i};
//   * backward: with p = exp(s - lse) and pg = p * g_i, dV = pg^T U,
//     dU = pg V and dcol = column sums of pg (fp32 pg for dcol; pg rounded
//     to the operand type for both products, as the TPU kernels do).
//     The label terms (-g_i v_{pos_i} etc.) are added outside, in PyTorch.
//
// What bounds them on the H100: the TPU kernels are matrix-unit bound
// (2*Bq*Bk*D products forward, 6*Bq*Bk*D fused backward, 8*Bq*Bk*D for
// the two-kernel backward, which recomputes the logits in each kernel)
// plus one exp per logit and kernel. At Bq = Bk = 8192, D = 128 in bf16
// the tensor-core bound is 0.017 ms forward and the Bq*Bk exps on the
// special-function units take about as long.
//   Every kernel of bf16 operands runs its products on wgmma, Hopper's
// warpgroup products (hopper.cuh): the forward (flash_ce_fwd_wgmma_kernel,
// row 4), the dV/dcol kernel (flash_ce_bwd_dv_wgmma_kernel, row 7) and the
// dU kernel (flash_ce_bwd_du_wgmma_kernel, row 6). A producer warpgroup
// keeps a ring of TMA-loaded tiles of the swept axis in flight and two
// consumer warpgroups of 64 rows of the block's own axis take turns at the
// tensor cores (FlashAttention-3's ping-pong), so that one's exps run under
// the other's products. Rows 6 and 7, one the other with the axes swapped,
// run two products a tile, P^T (row 7) or P (row 6) from the logits'
// accumulators straight into the register A operand of the second, the
// exps of one tile under the products of the next. Row 4 runs one product a
// half tile and holds two blocks an SM to D = 128, so that four consumer
// warps share each SM sub-partition (FwdWg). What bounded all three on
// mma.sync, their first design, was the instruction itself and its
// traffic: 64-row blocks each streamed the whole swept axis, ~146 GB
// through L2 at 131,072 x 262,144, by the threads' own cp.async. With
// 128-row blocks, TMA copies that spend no thread's registers or
// instructions, and wgmma, at 131,072 x 262,144, D = 128 row 7 takes
// 36.6-36.7 device ms (480 TFLOP/s, 49% of the 17.8 ms tensor-core bound)
// against 101.7-102.2 on mma.sync, row 6 34.4-35.2 against 97.8-98.1
// (50-52% of the bound) and row 4 28.4-28.6 against 56.6-56.9 (31% of its
// 8.9 ms bound); at 8,192^2 row 7 takes 0.0755 ms against 0.2258, row 6
// 0.073 against 0.212-0.214 and row 4 0.064 against 0.124 (NVIDIA H100 80GB
// HBM3, 700 W). All three are bound by the elementwise work beside the
// products: the exps (expf, 8 instructions each) and masks take more
// instruction slots than the products take tensor-core time (ex2.approx
// instead of expf measured 11% faster on row 7 and ~20% on row 4, at other
// last bits). Row 4 does half the tensor-core work of the others with the
// same exps, so its pace is its warps' issue rate: with two consumer warps
// a sub-partition it took 31.9 device ms at the giant shape, and 27.0 with
// no product at all (an instruction issued in ~60% of the cycles); with
// four, 28.4. So no tile is
// multicast to a cluster of blocks: the ~70 GB of tiles a call reads
// through L2 at 131,072 x 262,144 (~1.9 TB/s) do not set the pace.
//   The kernels of fp32 operands run every product on the fp32 FMA units
// (fp32 operands must meet a 1e-5 contract, which TF32 tensor cores
// cannot), bound by the fp32 instruction rate and, where a thread's
// register tile is small, by shared-memory loads (an SM reads 32 floats
// of shared memory a clock and retires 128 FMAs). Both (the forward, row
// 4; the fused backward, row 5, the backward of every fp32 training step)
// read 128-bit rows of one row-major layout in shared memory into register
// tiles of 8 x 8 outputs per thread, laid out so that no load meets a bank
// conflict (grid_col / grid_row, rows padded by 4 or 8 floats): four FMAs
// per float loaded, the rate at which shared memory keeps the FMA units
// fed; s_product is their shared logits product. Each holds one 8-warp
// block of ~170-250 registers a thread per SM. The fused kernel's other
// limit is bytes: the dU partials (see below). What every kernel keeps
// from the TPU kernels is the memory side: the logits never leave the
// chip.
//
// Design, and how it departs from the TPU kernels:
// * Forward, bf16: 128 query rows a block, 64 a consumer warpgroup, U
//   loaded once by TMA, 128-candidate tiles through the ring with their
//   columns' (colcorr, id); per half tile S on wgmma, then the masked
//   logits (in place: no product of the warpgroup is in flight), the
//   positive logit (tested only in the half tile that holds it) and each
//   lane's running max and sum-exp, the quad's four lanes combined once at
//   the end. Where the query blocks alone would leave the card thin
//   (8,192 rows: 64 blocks) the candidate sweep splits into parts (the
//   wrapper's fwd_plan: 4 at 8,192^2, one at 131,072 rows) whose (m, l,
//   positive logit) a second small kernel, launched by the same host call,
//   folds in part order.
// * Forward, fp32: a block holds 128 query rows in shared memory and sweeps
//   the 128-candidate tiles of its part (64 and 64 at DP = 256), each staged
//   by cp.async into one of two buffers while the other computes; S on 8 x
//   8 register tiles. A row's 16 columns of threads lie on two warps, so
//   no shuffle reduces a tile: each thread keeps a running (m, l, positive
//   logit) per row over its own columns of the whole sweep (one rescale
//   per tile, one exp per logit), and the 16 fold once, after the sweep,
//   through shared memory in a fixed order by the combine kernel's formula.
//   Parts as for bf16 (fwd_plan: 8 at 8,192^2, one block per SM), folded
//   by the same combine kernel.
// * Fused backward (the route of fp32 operands at every shape): grid
//   (n_spans, parts). A block owns tiles_per_block consecutive candidate
//   tiles of 128 (64 at DP = 256, where 128 would not fit 227 KB of shared
//   memory; one tile a block while the partials fit the wrapper's cap) and
//   sweeps the query rows of its part of the query axis, 128 (64 at DP =
//   256) at a time, the plan's 64-row query tiles taken two at a time. The
//   parts (blockIdx.y) fill the card where the candidate spans alone would
//   not (the wrapper's bwd_plan: 64 spans x 4 parts at 8,192^2, re-split
//   where one block per SM would leave the last wave thin: 20,000^2 runs
//   157 spans x 5 parts, not x 1). The block stages its candidate tile
//   once; each query tile is copied by cp.async into one buffer, the next
//   tile's copy running under the dU product. Three products (S = U V^T,
//   dV += P^T U, dU = P V), P through shared memory once per (i, j),
//   between the S product and the other two. Each block writes the dU of
//   its own query rows into its span's partial du_part[x] ([n_spans, Bq,
//   D]) and its dV and dcol into [parts, Bk, D] / [parts, Bk]; the wrapper
//   sums each over its first axis with torch.sum, as the TPU wrapper sums
//   its dU partials with jnp.sum. No atomics: two calls give the same bits.
// * Two-kernel backward (every bf16 backward, rows 6 and 7 on wgmma): the
//   dU kernel's block owns a query block and sweeps the candidate tiles of
//   its part, keeping its fp32 dU in registers and writing it once; the dV
//   kernel's block owns a candidate block and sweeps the query tiles,
//   keeping dV_j and dcol_j in registers. Nothing crosses blocks, so
//   neither needs atomics; the TPU's sequential grid axis becomes each
//   block's loop. 128-row blocks of their own axis and 128-row tiles of the
//   swept one; where the blocks alone would leave the card thin (8,192
//   rows), the swept axis splits into parts by waves of one block per SM
//   (the wrapper's du_plan and dv_plan: 2 parts at 8,192^2, one at 131,072
//   x 262,144) whose partials the wrapper sums in a fixed order.
// * The TPU wrapper asserts that its tiles divide the batch; here rows
//   past Bq and candidates past Bk are masked, so any Bq, Bk work.
// * D is padded to DP in {32, 64, 128, 256} with zeros in shared memory;
//   the backward kernels of bf16 operands split DP = 256 into two column
//   slices of 128 (blockIdx.z), each recomputing the full-width logits.
// * Offsets into u, v and the outputs are 64-bit (rows * d passes 2^31 at
//   these shapes); no [Bq, Bk] offset is ever formed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int TQ = 64;        // query rows per tile of bwd_plan's parts
constexpr int THREADS = 256;  // threads of every fp32 kernel
constexpr float NEG_BIG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// the corrected, accidental-masked logit of one (query, candidate) pair
__device__ __forceinline__ float masked_logit(float dot, float corr, int id_q, int id_k,
                                              int col, int pos) {
  return (id_q == id_k && col != pos) ? NEG_BIG : dot + corr;
}

// ---- the FMA kernels of fp32 operands: their shared pieces -----------------

// fp32 rows [row0, row0 + rows) of src [n_rows, d] -> dst [rows][ld],
// columns [0, DP), zero past n_rows and past d, by the NTHREADS threads of
// the block: cp.async 16 bytes at a time when rows start on 16 bytes (vec:
// d % 4 == 0 and src on 16 bytes), element by element otherwise
template <int DP, int NTHREADS>
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* __restrict__ src,
                                               int row0, int n_rows, int rows, int d, bool vec) {
  constexpr int CPR = DP / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CPR; e += NTHREADS) {
    const int r = e / CPR, c4 = (e % CPR) * 4;
    const int gr = row0 + r;
    float* out = dst + r * ld + c4;
    if (vec) {
      const bool ok = gr < n_rows && c4 < d;
      cp_async16(out, ok ? src + static_cast<long long>(gr) * d + c4 : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j] = (gr < n_rows && c4 + j < d) ? src[static_cast<long long>(gr) * d + c4 + j] : 0.f;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// component e of x (e is a constant once the loops are unrolled)
__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Column and row of thread tid in a THREADS-thread grid of COLS columns:
// the 8 lanes of a quarter-warp on 8 consecutive columns of one row, the
// warp's four quarters on consecutive rows. With rows of shared memory 4
// or 8 floats past a multiple of 32 banks, every 128-bit load of the
// products below is one broadcast row segment or 4 or 8 distinct rows on
// disjoint banks: no bank conflicts.
template <int COLS>
__device__ __forceinline__ int grid_col(int tid) {
  return ((tid >> 5) % (COLS / 8)) * 8 + (tid & 7);
}
template <int COLS>
__device__ __forceinline__ int grid_row(int tid) {
  return ((tid >> 5) / (COLS / 8)) * 4 + ((tid >> 3) & 3);
}

// s[i][j] = A[sr + 16i] . B[sc + 16j] over DP columns, A and B rows of LD
// floats in shared memory read 128 bits at a time (sr, sc: grid_row<16>,
// grid_col<16>): RM + RN loads of 4 floats per 4 RM RN FMAs
template <int DP, int LD, int RM, int RN>
__device__ __forceinline__ void s_product(const float* A, const float* B, int sr, int sc,
                                          float s[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < DP; k += 4) {
    float4 b[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = ld4(B + (sc + 16 * j) * LD + k);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = ld4(A + (sr + 16 * i) * LD + k);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// candidate tile kt (KT rows of v) into buffer buf of Vs [2][KT][LD], and
// its colcorr and ids_k into cs, ks [2][KT], 0 past bk: row 4
template <int DP, int KT, int LD>
__device__ __forceinline__ void stage_candidates(float* Vs, float* cs, int* ks, int buf, int kt,
                                                 const float* __restrict__ v,
                                                 const float* __restrict__ colcorr,
                                                 const int* __restrict__ ids_k, int bk, int d,
                                                 bool vec) {
  const int k0 = kt * KT, tid = threadIdx.x;
  stage_rows_f32<DP, THREADS>(Vs + buf * KT * LD, LD, v, k0, bk, KT, d, vec);
  if (tid < KT) {
    const int c = k0 + tid;
    cs[buf * KT + tid] = c < bk ? colcorr[c] : 0.f;
    ks[buf * KT + tid] = c < bk ? ids_k[c] : 0;
  }
}

// ---- row 5 in fp32: the fused backward on the FMA units -------------------

// The tiling of row 5 at padded width DP: a block owns candidate tiles of
// KC = 128 and sweeps query tiles of TQF = 128 rows (64 and 64 at DP = 256,
// where 128 would not fit 227 KB of shared memory), one buffer, and the
// register tile per thread of the S (8 x 8, or 4 x 4), dV and dU products.
template <int DP>
struct Fp32Bwd {
  static constexpr int W = DP;
  static constexpr int KC = DP < 256 ? 128 : 64;
  static constexpr int TQF = DP < 256 ? 128 : 64;
  static constexpr int LD = DP + 4;   // floats per U and V row in shared memory
  static constexpr int LDP = KC + 8;  // floats per P row
  // S = U V^T [TQF x KC]: rows sr + 16i, candidates sc + 16j
  static constexpr int S_RM = TQF / 16, S_RN = KC / 16;
  // dV [KC x DP]: candidates 4 (vc + V_CG a) + e, columns 4 (vf + V_FG t) + e
  static constexpr int V_FG = DP / 4 < 16 ? DP / 4 : 16, V_CG = THREADS / V_FG;
  static constexpr int V_CN = KC / 4 / V_CG, V_FN = DP / 4 / V_FG;
  static_assert(V_CN * V_CG * 4 == KC && V_FN * V_FG * 4 == DP, "dV tiling");
  static_assert(16 * KC <= TQF * LDP && TQF <= THREADS, "dcol reduction, row staging");
  // dU [TQF x DP]: rows ur + U_RG i, columns 4 (uf + U_FG t) + e
  static constexpr int U_FG = DP / 4 < 16 ? DP / 4 : 16, U_RG = THREADS / U_FG;
  static constexpr int U_RM = TQF / U_RG, U_FN = DP / 4 / U_FG;
  static_assert(U_RM * U_RG == TQF && U_FN * U_FG * 4 == DP, "dU tiling");
  static constexpr size_t smem() {
    return sizeof(float) * ((KC + TQF) * LD + TQF * LDP) +
           TQF * (2 * sizeof(float) + 2 * sizeof(int));
  }
};

// The colcorr and ids_k of the thread's candidates sc + 16j of the tile at
// k0 (0 past bk), and its dcol and dV sums set to 0.
template <class T>
__device__ __forceinline__ void begin_candidates(const float* __restrict__ colcorr,
                                                 const int* __restrict__ ids_k, int k0, int bk,
                                                 float (&corr)[T::S_RN], int (&kid)[T::S_RN],
                                                 float (&dcol)[T::S_RN],
                                                 float (&dv)[4 * T::V_CN][4 * T::V_FN]) {
  const int sc = grid_col<16>(threadIdx.x);
#pragma unroll
  for (int j = 0; j < T::S_RN; ++j) {
    const int c = k0 + sc + 16 * j;
    corr[j] = c < bk ? colcorr[c] : 0.f;
    kid[j] = c < bk ? ids_k[c] : 0;
    dcol[j] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4 * T::V_CN; ++a)
#pragma unroll
    for (int b = 0; b < 4 * T::V_FN; ++b) dv[a][b] = 0.f;
}

// One query tile of row 5, the tile's rows Us [TQF][LD] from q0
// and their lse, g, ids and positives in shared memory, the candidates Vs
// [KC][LD] from k0:
//   S = U_i V^T from 128-bit loads of rows along the feature axis (rows sr
//   + 16i, candidates sc + 16j);
//   P = exp(S - lse) g (masked_logit, 0 past row_end and past bk) into Ps
//   [TQF][LDP], fp32 (no rounding, as the plain version of fp32 operands),
//   its column sums into dcol;
//   once P is whole, dV += P^T U_i (dV as Fp32Bwd lays it out).
// The caller has made the tile and its rows visible, and every reader of
// Ps from the tile before done (one __syncthreads covers both).
template <class T>
__device__ __forceinline__ void bwd_tile_dv(const float* Us, const float* Vs, float* Ps,
                                            const float* lse_s, const float* g_s,
                                            const int* idq_s, const int* pos_s, int q0,
                                            int row_end, int k0, int bk,
                                            const float (&corr)[T::S_RN],
                                            const int (&kid)[T::S_RN], float (&dcol)[T::S_RN],
                                            float (&dv)[4 * T::V_CN][4 * T::V_FN]) {
  constexpr int LD = T::LD, LDP = T::LDP;
  const int tid = threadIdx.x;
  const int sc = grid_col<16>(tid), sr = grid_row<16>(tid);
  const int vf = grid_col<T::V_FG>(tid), vc = grid_row<T::V_FG>(tid);
  float s[T::S_RM][T::S_RN];
  s_product<T::W, LD, T::S_RM, T::S_RN>(Us, Vs, sr, sc, s);
#pragma unroll
  for (int i = 0; i < T::S_RM; ++i) {
    const int rl = sr + 16 * i;
    const bool rok = q0 + rl < row_end;
    const float lse_r = lse_s[rl], g_r = g_s[rl];
    const int idq_r = idq_s[rl], pos_r = pos_s[rl];
#pragma unroll
    for (int j = 0; j < T::S_RN; ++j) {
      const int cl = sc + 16 * j;
      float pg = 0.f;
      if (rok && k0 + cl < bk) {
        const float x = masked_logit(s[i][j], corr[j], idq_r, kid[j], k0 + cl, pos_r);
        pg = expf(x - lse_r) * g_r;
      }
      dcol[j] += pg;
      Ps[rl * LDP + cl] = pg;
    }
  }
  __syncthreads();  // P is whole

  // dV[c][k] += sum_r P[r][c] U_i[r][k]
#pragma unroll 2
  for (int r = 0; r < T::TQF; ++r) {
    float4 p[T::V_CN], x[T::V_FN];
#pragma unroll
    for (int a = 0; a < T::V_CN; ++a) p[a] = ld4(Ps + r * LDP + 4 * (vc + T::V_CG * a));
#pragma unroll
    for (int t = 0; t < T::V_FN; ++t) x[t] = ld4(Us + r * LD + 4 * (vf + T::V_FG * t));
#pragma unroll
    for (int a = 0; a < 4 * T::V_CN; ++a)
#pragma unroll
      for (int b = 0; b < 4 * T::V_FN; ++b)
        dv[a][b] = fmaf(comp(p[a / 4], a % 4), comp(x[b / 4], b % 4), dv[a][b]);
  }
}

// The candidate tile's dcol (each candidate's sums over the 16 row groups
// of threads, added in order through Ps) and dV into part `part` of
// dcol_part [parts, Bk] and dv_part [parts, Bk, D] (16-byte stores where
// vec). Waits for every reader of Ps first.
template <class T>
__device__ __forceinline__ void store_dv_dcol(float* Ps, const float (&dcol)[T::S_RN],
                                              const float (&dv)[4 * T::V_CN][4 * T::V_FN],
                                              int k0, int bk, int d, int vec, int part,
                                              float* __restrict__ dv_part,
                                              float* __restrict__ dcol_part) {
  constexpr int KC = T::KC;
  const int tid = threadIdx.x;
  const int sc = grid_col<16>(tid), sr = grid_row<16>(tid);
  const int vf = grid_col<T::V_FG>(tid), vc = grid_row<T::V_FG>(tid);
  __syncthreads();  // every reader of Ps is done
#pragma unroll
  for (int j = 0; j < T::S_RN; ++j) Ps[sr * KC + sc + 16 * j] = dcol[j];
  __syncthreads();
  if (tid < KC && k0 + tid < bk) {
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) x += Ps[t * KC + tid];
    dcol_part[static_cast<long long>(part) * bk + k0 + tid] = x;
  }
#pragma unroll
  for (int a = 0; a < 4 * T::V_CN; ++a) {
    const int c = k0 + 4 * (vc + T::V_CG * (a / 4)) + a % 4;
    if (c >= bk) continue;
    float* out = dv_part + (static_cast<long long>(part) * bk + c) * d;
#pragma unroll
    for (int t = 0; t < T::V_FN; ++t) {
      const int k = 4 * (vf + T::V_FG * t);
      if (k >= d) continue;
      if (vec)
        *reinterpret_cast<float4*>(out + k) =
            make_float4(dv[a][4 * t], dv[a][4 * t + 1], dv[a][4 * t + 2], dv[a][4 * t + 3]);
      else
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < d) out[k + e] = dv[a][4 * t + e];
    }
  }
}

// The fused backward of fp32 operands on the FMA units, on the wrapper's
// bwd_plan. Grid (n_spans, parts): block (x, y) owns tiles_per_block
// consecutive KC-candidate tiles and sweeps the query rows of part y
// (q_tiles_per_part of the plan's 64-row tiles) TQF rows at a time, each
// staged by cp.async with its lse, g, ids and positives. Per (query tile
// i, candidate tile j), 256 threads:
//   S, P (its column sums into dcol) and dV_j += P^T U_i, held in
//   registers over the sweep (bwd_tile_dv);
//   the next query tile's copy starts, over U_i's buffer;
//   dU_ij = P V_j, written to du_part[x] (the first tile writes, later
//   ones add: same thread, fixed order).
// dV and dcol go to [parts, Bk, D] / [parts, Bk] after the sweep. No
// atomics: two calls give the same bits.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_ce_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ colcorr,
    const int* __restrict__ ids_q, const int* __restrict__ ids_k, const int* __restrict__ pos,
    const float* __restrict__ lse, const float* __restrict__ g, int bq, int bk, int d, int vec,
    int tiles_per_block, int q_tiles_per_part, float* __restrict__ dv_part,
    float* __restrict__ dcol_part, float* __restrict__ du_part) {
  using T = Fp32Bwd<DP>;
  constexpr int KC = T::KC, TQF = T::TQF, LD = T::LD, LDP = T::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Vs = reinterpret_cast<float*>(smem_raw);     // [KC][LD] this tile's candidates
  float* Us = Vs + KC * LD;                            // [TQF][LD] the query tile
  float* Ps = Us + TQF * LD;                           // [TQF][LDP] p*g of (i, j)
  float* lse_s = Ps + TQF * LDP;                       // [TQF]
  float* g_s = lse_s + TQF;                            // [TQF]
  int* idq_s = reinterpret_cast<int*>(g_s + TQF);     // [TQF]
  int* pos_s = idq_s + TQF;                            // [TQF]

  const int tid = threadIdx.x;
  const int uf = grid_col<T::U_FG>(tid), ur = grid_row<T::U_FG>(tid);
  const int row_begin = blockIdx.y * q_tiles_per_part * TQ;  // the part's query rows
  const int row_end = min(bq, row_begin + q_tiles_per_part * TQ);
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile_end = min(tile0 + tiles_per_block, (bk + KC - 1) / KC);
  float* du_out = du_part + static_cast<long long>(blockIdx.x) * bq * d;

  auto stage_query_tile = [&](int q0) {
    stage_rows_f32<DP, THREADS>(Us, LD, u, q0, row_end, TQF, d, vec != 0);
    if (tid < TQF) {
      const int r = q0 + tid;
      const bool ok = r < row_end;
      lse_s[tid] = ok ? lse[r] : 0.f;
      g_s[tid] = ok ? g[r] : 0.f;
      idq_s[tid] = ok ? ids_q[r] : 0;
      pos_s[tid] = ok ? pos[r] : -1;
    }
  };

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int k0 = tile * KC;
    const bool first = tile == tile0;
    __syncthreads();  // the previous tile's readers of Vs, Us, Ps and the rows are done
    stage_rows_f32<DP, THREADS>(Vs, LD, v, k0, bk, KC, d, vec != 0);
    if (row_begin < row_end) stage_query_tile(row_begin);
    cp_async_commit();
    float corr[T::S_RN], dcol_acc[T::S_RN];
    int kid[T::S_RN];
    float dv[4 * T::V_CN][4 * T::V_FN];
    begin_candidates<T>(colcorr, ids_k, k0, bk, corr, kid, dcol_acc, dv);

    for (int q0 = row_begin; q0 < row_end; q0 += TQF) {
      cp_async_wait_all();
      __syncthreads();  // the tile and its rows have landed; Ps's readers are done
      bwd_tile_dv<T>(Us, Vs, Ps, lse_s, g_s, idq_s, pos_s, q0, row_end, k0, bk, corr, kid,
                     dcol_acc, dv);
      __syncthreads();  // everyone is done with Us and the rows: the next tile's copy
      if (q0 + TQF < row_end) stage_query_tile(q0 + TQF);
      cp_async_commit();

      // dU_ij[r][k] = sum_c P[r][c] V_j[c][k]
      float du[T::U_RM][4 * T::U_FN];
#pragma unroll
      for (int i = 0; i < T::U_RM; ++i)
#pragma unroll
        for (int b = 0; b < 4 * T::U_FN; ++b) du[i][b] = 0.f;
#pragma unroll 1
      for (int c = 0; c < KC; c += 4) {
        float4 p[T::U_RM];
#pragma unroll
        for (int i = 0; i < T::U_RM; ++i) p[i] = ld4(Ps + (ur + T::U_RG * i) * LDP + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 x[T::U_FN];
#pragma unroll
          for (int t = 0; t < T::U_FN; ++t)
            x[t] = ld4(Vs + (c + e) * LD + 4 * (uf + T::U_FG * t));
#pragma unroll
          for (int i = 0; i < T::U_RM; ++i)
#pragma unroll
            for (int b = 0; b < 4 * T::U_FN; ++b)
              du[i][b] = fmaf(comp(p[i], e), comp(x[b / 4], b % 4), du[i][b]);
        }
      }
#pragma unroll
      for (int i = 0; i < T::U_RM; ++i) {
        const int r = q0 + ur + T::U_RG * i;
        if (r >= row_end) continue;
        float* row = du_out + static_cast<long long>(r) * d;
#pragma unroll
        for (int t = 0; t < T::U_FN; ++t) {
          const int k = 4 * (uf + T::U_FG * t);
          if (k >= d) continue;
          if (vec) {  // d % 4 == 0: the row's 16-byte chunk
            float4* out = reinterpret_cast<float4*>(row + k);
            float4 x = make_float4(du[i][4 * t], du[i][4 * t + 1], du[i][4 * t + 2],
                                   du[i][4 * t + 3]);
            if (!first) {
              const float4 o = *out;
              x = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
            }
            *out = x;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k + e < d) row[k + e] = first ? du[i][4 * t + e] : row[k + e] + du[i][4 * t + e];
          }
        }
      }
    }
    cp_async_wait_all();  // no copy may outlive the tile
    store_dv_dcol<T>(Ps, dcol_acc, dv, k0, bk, d, vec, blockIdx.y, dv_part, dcol_part);
  }
}

// ---- row 4 in fp32: the forward on the FMA units ---------------------------

// The tiling of row 4 of fp32 operands at padded width DP: blocks of TQF
// query rows sweeping candidate tiles of KT (128 and 128; 64 and 64 at DP =
// 256, as row 5), S on 8 x 8 register tiles (4 x 4 at DP = 256).
template <int DP>
struct Fp32Fwd {
  static constexpr int TQF = DP < 256 ? 128 : 64;
  static constexpr int KT = TQF;
  static constexpr int LD = DP + 4;
  static constexpr int S_RM = TQF / 16, S_RN = KT / 16;
  static_assert(TQF <= THREADS && KT <= THREADS, "row staging");
  static_assert(3 * 16 * TQF <= 2 * KT * LD, "the final fold reuses the candidate tiles");
  static constexpr size_t smem() {
    return sizeof(float) * (TQF + 2 * KT) * LD + (TQF + 2 * KT) * 2 * sizeof(int);
  }
};

// Row 4 of fp32 operands on the FMA units (_fwd_kernel). Grid (query
// blocks, parts): block (x, y) holds its TQF query rows in shared memory
// and sweeps candidate tiles [y * tiles_per_part, (y + 1) *
// tiles_per_part), each staged with its colcorr and ids by cp.async into
// one of two buffers while the other computes. Per tile, 256 threads:
//   S = U V_j^T from 128-bit loads, as row 5;
//   the masked, corrected logits in registers (-inf past Bk: they count
//   for nothing), the positive logit taken where the row's positive column
//   lands;
//   each thread's running max and sum-exp over its own columns of each of
//   its rows (m from -1e9): one rescale per row and tile by the thread's
//   tile max, one exp per logit.
// A row's 16 columns of threads lie on two warps, so after the sweep they
// fold through shared memory, in a fixed order, as the combine kernel
// folds parts: M = max m, L = sum l exp(m - M) (a thread that saw no valid
// column holds m = -1e9, l = 0 and adds 0), the positive logit summed.
// One part writes lse = M + log(max(L, 1e-30)) and the positive logit;
// more parts write (M, L, positive logit) into part [3][parts][Bq], which
// flash_ce_fwd_combine_kernel folds in part order. No atomics: two calls
// give the same bits.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_ce_fwd_kernel(
    const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ colcorr,
    const int* __restrict__ ids_q, const int* __restrict__ ids_k, const int* __restrict__ pos,
    int bq, int bk, int d, int vec, int tiles_per_part, float* __restrict__ lse_out,
    float* __restrict__ pos_out, float* __restrict__ part) {
  using T = Fp32Fwd<DP>;
  constexpr int TQF = T::TQF, KT = T::KT, LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Us = reinterpret_cast<float*>(smem_raw);    // [TQF][LD] the block's queries
  float* Vs = Us + TQF * LD;                          // [2][KT][LD] candidate tiles
  float* cs = Vs + 2 * KT * LD;                       // [2][KT] colcorr of the tiles
  int* ks = reinterpret_cast<int*>(cs + 2 * KT);     // [2][KT] ids_k of the tiles
  int* idq_s = ks + 2 * KT;                           // [TQF]
  int* pos_s = idq_s + TQF;                           // [TQF]

  const int tid = threadIdx.x;
  const int sc = grid_col<16>(tid), sr = grid_row<16>(tid);
  const int q0 = blockIdx.x * TQF;
  const int n_kt = (bk + KT - 1) / KT;
  const int kt_begin = blockIdx.y * tiles_per_part;
  const int kt_end = min(n_kt, kt_begin + tiles_per_part);

  auto stage_tile = [&](int buf, int kt) {
    stage_candidates<DP, KT, LD>(Vs, cs, ks, buf, kt, v, colcorr, ids_k, bk, d, vec != 0);
  };

  stage_rows_f32<DP, THREADS>(Us, LD, u, q0, bq, TQF, d, vec != 0);
  if (tid < TQF) {
    const int r = q0 + tid;
    idq_s[tid] = r < bq ? ids_q[r] : 0;
    pos_s[tid] = r < bq ? pos[r] : -1;
  }
  if (kt_begin < kt_end) stage_tile(0, kt_begin);
  cp_async_commit();

  float m[T::S_RM], l[T::S_RM], ps[T::S_RM];
#pragma unroll
  for (int i = 0; i < T::S_RM; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
    ps[i] = 0.f;
  }

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int buf = it & 1, k0 = kt * KT;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; everyone is done with the other buffer
    if (kt + 1 < kt_end) stage_tile(buf ^ 1, kt + 1);
    cp_async_commit();
    const float* Vb = Vs + buf * KT * LD;
    const float* cb = cs + buf * KT;
    const int* kb = ks + buf * KT;

    float s[T::S_RM][T::S_RN];
    s_product<DP, LD, T::S_RM, T::S_RN>(Us, Vb, sr, sc, s);

#pragma unroll
    for (int i = 0; i < T::S_RM; ++i) {
      const int rl = sr + 16 * i;
      const int idq_r = idq_s[rl], pos_r = pos_s[rl];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < T::S_RN; ++j) {
        const int cl = sc + 16 * j, c = k0 + cl;
        float x = -CUDART_INF_F;
        if (c < bk) {
          x = masked_logit(s[i][j], cb[cl], idq_r, kb[cl], c, pos_r);
          if (c == pos_r) ps[i] += x;
          tmax = fmaxf(tmax, x);
        }
        s[i][j] = x;
      }
      const float m_new = fmaxf(m[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::S_RN; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  cp_async_wait_all();  // no copy may outlive the block
  __syncthreads();      // everyone is done with the candidate tiles

  // the 16 threads of each row, folded in column order
  float* red = Vs;  // [3][TQF][16]: m, l, positive logit
#pragma unroll
  for (int i = 0; i < T::S_RM; ++i) {
    const int at = (sr + 16 * i) * 16 + sc;
    red[at] = m[i];
    red[TQF * 16 + at] = l[i];
    red[2 * TQF * 16 + at] = ps[i];
  }
  __syncthreads();
  const int r = q0 + tid;
  if (tid >= TQF || r >= bq) return;
  const float* rm = red + tid * 16;
  const float* rl = rm + TQF * 16;
  const float* rp = rl + TQF * 16;
  float mx = rm[0];
  for (int t = 1; t < 16; ++t) mx = fmaxf(mx, rm[t]);
  float sum = 0.f, pl = 0.f;
  for (int t = 0; t < 16; ++t) {
    sum += rl[t] * expf(rm[t] - mx);
    pl += rp[t];
  }
  if (gridDim.y == 1) {
    lse_out[r] = mx + logf(fmaxf(sum, 1e-30f));
    pos_out[r] = pl;
  } else {
    const long long n = static_cast<long long>(gridDim.y) * bq;
    const long long at = static_cast<long long>(blockIdx.y) * bq + r;
    part[at] = mx;
    part[n + at] = sum;
    part[2 * n + at] = pl;
  }
}

// ---- rows 4, 6 and 7 in bf16: wgmma fed by TMA, warp-specialised ----------

constexpr int WG_OWN = 128;          // rows of a block's own axis: two consumer warpgroups of 64
constexpr int WG_TILE = 128;         // rows of a tile of the swept axis
constexpr int WG_THREADS = 384;      // the producer warpgroup, then the two consumers
constexpr int WG_MMA_THREADS = 256;  // the consumers, who take turns at the tensor cores

// The shared memory of rows 4, 6 and 7 at padded width DP: the block's own
// tile (WG_OWN rows: candidates for row 7, query rows for rows 4 and 6),
// then a ring of STAGES tiles of the swept axis (WG_TILE rows) with their
// rows' inputs (SIDE bytes a row: lse, g, id and positive of row 7's query
// rows; colcorr and id of rows 4 and 6's candidates), then the ring's
// barriers. Both
// tiles are 64-column chunks of 128-byte rows (hopper.cuh); DP = 32 is
// staged as 64 columns, the upper 32 zero. The ring holds up to 4 tiles in
// BUDGET bytes (200 KB: 2 at DP = 256).
template <int DP, int SIDE, int BUDGET = 200 * 1024>
struct WgTc {
  static constexpr int W = DP < 64 ? 64 : DP;       // staged width
  static constexpr int CHUNKS = W / 64;
  // output columns a block of rows 6 and 7 (blockIdx.z past 128); row 4 has none
  [[maybe_unused]] static constexpr int DN = W < 128 ? W : 128;
  static constexpr int OWN_CHUNK = WG_OWN * 128;    // bytes of one 64-column chunk of the own tile
  static constexpr int TILE_CHUNK = WG_TILE * 128;  // and of a swept tile
  static constexpr int OWN_BYTES = CHUNKS * OWN_CHUNK;
  static constexpr int TILE_BYTES = CHUNKS * TILE_CHUNK;
  static constexpr int SIDE_ROW = SIDE;
  static constexpr int SIDE_BYTES = WG_TILE * SIDE;
  static constexpr int FIT = (BUDGET - OWN_BYTES) / (TILE_BYTES + SIDE_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "a ring of two tiles at least");
  static constexpr size_t smem() {
    return 1024 + OWN_BYTES + STAGES * (TILE_BYTES + SIDE_BYTES) +
           (2 * STAGES + 1) * sizeof(uint64_t);
  }
};

// WgTc's pieces in the block's dynamic shared memory, the tiles on 1024
// bytes (the swizzle's period)
struct WgRing {
  unsigned char* own;    // [OWN_BYTES]
  unsigned char* tiles;  // [STAGES][TILE_BYTES]
  unsigned char* side;   // [STAGES][SIDE_BYTES]
  uint64_t* full;        // [STAGES] a tile and its rows' inputs have landed
  uint64_t* empty;       // [STAGES] both consumers have read the tile
  uint64_t* own_full;    // the own tile has landed
};

// the ring of a block of rows 4, 6 and 7, its barriers initialised by thread 0
// (a full barrier takes the producer's arrival and its bytes, an empty one an
// arrival from each consumer warp) before any thread goes on
template <class T>
__device__ __forceinline__ WgRing wg_setup(unsigned char* smem_raw) {
  WgRing r;
  r.own = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  r.tiles = r.own + T::OWN_BYTES;
  r.side = r.tiles + T::STAGES * T::TILE_BYTES;
  r.full = reinterpret_cast<uint64_t*>(r.side + T::STAGES * T::SIDE_BYTES);
  r.empty = r.full + T::STAGES;
  r.own_full = r.empty + T::STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(r.full + st, 1);
      mbar_init(r.empty + st, WG_MMA_THREADS / 32);
    }
    mbar_init(r.own_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// The producer warpgroup (0): one thread loads the block's own tile (rows
// own0 + [0, WG_OWN) of own_map) once and keeps n_tiles swept tiles (rows
// tile0 + WG_TILE i of tile_map) in flight through the ring, each by TMA
// (128-byte swizzle, zero past the tensor's edges) with its rows' inputs by
// a bulk copy from `side` (SIDE_ROW bytes a row, tile0 on), both completing
// on the stage's full barrier; a stage is loaded again once both consumers
// have freed it.
template <class T>
__device__ __forceinline__ void wg_produce(const WgRing& r, const CUtensorMap* own_map, int own0,
                                           const CUtensorMap* tile_map, int tile0,
                                           const unsigned char* side, int n_tiles) {
  if (threadIdx.x != 0 || n_tiles == 0) return;
  mbar_arrive_expect_tx(r.own_full, T::OWN_BYTES);
  for (int c = 0; c < T::CHUNKS; ++c)
    tma_load_2d(r.own + c * T::OWN_CHUNK, own_map, 64 * c, own0, r.own_full);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % T::STAGES, row0 = tile0 + it * WG_TILE;
    mbar_wait(r.empty + st, ((it / T::STAGES) & 1) ^ 1);  // the first round passes at once
    mbar_arrive_expect_tx(r.full + st, T::TILE_BYTES + T::SIDE_BYTES);
    for (int c = 0; c < T::CHUNKS; ++c)
      tma_load_2d(r.tiles + st * T::TILE_BYTES + c * T::TILE_CHUNK, tile_map, 64 * c, row0,
                  r.full + st);
    bulk_load(r.side + st * T::SIDE_BYTES, side + static_cast<long long>(row0) * T::SIDE_ROW,
              T::SIDE_BYTES, r.full + st);
  }
}

// The consumer warpgroups' (1 and 2) sweep over the block's n_tiles swept
// tiles, P of a tile in KT k-steps of A fragments. Per tile i, its logits'
// product (start_s(st)) and the second product of tile i - 1
// (start_x(pa, st)) are started together and tile i's P is built under
// them (probs(st, i, pa); two P buffers, pa0 and pa1), so the exps of one
// tile run under the other's products; the two consumers take turns to
// start products (named barriers 1 and 2, FlashAttention-3's ping-pong),
// so one's exps run under the other's products. A consumer frees a stage
// (empty barrier, one arrival per warp) once its second product has read
// it. keep_s() and keep_x(pa) pin the registers the products write and
// read at each wait.
template <class T, int KT, class S, class X, class P, class KS, class KX>
__device__ __forceinline__ void wg_consume(const WgRing& r, int n_tiles,
                                           uint32_t (&pa0)[KT][4], uint32_t (&pa1)[KT][4],
                                           S start_s, X start_x, P probs, KS keep_s, KX keep_x) {
  if (n_tiles == 0) return;
  const int cw = threadIdx.x / 128 - 1, lane = threadIdx.x & 31;
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + st);
  };
  // the consumers' turns at starting products: WG 0, WG 1, WG 0, ...
  auto turn = [&] { named_sync(1 + cw, WG_MMA_THREADS); };
  auto pass = [&](bool last) {  // WG 1's last pass would have no turn to open
    if (!(last && cw == 1)) named_arrive(2 - cw, WG_MMA_THREADS);
  };
  // tile `it` >= 1: its logits with the second product of tile it - 1 (P in prev)
  auto step = [&](int it, uint32_t(&prev)[KT][4], uint32_t(&next)[KT][4]) {
    const int st = it % T::STAGES, before = (it - 1) % T::STAGES;
    mbar_wait(r.full + st, (it / T::STAGES) & 1);
    turn();
    start_s(st);
    start_x(prev, before);
    pass(false);
    wgmma_wait<1>();
    keep_s();
    probs(st, it, next);
    wgmma_wait<0>();
    keep_x(prev);
    release(before);
  };

  if (cw == 1) named_arrive(1, WG_MMA_THREADS);  // WG 0 goes first
  mbar_wait(r.own_full, 0);
  mbar_wait(r.full, 0);
  turn();
  start_s(0);
  pass(false);
  wgmma_wait<0>();
  keep_s();
  probs(0, 0, pa0);
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {
    step(it, pa0, pa1);
    step(it + 1, pa1, pa0);
  }
  const int last = (n_tiles - 1) % T::STAGES;
  if (it < n_tiles) {  // one tile more: its logits, then the last two second products
    mbar_wait(r.full + last, (it / T::STAGES) & 1);
    turn();
    start_s(last);
    start_x(pa0, (it - 1) % T::STAGES);
    wgmma_wait<1>();
    keep_s();
    probs(last, it, pa1);
    start_x(pa1, last);
  } else {
    turn();
    start_x(pa0, last);
  }
  pass(true);
  wgmma_wait<0>();
  keep_x(pa0);
  keep_x(pa1);
}

// Row 7 of bf16 operands (_bwd_dv_kernel): warp-specialised, wgmma fed by
// TMA. Grid (candidate blocks, parts, W / DN): block (x, y, z) owns the
// WG_OWN candidates of block x, sweeps the query tiles [y *
// q_tiles_per_part, (y + 1) * q_tiles_per_part) and writes output columns
// [z * DN, (z + 1) * DN) of their dV into dv_part[y] ([parts, Bk, D]) and
// (z == 0) their dcol into dcol_part[y] ([parts, Bk]); the wrapper sums the
// parts in a fixed order, or passes dV and dcol themselves when there is
// one part.
//   Warpgroup 0 is the producer (wg_produce): the candidate tile V once,
// the query tiles through the ring with their rows' (lse, g, id, positive)
// from `rows` (flash_ce_dv_rows_kernel). Warpgroups 1 and 2 own 64
// candidates each; per query tile i of WG_TILE rows (wg_consume):
//   S^T = V_w U_i^T [64 x WG_TILE] on wgmma, both operands K-major in
//   shared memory, fp32 sums;
//   P^T = bf16(exp(S - lse) g) in registers from masked_logit, packed
//   straight into the A fragments of the next product; the fp32 p*g into
//   the thread's dcol sums;
//   dV_w += P^T U_i [64 x DN] on wgmma, A from registers, U_i read MN-major
//   from the same shared memory.
// setmaxnreg gives the consumers the producer's registers. dV and dcol stay
// in fp32 registers over the sweep and are written once, dcol summed over
// the quad's lanes in a fixed order. No atomics: two calls give the same
// bits.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_ce_bwd_dv_wgmma_kernel(
    const __grid_constant__ CUtensorMap u_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ colcorr, const int* __restrict__ ids_k,
    const float4* __restrict__ rows, int bq, int bk, int d, int q_tiles_per_part,
    float* __restrict__ dv_part, float* __restrict__ dcol_part) {
  using T = WgTc<DP, sizeof(float4)>;
  constexpr int TQ = WG_TILE;
  constexpr int KT = TQ / 16;  // k-steps of the dV product
  extern __shared__ unsigned char smem_raw[];
  const WgRing r = wg_setup<T>(smem_raw);
  const int k0 = blockIdx.x * WG_OWN;
  const int n_qt = (bq + TQ - 1) / TQ;
  const int qt_begin = blockIdx.y * q_tiles_per_part;
  const int n_tiles = max(0, min(n_qt, qt_begin + q_tiles_per_part) - qt_begin);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // ---- the producer
    setmaxnreg_dec<24>();
    wg_produce<T>(r, &v_map, k0, &u_map, qt_begin * TQ,
                  reinterpret_cast<const unsigned char*>(rows), n_tiles);
    return;
  }

  // ---- the consumers
  setmaxnreg_inc<240>();
  const int cw = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, gq = lane >> 2, t4 = lane & 3;
  const int dchunk = blockIdx.z * (T::DN / 64);  // first staged chunk of this block's dV
  const float4* rows_s = reinterpret_cast<const float4*>(r.side);  // [STAGES][TQ]
  float corr[2], dcol[2] = {0.f, 0.f};
  int kid[2], kcol[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = k0 + 64 * cw + 16 * (ct >> 5) + gq + 8 * h;
    kcol[h] = c;
    corr[h] = c < bk ? colcorr[c] : 0.f;
    kid[h] = c < bk ? ids_k[c] : 0;
  }
  float s[TQ / 2], dv[T::DN / 2];
#pragma unroll
  for (int i = 0; i < TQ / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::DN / 2; ++i) dv[i] = 0.f;
  uint32_t pa0[KT][4], pa1[KT][4];  // P^T of two tiles: one being built, one being read

  // S^T of the tile in stage st into s
  auto start_s = [&](int st) {
    wgmma_fence();
    const unsigned char* vb = r.own + cw * 64 * 128;
    const unsigned char* ub = r.tiles + st * T::TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::W / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<TQ>(s, sw128_desc(vb + c * T::OWN_CHUNK + off, 16, 1024),
                   sw128_desc(ub + c * T::TILE_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dV += P^T U of the tile in stage st
  auto start_dv = [&](uint32_t(&pa)[KT][4], int st) {
    wgmma_fence();
    const unsigned char* ub = r.tiles + st * T::TILE_BYTES + dchunk * T::TILE_CHUNK;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wgmma_rs<T::DN>(dv, pa[kk], sw128_desc(ub + kk * 16 * 128, T::TILE_CHUNK, 1024));
    wgmma_commit();
  };
  // P^T of the tile in stage st from s: A fragments into pa, p*g into dcol
  auto probs = [&](int st, int, uint32_t(&pa)[KT][4]) {
    const float4* rb = rows_s + st * TQ;
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      float pf[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 q = rb[8 * j + 2 * t4 + e];  // lse, g, id, positive
        const int idq = __float_as_int(q.z), pq = __float_as_int(q.w);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = masked_logit(s[4 * j + 2 * h + e], corr[h], idq, kid[h], kcol[h], pq);
          const float pg = expf(x - q.x) * q.y;
          dcol[h] += pg;
          pf[h][e] = pg;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(pf[h][0], pf[h][1]);
    }
  };
  wg_consume<T, KT>(r, n_tiles, pa0, pa1, start_s, start_dv, probs, [&] { keep(s); },
                    [&](uint32_t(&pa)[KT][4]) {
                      keep(dv);
                      keep(pa);
                    });

  // dcol: the four lanes of a quad hold the same two candidates
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = dcol[h];
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    if (blockIdx.z == 0 && t4 == 0 && kcol[h] < bk)
      dcol_part[static_cast<long long>(blockIdx.y) * bk + kcol[h]] = x;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kcol[h] >= bk) continue;
    float* out = dv_part + (static_cast<long long>(blockIdx.y) * bk + kcol[h]) * d;
#pragma unroll
    for (int j = 0; j < T::DN / 8; ++j) {
      const int k = dchunk * 64 + 8 * j + 2 * t4;  // d % 8 == 0: k < d means k + 1 < d
      if (k < d) *reinterpret_cast<float2*>(out + k) = make_float2(dv[4 * j + 2 * h],
                                                                   dv[4 * j + 2 * h + 1]);
    }
  }
}

// Row 7's per-row inputs, in the order its tiles read them: rows[r] = (lse,
// g, ids_q, pos) of query row r < bq, and (+inf, 0, 0, -1) for the rows of
// the last tile past bq, whose p*g is then 0
__global__ void flash_ce_dv_rows_kernel(const float* __restrict__ lse,
                                        const float* __restrict__ g,
                                        const int* __restrict__ ids_q,
                                        const int* __restrict__ pos, int bq, int n_rows,
                                        float4* __restrict__ rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  rows[r] = r < bq ? make_float4(lse[r], g[r], __int_as_float(ids_q[r]), __int_as_float(pos[r]))
                   : make_float4(CUDART_INF_F, 0.f, 0.f, __int_as_float(-1));
}

// Row 6 of bf16 operands (_bwd_du_kernel): row 7's pipeline with the axes
// swapped, FlashAttention-3's forward without its online rescale (lse is
// known).
//   Bound: 4 Bq Bk D products (S = U V^T and P V), 17.79 ms at 131,072 x
// 262,144, D = 128 on the tensor cores at 989 TFLOP/s (0.0347 ms at
// 8,192^2), beside Bq Bk exps. On mma.sync (64-row blocks of four warps,
// 64-candidate tiles staged by the threads' own cp.async, the exps between
// the products) it took 100.3-100.6 of the giant step's 215 device ms, at
// 17.7% of that bound. Here wgmma runs both products, TMA the copies, and
// the exps of one tile run under the products of the next and under the
// other consumer's: 34.4-35.2 device ms at 131,072 x 262,144 (499-512
// TFLOP/s, 50-52% of the bound; 33.5 a step inside the giant step), 0.073
// at 8,192^2 (NVIDIA H100 80GB HBM3, 700 W). Like row 7 it is now bound by
// the exps and masks beside the products.
//   Grid (query blocks, parts, W / DN): block (x, y, z) owns the WG_OWN
// query rows of block x, sweeps candidate tiles [y * tiles_per_part, (y +
// 1) * tiles_per_part) and writes output columns [z * DN, (z + 1) * DN) of
// their dU into du_part[y] ([parts, Bq, D]); the wrapper sums the parts in
// a fixed order, or passes dU itself when there is one part.
//   Warpgroup 0 is the producer (wg_produce): the query tile U once, the
// candidate tiles through the ring with their columns' (colcorr, id) from
// `cols` (flash_ce_du_cols_kernel: colcorr -inf past Bk, where V's rows are
// zero, so p*g is 0 there). Warpgroups 1 and 2 own 64 query rows each,
// whose lse, g, id and positive each thread reads once; per candidate tile
// j of WG_TILE columns (wg_consume):
//   S = U_w V_j^T [64 x WG_TILE] on wgmma, both operands K-major in shared
//   memory, fp32 sums;
//   P = bf16(exp(S - lse) g) in registers from masked_logit, packed
//   straight into the A fragments of the next product;
//   dU_w += P V_j [64 x DN] on wgmma, A from registers, V_j read MN-major
//   from the same shared memory.
// setmaxnreg gives the consumers the producer's registers. dU stays in fp32
// registers over the sweep and is written once. No atomics: two calls give
// the same bits.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_ce_bwd_du_wgmma_kernel(
    const __grid_constant__ CUtensorMap u_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, const float* __restrict__ g, const int* __restrict__ ids_q,
    const int* __restrict__ pos, const float2* __restrict__ cols, int bq, int bk, int d,
    int tiles_per_part, float* __restrict__ du_part) {
  using T = WgTc<DP, sizeof(float2)>;
  constexpr int TK = WG_TILE;
  constexpr int KT = TK / 16;  // k-steps of the dU product
  extern __shared__ unsigned char smem_raw[];
  const WgRing r = wg_setup<T>(smem_raw);
  const int q0 = blockIdx.x * WG_OWN;
  const int n_kt = (bk + TK - 1) / TK;
  const int kt_begin = blockIdx.y * tiles_per_part;
  const int n_tiles = max(0, min(n_kt, kt_begin + tiles_per_part) - kt_begin);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // ---- the producer
    setmaxnreg_dec<24>();
    wg_produce<T>(r, &u_map, q0, &v_map, kt_begin * TK,
                  reinterpret_cast<const unsigned char*>(cols), n_tiles);
    return;
  }

  // ---- the consumers
  setmaxnreg_inc<240>();
  const int cw = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, gq = lane >> 2, t4 = lane & 3;
  const int dchunk = blockIdx.z * (T::DN / 64);  // first staged chunk of this block's dU
  float lse_r[2], g_r[2];
  int idq_r[2], pos_r[2], row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows past bq: p*g = 0 (and never written)
    const int q = q0 + 64 * cw + 16 * (ct >> 5) + gq + 8 * h;
    const bool ok = q < bq;
    row[h] = q;
    lse_r[h] = ok ? lse[q] : CUDART_INF_F;
    g_r[h] = ok ? g[q] : 0.f;
    idq_r[h] = ok ? ids_q[q] : 0;
    pos_r[h] = ok ? pos[q] : -1;
  }
  float s[TK / 2], du[T::DN / 2];
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::DN / 2; ++i) du[i] = 0.f;
  uint32_t pa0[KT][4], pa1[KT][4];  // P of two tiles: one being built, one being read

  // S of the tile in stage st into s
  auto start_s = [&](int st) {
    wgmma_fence();
    const unsigned char* ub = r.own + cw * 64 * 128;
    const unsigned char* vb = r.tiles + st * T::TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::W / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<TK>(s, sw128_desc(ub + c * T::OWN_CHUNK + off, 16, 1024),
                   sw128_desc(vb + c * T::TILE_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dU += P V of the tile in stage st
  auto start_du = [&](uint32_t(&pa)[KT][4], int st) {
    wgmma_fence();
    const unsigned char* vb = r.tiles + st * T::TILE_BYTES + dchunk * T::TILE_CHUNK;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wgmma_rs<T::DN>(du, pa[kk], sw128_desc(vb + kk * 16 * 128, T::TILE_CHUNK, 1024));
    wgmma_commit();
  };
  // P of tile `it` (in stage st) from s: A fragments into pa
  auto probs = [&](int st, int it, uint32_t(&pa)[KT][4]) {
    // the lane's columns 8j + 2 t4 + e, e = 0, 1: (colcorr, id) each, one float4
    const float4* cb = reinterpret_cast<const float4*>(r.side + st * T::SIDE_BYTES) + t4;
    const int c0 = (kt_begin + it) * TK + 2 * t4;         // the lane's first column
    const int rel[2] = {pos_r[0] - c0, pos_r[1] - c0};  // the positives, counted from c0
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float4 cc = cb[4 * j];
      float pf[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float corr = e ? cc.z : cc.x;
        const int kid = __float_as_int(e ? cc.w : cc.y);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x =
              masked_logit(s[4 * j + 2 * h + e], corr, idq_r[h], kid, 8 * j + e, rel[h]);
          pf[h][e] = expf(x - lse_r[h]) * g_r[h];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) pa[j >> 1][(j & 1) * 2 + h] = pack_bf16(pf[h][0], pf[h][1]);
    }
  };
  wg_consume<T, KT>(r, n_tiles, pa0, pa1, start_s, start_du, probs, [&] { keep(s); },
                    [&](uint32_t(&pa)[KT][4]) {
                      keep(du);
                      keep(pa);
                    });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= bq) continue;
    float* out = du_part + (static_cast<long long>(blockIdx.y) * bq + row[h]) * d;
#pragma unroll
    for (int j = 0; j < T::DN / 8; ++j) {
      const int k = dchunk * 64 + 8 * j + 2 * t4;  // d % 8 == 0: k < d means k + 1 < d
      if (k < d) *reinterpret_cast<float2*>(out + k) = make_float2(du[4 * j + 2 * h],
                                                                   du[4 * j + 2 * h + 1]);
    }
  }
}

// Rows 4 and 6's per-column inputs, in the order their tiles read them:
// cols[c] = (colcorr, ids_k) of candidate c < bk, and (-inf, 0) for the
// columns of the last tile past bk, whose logit is then -inf (or -1e9 where
// the id hits: row 6's p*g is 0 either way, row 4 sets them to -inf)
__global__ void flash_ce_du_cols_kernel(const float* __restrict__ colcorr,
                                        const int* __restrict__ ids_k, int bk, int n_cols,
                                        float2* __restrict__ cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  cols[c] = c < bk ? make_float2(colcorr[c], __int_as_float(ids_k[c]))
                   : make_float2(-CUDART_INF_F, __int_as_float(0));
}

// ---- row 4 in bf16: the forward on wgmma fed by TMA -----------------------

// The tiling of row 4 at padded width DP: the blocks an SM holds at once
// (two where their shared memory fits twice, so that each SM sub-partition
// runs four consumer warps: the exps and masks, not the products, bound the
// kernel, and two warps a sub-partition leave its issue slots idle half the
// time), their ring (WgTc within half the SM's shared memory) and the
// consumers' registers (setmaxnreg: what the producer's 24 leave of the
// block's share).
template <int DP>
struct FwdWg {
  static constexpr int BLOCKS = DP < 256 ? 2 : 1;
  using T = WgTc<DP, sizeof(float2), BLOCKS == 2 ? 100 * 1024 : 200 * 1024>;
  static constexpr int REGS = BLOCKS == 2 ? 104 : 240;
  static_assert(BLOCKS * (T::smem() + 1024) <= 228 * 1024, "the blocks fit an SM");
};

// The consumer warpgroups' (1 and 2) sweep of row 4 over the block's
// n_tiles swept tiles: per tile, two products of half its columns each
// (start(s, st, half): S of those WG_TILE / 2 columns into s), each read
// (update(s, st, it, half)) once it has landed. A consumer has one product
// in flight at a time; the two consumers take turns to start them (named
// barriers 1 and 2, as in wg_consume), so one's masks and exps run under
// the other's product, and the SM's other block runs between both. A
// consumer frees a stage (empty barrier, one arrival per warp) once it has
// read the tile's logits and its columns' inputs.
template <class T, int N, class S, class U>
__device__ __forceinline__ void wg_consume_one(const WgRing& r, int n_tiles, float (&s)[N],
                                               S start, U update) {
  if (n_tiles == 0) return;
  const int cw = threadIdx.x / 128 - 1, lane = threadIdx.x & 31;
  // the consumers' turns at starting products: WG 0, WG 1, WG 0, ...
  auto turn = [&] { named_sync(1 + cw, WG_MMA_THREADS); };
  auto pass = [&](bool last) {  // WG 1's last pass would have no turn to open
    if (!(last && cw == 1)) named_arrive(2 - cw, WG_MMA_THREADS);
  };

  if (cw == 1) named_arrive(1, WG_MMA_THREADS);  // WG 0 goes first
  mbar_wait(r.own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % T::STAGES;
    mbar_wait(r.full + st, (it / T::STAGES) & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      turn();
      start(s, st, half);
      pass(half == 1 && it + 1 == n_tiles);
      wgmma_wait<0>();
      keep(s);
      update(s, st, it, half);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + st);
  }
}

// Row 4 of bf16 operands (_fwd_kernel): rows 6 and 7's pipeline with one
// product, FlashAttention-3's forward without its second product.
//   Bound: 2 Bq Bk D products, 8.89 ms at 131,072 x 262,144, D = 128 on the
// tensor cores at 989 TFLOP/s (0.0174 ms at 8,192^2), beside Bq Bk exps. On
// mma.sync (64-row blocks of four warps, 64-candidate tiles staged by the
// threads' own cp.async) it took 56.6-56.9 device ms there alone and 60.2 a
// step inside the giant step, at 14.7-14.9% of that bound. Here the masks
// and exps set the pace: ~14 instructions a logit (expf alone 8).
//   Grid (query blocks, parts): block (x, y) owns the WG_OWN query rows of
// block x and sweeps candidate tiles [y * tiles_per_part, (y + 1) *
// tiles_per_part); FwdWg<DP>::BLOCKS blocks share an SM. The logits need all
// of D, so DP = 256 takes no column slices.
//   Warpgroup 0 is the producer (wg_produce): the query tile U once, the
// candidate tiles through the ring with their columns' (colcorr, id) from
// `cols` (flash_ce_du_cols_kernel, row 6's layout: colcorr -inf past Bk,
// where V's rows are zero). Warpgroups 1 and 2 own 64 query rows each,
// whose id and positive each thread reads once; per half of each candidate
// tile j (wg_consume_one):
//   S = U_w V_j^T [64 x WG_TILE / 2] on wgmma, both operands K-major in
//   shared memory, fp32 sums;
//   the masked, corrected logits in place, from masked_logit (-inf past Bk:
//   they count for nothing), the positive logit taken where the row's
//   positive column lands (only a warp that has a positive in the half
//   tests for it);
//   each lane's running max and sum-exp over its own columns of its two
//   rows (m from -1e9): one rescale per row and half tile, one exp per
//   logit.
// setmaxnreg gives the consumers the producer's registers. At the end the
// four lanes of a quad (one row) combine theirs, two shuffles each. One part
// writes lse = m + log(max(l, 1e-30)) and the positive logit; more parts
// write (m, l, positive logit) into part [3][parts][Bq], which
// flash_ce_fwd_combine_kernel folds in part order. No atomics: two calls
// give the same bits.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS, FwdWg<DP>::BLOCKS) flash_ce_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap u_map, const __grid_constant__ CUtensorMap v_map,
    const int* __restrict__ ids_q, const int* __restrict__ pos, const float2* __restrict__ cols,
    int bq, int bk, int tiles_per_part, float* __restrict__ lse_out, float* __restrict__ pos_out,
    float* __restrict__ part) {
  using T = typename FwdWg<DP>::T;
  constexpr int TK = WG_TILE, TH = WG_TILE / 2;  // a tile's columns and a half's
  extern __shared__ unsigned char smem_raw[];
  const WgRing r = wg_setup<T>(smem_raw);
  const int q0 = blockIdx.x * WG_OWN;
  const int n_kt = (bk + TK - 1) / TK;
  const int kt_begin = blockIdx.y * tiles_per_part;
  const int n_tiles = max(0, min(n_kt, kt_begin + tiles_per_part) - kt_begin);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // ---- the producer
    setmaxnreg_dec<24>();
    wg_produce<T>(r, &u_map, q0, &v_map, kt_begin * TK,
                  reinterpret_cast<const unsigned char*>(cols), n_tiles);
    return;
  }

  // ---- the consumers
  setmaxnreg_inc<FwdWg<DP>::REGS>();
  const int cw = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, gq = lane >> 2, t4 = lane & 3;
  int idq_r[2], pos_r[2];
  float m[2], l[2], ps[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows past bq: never written
    const int q = q0 + 64 * cw + 16 * (ct >> 5) + gq + 8 * h;
    const bool ok = q < bq;
    idq_r[h] = ok ? ids_q[q] : 0;
    pos_r[h] = ok ? pos[q] : -1;
    m[h] = NEG_BIG;
    l[h] = 0.f;
    ps[h] = 0.f;
  }
  float s[TH / 2];
#pragma unroll
  for (int i = 0; i < TH / 2; ++i) s[i] = 0.f;

  // S of half `half` of the tile in stage st into s
  auto start = [&](float(&acc)[TH / 2], int st, int half) {
    wgmma_fence();
    const unsigned char* ub = r.own + cw * 64 * 128;
    const unsigned char* vb = r.tiles + st * T::TILE_BYTES + half * TH * 128;
#pragma unroll
    for (int kk = 0; kk < T::W / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<TH>(acc, sw128_desc(ub + c * T::OWN_CHUNK + off, 16, 1024),
                   sw128_desc(vb + c * T::TILE_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // half `half` of tile `it` (in stage st) from its products: acc[4j + 2h +
  // e] is row h's column TH half + 8j + 2 t4 + e of the tile, overwritten by
  // its masked logit (no product is in flight: see wg_consume_one)
  auto update = [&](float(&acc)[TH / 2], int st, int it, int half) {
    // the lane's columns 8j + 2 t4 + e, e = 0, 1: (colcorr, id) each, one float4
    const float4* cb =
        reinterpret_cast<const float4*>(r.side + st * T::SIDE_BYTES) + 4 * (TH / 8) * half + t4;
    const int k0 = (kt_begin + it) * TK + TH * half;      // the half's first column
    const int c0 = k0 + 2 * t4;                           // the lane's first column
    const int rel[2] = {pos_r[0] - c0, pos_r[1] - c0};  // the positives, counted from c0
    // a row's positive lies in one half tile of its sweep: only a warp that
    // holds one here tests each column against it
    const bool with_pos = __any_sync(FULL, static_cast<unsigned>(pos_r[0] - k0) < TH ||
                                               static_cast<unsigned>(pos_r[1] - k0) < TH);
    float tmax[2][2] = {{-CUDART_INF_F, -CUDART_INF_F}, {-CUDART_INF_F, -CUDART_INF_F}};
    auto logits = [&](auto pos_here) {
#pragma unroll
      for (int j = 0; j < TH / 8; ++j) {
        const float4 cc = cb[4 * j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float corr = e ? cc.z : cc.x;
          const int kid = __float_as_int(e ? cc.w : cc.y);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = acc[4 * j + 2 * h + e];
            if constexpr (decltype(pos_here)::value) {
              x = masked_logit(x, corr, idq_r[h], kid, 8 * j + e, rel[h]);
              if (8 * j + e == rel[h]) ps[h] = x;
            } else {  // no positive here: col != pos everywhere
              x = masked_logit(x, corr, idq_r[h], kid, 0, -1);
            }
            tmax[h][j & 1] = fmaxf(tmax[h][j & 1], x);
          }
        }
      }
    };
    if (with_pos)
      logits(std::true_type{});
    else
      logits(std::false_type{});
    // the columns past bk (8j + e >= lim): -inf, also where their id hits (a
    // -1e9 there would count in a sum-exp whose max is -1e9; in the max it
    // changes nothing, m starting at -1e9)
    if (k0 + TH > bk) {
      const int lim = bk - c0;
#pragma unroll
      for (int j = 0; j < TH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (8 * j + e >= lim) acc[4 * j + 2 * h + e] = -CUDART_INF_F;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], fmaxf(tmax[h][0], tmax[h][1]));
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum[j & 1] += expf(acc[4 * j + 2 * h + e] - m_new);
      l[h] = l[h] * expf(m[h] - m_new) + (sum[0] + sum[1]);
      m[h] = m_new;
    }
  };
  wg_consume_one<T>(r, n_tiles, s, start, update);

  // the quad's four lanes (one row): max, rescaled sum-exp, positive logit
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    float sum = l[h] * expf(m[h] - mx);
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    float p = ps[h];
    p += __shfl_xor_sync(FULL, p, 1);
    p += __shfl_xor_sync(FULL, p, 2);
    const int row = q0 + 64 * cw + 16 * (ct >> 5) + gq + 8 * h;
    if (t4 != 0 || row >= bq) continue;
    if (gridDim.y == 1) {
      lse_out[row] = mx + logf(fmaxf(sum, 1e-30f));
      pos_out[row] = p;
    } else {
      const long long n = static_cast<long long>(gridDim.y) * bq;
      const long long at = static_cast<long long>(blockIdx.y) * bq + row;
      part[at] = mx;
      part[n + at] = sum;
      part[2 * n + at] = p;
    }
  }
}

// lse and the positive logit of each query row from the forward's per-part
// (m, l, positive logit) in part [3][parts][Bq], the parts taken in order:
// M = max m_p, L = sum l_p exp(m_p - M), lse = M + log(max(L, 1e-30)); the
// positive logit is the sum (one part holds the positive column)
__global__ void flash_ce_fwd_combine_kernel(const float* __restrict__ part, int parts, int bq,
                                            float* __restrict__ lse_out,
                                            float* __restrict__ pos_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= bq) return;
  const long long n = static_cast<long long>(parts) * bq;
  float mx = NEG_BIG;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, part[static_cast<long long>(p) * bq + r]);
  float sum = 0.f, pl = 0.f;
  for (int p = 0; p < parts; ++p) {
    const long long at = static_cast<long long>(p) * bq + r;
    sum += part[n + at] * expf(part[at] - mx);
    pl += part[2 * n + at];
  }
  lse_out[r] = mx + logf(fmaxf(sum, 1e-30f));
  pos_out[r] = pl;
}

// f(std::integral_constant<int, DP>{}) at the padded width DP of d
template <typename F>
int by_width(int d, F&& f) {
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  if (d <= 256) return f(std::integral_constant<int, 256>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

const float* f32(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// u [bq, d], v [bk, d] (bf16 if bf16 != 0, else fp32); colcorr [bk] fp32;
// ids_q [bq], ids_k [bk], pos [bq] int32 (0 <= pos < bk); out lse, pos_out
// [bq] fp32. All contiguous, on the stream's device; 1 <= d <= 256. The
// candidate tiles (128 for bf16 operands, on wgmma; for fp32 operands, on
// the FMA units, 128, or 64 where d > 128) split into parts of
// tiles_per_part; more than one part writes its (m, l, positive logit) into
// part [3, parts, bq] fp32, which the combine kernel, launched here too,
// folds into lse and pos_out. bf16 operands are fed by TMA: they need vec
// (d % 8 == 0, u and v on 16 bytes) and scratch `cols` of ceil(bk / 128) *
// 128 float2 on 16 bytes, which flash_ce_du_cols_kernel, launched here
// first, fills. fp32 operands copy rows 16 bytes at a time where vec (d % 4
// == 0, u and v on 16 bytes), element by element otherwise, and take no
// `cols`. Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_ce_fwd(const void* u, const void* v, const float* colcorr,
                            const int* ids_q, const int* ids_k, const int* pos, int bq,
                            int bk, int d, int bf16, int parts, int tiles_per_part, int vec,
                            float* lse, float* pos_out, float* part, void* cols, void* stream) {
  if (bq <= 0) return 0;
  if (bk <= 0 || d <= 0 || parts <= 0 || tiles_per_part <= 0 ||
      (parts > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (bf16) {
    if (static_cast<long long>(parts) * tiles_per_part * WG_TILE < bk || !vec ||
        cols == nullptr || reinterpret_cast<uintptr_t>(cols) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_cols = (bk + WG_TILE - 1) / WG_TILE * WG_TILE;
    float2* cols2 = static_cast<float2*>(cols);
    flash_ce_du_cols_kernel<<<(n_cols + 255) / 256, 256, 0, s>>>(colcorr, ids_k, bk, n_cols,
                                                                  cols2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    CUtensorMap u_map, v_map;
    if (!rows_map(&u_map, u, bq, d, WG_OWN) || !rows_map(&v_map, v, bk, d, WG_TILE))
      return static_cast<int>(cudaErrorNotSupported);
    err = by_width(d, [&](auto w) {
      constexpr int DP = decltype(w)::value;
      return launch(flash_ce_fwd_wgmma_kernel<DP>, dim3((bq + WG_OWN - 1) / WG_OWN, parts),
                    WG_THREADS, FwdWg<DP>::T::smem(), s, u_map, v_map, ids_q, pos,
                    static_cast<const float2*>(cols2), bq, bk, tiles_per_part, lse, pos_out,
                    part);
    });
  } else {
    err = by_width(d, [&](auto w) {
      constexpr int DP = decltype(w)::value;
      using T = Fp32Fwd<DP>;
      if (static_cast<long long>(parts) * tiles_per_part * T::KT < bk)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(flash_ce_fwd_kernel<DP>, dim3((bq + T::TQF - 1) / T::TQF, parts), THREADS,
                    T::smem(), s, f32(u), f32(v), colcorr, ids_q, ids_k, pos, bq, bk, d, vec,
                    tiles_per_part, lse, pos_out, part);
    });
  }
  if (err != 0 || parts == 1) return err;
  flash_ce_fwd_combine_kernel<<<(bq + 255) / 256, 256, 0, s>>>(part, parts, bq, lse, pos_out);
  return static_cast<int>(cudaGetLastError());
}

// As flash_ce_fwd, plus lse, g [bq] fp32 and the wrapper's plan: the
// fused backward (row 5) of fp32 operands, on the FMA units (bf16 operands
// take rows 6 and 7). Out, all fp32: the dU partials du_part [n_spans, bq,
// d], n_spans = ceil(ceil(bk / tile) / tiles_per_block) with tile 128 (64
// where d > 128), dv_part [parts, bk, d] and dcol_part [parts, bk]; the
// wrapper sums each over its first axis. The kernel sweeps parts >= 1
// query parts of q_tiles_per_part 64-row tiles (vec != 0 when d % 4 == 0
// and u, v start on 16 bytes). Returns the cudaError_t of the launch.
extern "C" int flash_ce_bwd(const void* u, const void* v, const float* colcorr,
                            const int* ids_q, const int* ids_k, const int* pos,
                            const float* lse, const float* g, int bq, int bk, int d,
                            int tiles_per_block, int parts, int q_tiles_per_part, int vec,
                            float* dv_part, float* dcol_part, float* du_part, void* stream) {
  if (bk <= 0) return 0;
  if (bq <= 0 || d <= 0 || tiles_per_block <= 0 || parts <= 0 || q_tiles_per_part <= 0 ||
      static_cast<long long>(parts) * q_tiles_per_part * TQ < bq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpb = tiles_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    constexpr int KC = Fp32Bwd<DP>::KC;
    const int n_tiles = (bk + KC - 1) / KC;
    return launch(flash_ce_bwd_kernel<DP>, dim3((n_tiles + tpb - 1) / tpb, parts), THREADS,
                  Fp32Bwd<DP>::smem(), s, f32(u), f32(v), colcorr, ids_q, ids_k, pos, lse, g,
                  bq, bk, d, vec, tpb, q_tiles_per_part, dv_part, dcol_part, du_part);
  });
}

// As flash_ce_bwd, with row 6's plan, for bf16 operands; out du_part
// [parts, bq, d] fp32, the wrapper summing it over its first axis (dU
// itself when parts == 1). The wgmma kernel (query blocks of 128, candidate
// tiles of 128, split into parts of tiles_per_part) is fed by TMA: it needs
// vec (d % 8 == 0, u and v on 16 bytes) and scratch `cols` of ceil(bk /
// 128) * 128 float2 on 16 bytes, which flash_ce_du_cols_kernel, launched
// here first, fills. Returns the cudaError_t of the launches.
extern "C" int flash_ce_bwd_du(const void* u, const void* v, const float* colcorr,
                               const int* ids_q, const int* ids_k, const int* pos,
                               const float* lse, const float* g, int bq, int bk, int d,
                               int parts, int tiles_per_part, int vec, float* du_part,
                               void* cols, void* stream) {
  if (bq <= 0) return 0;
  if (bk <= 0 || d <= 0 || parts <= 0 || tiles_per_part <= 0 ||
      static_cast<long long>(parts) * tiles_per_part * WG_TILE < bk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vec || cols == nullptr || reinterpret_cast<uintptr_t>(cols) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_cols = (bk + WG_TILE - 1) / WG_TILE * WG_TILE;
  float2* cols2 = static_cast<float2*>(cols);
  flash_ce_du_cols_kernel<<<(n_cols + 255) / 256, 256, 0, s>>>(colcorr, ids_k, bk, n_cols,
                                                                cols2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap u_map, v_map;
  if (!rows_map(&u_map, u, bq, d, WG_OWN) || !rows_map(&v_map, v, bk, d, WG_TILE))
    return static_cast<int>(cudaErrorNotSupported);
  return by_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    using T = WgTc<DP, sizeof(float2)>;
    return launch(flash_ce_bwd_du_wgmma_kernel<DP>,
                  dim3((bq + WG_OWN - 1) / WG_OWN, parts, T::W / T::DN), WG_THREADS, T::smem(),
                  s, u_map, v_map, lse, g, ids_q, pos, static_cast<const float2*>(cols2), bq, bk,
                  d, tiles_per_part, du_part);
  });
}

// As flash_ce_bwd, with row 7's plan, for bf16 operands; out dv_part
// [parts, bk, d] and dcol_part [parts, bk] fp32, the wrapper summing each
// over its first axis (dV and dcol themselves when parts == 1). The wgmma
// kernel (128-candidate blocks, query tiles of 128, split into parts of
// q_tiles_per_part) is fed by TMA: it needs vec (d % 8 == 0, u and v on 16
// bytes) and scratch `rows` of ceil(bq / 128) * 128 float4 on 16 bytes,
// which flash_ce_dv_rows_kernel, launched here first, fills. Returns the
// cudaError_t of the launches.
extern "C" int flash_ce_bwd_dv(const void* u, const void* v, const float* colcorr,
                               const int* ids_q, const int* ids_k, const int* pos,
                               const float* lse, const float* g, int bq, int bk, int d,
                               int parts, int q_tiles_per_part, int vec, float* dv_part,
                               float* dcol_part, void* rows, void* stream) {
  if (bk <= 0) return 0;
  if (bq <= 0 || d <= 0 || parts <= 0 || q_tiles_per_part <= 0 ||
      static_cast<long long>(parts) * q_tiles_per_part * WG_TILE < bq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vec || rows == nullptr || reinterpret_cast<uintptr_t>(rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = (bq + WG_TILE - 1) / WG_TILE * WG_TILE;
  float4* rows4 = static_cast<float4*>(rows);
  flash_ce_dv_rows_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(lse, g, ids_q, pos, bq, n_rows,
                                                                rows4);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap u_map, v_map;
  if (!rows_map(&u_map, u, bq, d, WG_TILE) || !rows_map(&v_map, v, bk, d, WG_OWN))
    return static_cast<int>(cudaErrorNotSupported);
  return by_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    using T = WgTc<DP, sizeof(float4)>;
    return launch(flash_ce_bwd_dv_wgmma_kernel<DP>,
                  dim3((bk + WG_OWN - 1) / WG_OWN, parts, T::W / T::DN), WG_THREADS, T::smem(), s,
                  u_map, v_map, colcorr, ids_k, static_cast<const float4*>(rows4), bq, bk, d,
                  q_tiles_per_part, dv_part, dcol_part);
  });
}
