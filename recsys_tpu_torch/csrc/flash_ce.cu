// Flash in-batch softmax cross-entropy for Hopper (sm_90a): the forward
// pass and the fused backward pass.
//
// Replaces: recsys_tpu/ops/pallas/flash_ce.py::_fwd_kernel (reached
// through _flash_fwd_raw) and ::_bwd_fused_kernel (reached through
// _flash_bwd_fused_raw).
//
// Both kernels work on the corrected, accidental-masked logits
//     s_ij = u_i . v_j + colcorr_j,   s_ij = -1e9 where ids_q[i] == ids_k[j]
//                                      and j != pos[i]
// of Bq query rows u [Bq, D] against Bk candidate rows v [Bk, D] (bf16 or
// fp32), without ever writing the [Bq, Bk] matrix to device memory:
//   * forward: lse_i = log sum_j exp(s_ij) (online max / sum-exp over
//     candidate tiles, m starting at -1e9 and the sum floored at 1e-30
//     before the log, as on the TPU) and the positive logit s_{i,pos_i};
//   * backward: with p = exp(s - lse) and pg = p * g_i, dV = pg^T U,
//     dU = pg V and dcol = column sums of pg (fp32 pg for dcol; pg rounded
//     to the operand type for both products, as the TPU kernel does).
//     The label terms (-g_i v_{pos_i} etc.) are added outside, in PyTorch.
//
// What bounds them on the H100: the TPU kernels are matrix-unit bound
// (2*Bq*Bk*D products forward, 6*Bq*Bk*D backward) plus one exp per logit.
// At Bq = Bk = 8192, D = 128 in bf16 the tensor-core bound is 0.017 ms
// forward and the Bq*Bk exps on the special-function units take about as
// long. This first version does NOT reach it: every product runs on the
// fp32 FMA units (bf16 operands are widened to fp32 in shared memory; a
// product of two bf16 values is exact in fp32, so the sums equal the
// TPU's fp32-accumulated bf16 products up to summation order), with a
// 4 x 4 register tile per thread. It is therefore bound by fp32 issue and
// shared-memory loads, far above the tensor-core bound; wgmma tiles are
// the later speed work (ROADMAP Queue 2). What the design does keep from
// the TPU kernel is the memory side: the logits never leave the chip.
//
// Design, and how it departs from the TPU kernels:
// * Forward: one block owns 64 query rows (held in shared memory for the
//   whole sweep) and loops over 64-row candidate tiles; the TPU's grid
//   dimension over candidate tiles becomes that loop. Each 64 x 64 score
//   tile is spread over 256 threads (4 x 4 each); a row's 64 scores live
//   on 16 lanes of one half-warp, so the running max and sum-exp reduce
//   with four shuffles and no shared memory.
// * Backward: one block owns tiles_per_block consecutive 64-row candidate
//   tiles. For each tile j (held in shared memory) it loops over 64-row
//   query tiles i, accumulating dV_j in registers and dcol_j per thread,
//   and adds the dU product of (i, j) into its own partial du_part[block]
//   ([n_blocks, Bq, D]; the first tile writes, later ones add, each
//   element by the thread that wrote it). The wrapper sums the partials
//   with torch.sum, as the TPU wrapper sums them outside with jnp.sum. No
//   atomics, so the result is deterministic. One tile per block (the most
//   blocks) while the partials fit under the wrapper's cap; wider spans
//   above it, so the partials never exceed the cap and the fused backward
//   covers the batches the TPU's does (its 2,048-wide tiles).
// * The TPU wrapper asserts that its tiles divide the batch; here rows
//   past Bq and candidates past Bk are masked, so any Bq, Bk work.
// * D is padded to DP in {32, 64, 128, 256} with zeros in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TQ = 64;        // query rows per tile
constexpr int TK = 64;        // candidate rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 block of the tile each
constexpr float NEG_BIG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// pg rounded to the operand type (a no-op for fp32 operands)
__device__ __forceinline__ float narrow(float x, const float*) { return x; }
__device__ __forceinline__ float narrow(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum / max over the 16 lanes of a half-warp (all of them get the result)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// rows [row0, row0 + 64) of src [n_rows, d] -> dst [64][DP + 1] fp32,
// zero past n_rows and past d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows, int d) {
  for (int e = threadIdx.x; e < 64 * DP; e += THREADS) {
    const int r = e / DP, k = e % DP;
    const int gr = row0 + r;
    dst[r * (DP + 1) + k] =
        (gr < n_rows && k < d) ? widen(src[static_cast<long long>(gr) * d + k]) : 0.f;
  }
}

// acc[a][b] = A[ty + 16a] . B[tx + 16b] over DP columns (A, B [64][DP + 1])
template <int DP>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int k = 0; k < DP; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * (DP + 1) + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * (DP + 1) + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * (TQ + TK) * (DP + 1) + (sizeof(float) + sizeof(int)) * TK;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_ce_fwd_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const float* __restrict__ colcorr,
    const int* __restrict__ ids_q, const int* __restrict__ ids_k,
    const int* __restrict__ pos, int bq, int bk, int d, float* __restrict__ lse_out,
    float* __restrict__ pos_out) {
  extern __shared__ float smem[];
  float* Us = smem;                          // [TQ][DP + 1] this block's queries
  float* Vs = Us + TQ * (DP + 1);            // [TK][DP + 1] current candidate tile
  float* cs = Vs + TK * (DP + 1);            // [TK] colcorr of the tile
  int* ks = reinterpret_cast<int*>(cs + TK);  // [TK] ids_k of the tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  load_tile<T, DP>(Us, u, q0, bq, d);

  int qid[4], qpos[4];
  float m[4], l[4], ps[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    qid[a] = row < bq ? ids_q[row] : 0;
    qpos[a] = row < bq ? pos[row] : -1;
    m[a] = NEG_BIG;
    l[a] = 0.f;
    ps[a] = 0.f;
  }

  for (int k0 = 0; k0 < bk; k0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(Vs, v, k0, bk, d);
    if (tid < TK) {
      const int c = k0 + tid;
      cs[tid] = c < bk ? colcorr[c] : 0.f;
      ks[tid] = c < bk ? ids_k[c] : 0;
    }
    __syncthreads();
    float acc[4][4];
    tile_dot<DP>(Us, Vs, ty, tx, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float s[4];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b, gc = k0 + c;
        float x = acc[a][b] + cs[c];
        if (ks[c] == qid[a] && gc != qpos[a]) x = NEG_BIG;
        if (gc == qpos[a]) ps[a] += x;
        s[b] = x;
        if (gc < bk) tmax = fmaxf(tmax, x);
      }
      const float m_new = fmaxf(m[a], half_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k0 + tx + 16 * b < bk) sum += expf(s[b] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + half_sum(sum);
      m[a] = m_new;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float p = half_sum(ps[a]);  // one lane of the row holds it
    const int row = q0 + ty + 16 * a;
    if (tx == 0 && row < bq) {
      lse_out[row] = m[a] + logf(fmaxf(l[a], 1e-30f));
      pos_out[row] = p;
    }
  }
}

template <int DP>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((TQ + TK) * (DP + 1) + TQ * (TK + 1) + 16 * TK) +
         (2 * sizeof(float) + 2 * sizeof(int)) * TQ;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_ce_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const float* __restrict__ colcorr,
    const int* __restrict__ ids_q, const int* __restrict__ ids_k,
    const int* __restrict__ pos, const float* __restrict__ lse,
    const float* __restrict__ g, int bq, int bk, int d, int tiles_per_block,
    float* __restrict__ dv, float* __restrict__ dcol, float* __restrict__ du_part) {
  constexpr int NB = DP / 16;  // output columns per thread in the products
  extern __shared__ float smem[];
  float* Vs = smem;                       // [TK][DP + 1] this block's candidates
  float* Us = Vs + TK * (DP + 1);         // [TQ][DP + 1] current query tile
  float* Ps = Us + TQ * (DP + 1);         // [TQ][TK + 1] pg of the tile
  float* red = Ps + TQ * (TK + 1);        // [16][TK] dcol reduction
  float* lse_s = red + 16 * TK;           // [TQ]
  float* g_s = lse_s + TQ;                // [TQ]
  int* idq_s = reinterpret_cast<int*>(g_s + TQ);  // [TQ]
  int* pos_s = idq_s + TQ;                // [TQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* part = du_part + static_cast<long long>(blockIdx.x) * bq * d;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile_end = min(tile0 + tiles_per_block, (bk + TK - 1) / TK);

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int k0 = tile * TK;
    const bool first = tile == tile0;
    __syncthreads();  // the previous tile's readers of Vs and red are done
    load_tile<T, DP>(Vs, v, k0, bk, d);

    float corr[4], dcol_acc[4];
    int kid[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gc = k0 + tx + 16 * b;
      corr[b] = gc < bk ? colcorr[gc] : 0.f;
      kid[b] = gc < bk ? ids_k[gc] : 0;
      dcol_acc[b] = 0.f;
    }
    float dv_acc[4][NB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) dv_acc[a][b] = 0.f;

    for (int q0 = 0; q0 < bq; q0 += TQ) {
      __syncthreads();  // the previous query tile's readers are done
      load_tile<T, DP>(Us, u, q0, bq, d);
      if (tid < TQ) {
        const int r = q0 + tid;
        const bool ok = r < bq;
        lse_s[tid] = ok ? lse[r] : 0.f;
        g_s[tid] = ok ? g[r] : 0.f;
        idq_s[tid] = ok ? ids_q[r] : 0;
        pos_s[tid] = ok ? pos[r] : -1;
      }
      __syncthreads();
      float acc[4][4];
      tile_dot<DP>(Us, Vs, ty, tx, acc);  // acc[a][b]: query ty+16a, candidate tx+16b
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b, gc = k0 + c;
          float pg32 = 0.f;
          if (q0 + r < bq && gc < bk) {
            float x = acc[a][b] + corr[b];
            if (idq_s[r] == kid[b] && gc != pos_s[r]) x = NEG_BIG;
            pg32 = expf(x - lse_s[r]) * g_s[r];
          }
          dcol_acc[b] += pg32;
          Ps[r * (TK + 1) + c] = narrow(pg32, u);
        }
      }
      __syncthreads();
      // dV_j[c][k] += sum_r P[r][c] U[r][k]  (c = ty + 16a, k = tx + 16b)
      // dU_ij[r][k] = sum_c P[r][c] V[c][k]  (r = ty + 16a)
      float du_acc[4][NB];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) du_acc[a][b] = 0.f;
#pragma unroll 4
      for (int k = 0; k < 64; ++k) {
        float pt[4], pr[4], uu[NB], vv[NB];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pt[a] = Ps[k * (TK + 1) + ty + 16 * a];    // P[r = k][c = ty + 16a]
          pr[a] = Ps[(ty + 16 * a) * (TK + 1) + k];  // P[r = ty + 16a][c = k]
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          uu[b] = Us[k * (DP + 1) + tx + 16 * b];
          vv[b] = Vs[k * (DP + 1) + tx + 16 * b];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            dv_acc[a][b] = fmaf(pt[a], uu[b], dv_acc[a][b]);
            du_acc[a][b] = fmaf(pr[a], vv[b], du_acc[a][b]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gr = q0 + ty + 16 * a;
        if (gr < bq) {
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const int k = tx + 16 * b;
            if (k < d) {
              float* out = part + static_cast<long long>(gr) * d + k;
              *out = first ? du_acc[a][b] : *out + du_acc[a][b];
            }
          }
        }
      }
    }

    // dcol_j: each column's 16 per-thread sums (one per ty), added in order
#pragma unroll
    for (int b = 0; b < 4; ++b) red[ty * TK + tx + 16 * b] = dcol_acc[b];
    __syncthreads();
    if (tid < TK && k0 + tid < bk) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += red[t * TK + tid];
      dcol[k0 + tid] = s;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int gc = k0 + ty + 16 * a;
      if (gc < bk) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int k = tx + 16 * b;
          if (k < d) dv[static_cast<long long>(gc) * d + k] = dv_acc[a][b];
        }
      }
    }
  }
}

template <typename T, int DP>
int launch_fwd(const void* u, const void* v, const float* colcorr, const int* ids_q,
               const int* ids_k, const int* pos, int bq, int bk, int d, float* lse,
               float* pos_out, cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem<DP>();
  // the attribute belongs to the current device: set it on every launch
  cudaError_t e = cudaFuncSetAttribute(flash_ce_fwd_kernel<T, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_ce_fwd_kernel<T, DP><<<(bq + TQ - 1) / TQ, THREADS, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), colcorr, ids_q, ids_k, pos, bq,
      bk, d, lse, pos_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_bwd(const void* u, const void* v, const float* colcorr, const int* ids_q,
               const int* ids_k, const int* pos, const float* lse, const float* g, int bq,
               int bk, int d, int tpb, float* dv, float* dcol, float* du_part,
               cudaStream_t stream) {
  constexpr size_t bytes = bwd_smem<DP>();
  cudaError_t e = cudaFuncSetAttribute(flash_ce_bwd_kernel<T, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (bk + TK - 1) / TK;
  flash_ce_bwd_kernel<T, DP><<<(n_tiles + tpb - 1) / tpb, THREADS, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), colcorr, ids_q, ids_k, pos, lse,
      g, bq, bk, d, tpb, dv, dcol, du_part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(const void* u, const void* v, const float* colcorr, const int* ids_q,
                 const int* ids_k, const int* pos, int bq, int bk, int d, float* lse,
                 float* pos_out, cudaStream_t s) {
  if (d <= 32) return launch_fwd<T, 32>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s);
  if (d <= 64) return launch_fwd<T, 64>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s);
  if (d <= 128) return launch_fwd<T, 128>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s);
  if (d <= 256) return launch_fwd<T, 256>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_bwd(const void* u, const void* v, const float* colcorr, const int* ids_q,
                 const int* ids_k, const int* pos, const float* lse, const float* g,
                 int bq, int bk, int d, int tpb, float* dv, float* dcol, float* du_part,
                 cudaStream_t s) {
  if (d <= 32) return launch_bwd<T, 32>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s);
  if (d <= 64) return launch_bwd<T, 64>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s);
  if (d <= 128) return launch_bwd<T, 128>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s);
  if (d <= 256) return launch_bwd<T, 256>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// u [bq, d], v [bk, d] (bf16 if bf16 != 0, else fp32); colcorr [bk] fp32;
// ids_q [bq], ids_k [bk], pos [bq] int32 (0 <= pos < bk); out lse, pos_out
// [bq] fp32. All contiguous, on the stream's device; 1 <= d <= 256.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_ce_fwd(const void* u, const void* v, const float* colcorr,
                            const int* ids_q, const int* ids_k, const int* pos, int bq,
                            int bk, int d, int bf16, float* lse, float* pos_out,
                            void* stream) {
  if (bq <= 0) return 0;
  if (bk <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_fwd<__nv_bfloat16>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s)
              : dispatch_fwd<float>(u, v, colcorr, ids_q, ids_k, pos, bq, bk, d, lse, pos_out, s);
}

// As flash_ce_fwd, plus lse, g [bq] fp32 and tiles_per_block >= 1; out
// dv [bk, d], dcol [bk] and the dU partials du_part [n_blocks, bq, d],
// n_blocks = ceil(ceil(bk / 64) / tiles_per_block), all fp32 (the wrapper
// sums du_part over its first axis). Returns the cudaError_t of the launch.
extern "C" int flash_ce_bwd(const void* u, const void* v, const float* colcorr,
                            const int* ids_q, const int* ids_k, const int* pos,
                            const float* lse, const float* g, int bq, int bk, int d,
                            int bf16, int tiles_per_block, float* dv, float* dcol,
                            float* du_part, void* stream) {
  if (bk <= 0) return 0;
  if (bq <= 0 || d <= 0 || tiles_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpb = tiles_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bwd<__nv_bfloat16>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s)
              : dispatch_bwd<float>(u, v, colcorr, ids_q, ids_k, pos, lse, g, bq, bk, d, tpb, dv, dcol, du_part, s);
}
