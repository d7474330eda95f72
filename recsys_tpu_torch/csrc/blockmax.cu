// Group-max sieve, pass 1, for Hopper (sm_90a): for each query and each
// group of g consecutive items, the max of the fp32-accumulated dots.
//
// Replaces: recsys_tpu/ops/pallas/topk_flash.py::_blockmax_kernel (the TPU
// kernel reached through blockmax_topk).
//
// Computes out[q, j] = max over items i in [j*g, min((j+1)*g, N)) of
// u_q . v_i, for u [Q, d] and v [N, d] both bf16 (the served route) or
// both fp32, into out [Q, ceil(N / g)] fp32. Every group holds at least
// one real item; items past N are never scored, so a padded item never
// wins a group (the TPU kernel scores them -1e30 for the same effect).
//
// What bounds it on the H100: at serving shapes, bytes. With Q <= 64 the
// product is 2*Q*N*d operations against N*d*2 bytes of bf16 catalog: at
// N = 1,048,576, d = 128 that is 268 MB, 0.080 ms at 3.35 TB/s, far above
// the 0.0035 ms of 17 GFLOP at the 989 TFLOP/s bf16 tensor-core rate. At
// Q = 4,096, N = 8,388,608 it is operations: 8.8 TFLOP, 8.9 ms at the bf16
// tensor-core rate (131 ms at the 67 TFLOP/s fp32 rate).
//
// This first version does NOT reach either bound: the products run on the
// fp32 FMA units (bf16 widened to fp32 in shared memory; a product of two
// bf16 values is exact in fp32, so each dot equals the TPU's
// fp32-accumulated bf16 dot up to summation order), with a 4 x 4 register
// tile per thread, as csrc/flash_ce.cu. It is bound by the fp32
// instruction rate and shared-memory loads; mma.sync / wgmma tiles are
// later speed work, and at Q <= 64 a 64-row query tile also multiplies
// padding (63 of 64 rows at Q = 1).
//
// Design, and how it departs from the TPU kernel:
// * Blocks run in no order, so a block owns one 64-row query tile and
//   groups_per_block whole groups: no sum and no max crosses blocks, and
//   each output element is written once. A group's items are swept in
//   64-item tiles starting at the group's first item, so a tile never
//   straddles two groups; each thread keeps the running max of its 4 rows
//   in registers over the group's tiles, and a half-warp (which holds the
//   row's 64 scores of a tile, 4 per lane) reduces it with four shuffles.
// * The output is [Q, n_groups] directly: the TPU's transposed
//   [n_groups, Q] layout only served Mosaic's reshape rules. Ragged Q and N
//   are masked here, so no padding to the TPU's tile multiples (tb a
//   multiple of 8*g, tq of 128) and any N and g work.
// * Re-streaming the catalog once per query tile would read it
//   ceil(Q / 64) times (64 x 2.1 GB at Q = 4,096, N = 8M). The grid is one
//   dimension with the query tile varying fastest, so the ceil(Q / 64)
//   blocks of one group chunk are dispatched together: the first reads the
//   chunk from device memory and the others find it in the 50 MB L2. The
//   queries (1 MB at Q = 4,096 in bf16) stay in L2 throughout.
// * The depth is staged 32 columns at a time, so any d works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TB = 64;        // items per scoring tile
constexpr int BK = 32;        // depth slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// max over the 16 lanes of a half-warp (all of them get the result)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) blockmax_kernel(
    const T* __restrict__ u, const T* __restrict__ v, int q_n, int n, int d, int g,
    int n_groups, int groups_per_block, int n_qtiles, float* __restrict__ out) {
  __shared__ float As[BK][TQ + 1];  // query slice, transposed
  __shared__ float Bs[BK][TB + 1];  // item slice, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (blockIdx.x % n_qtiles) * TQ;
  const long long grp_begin =
      static_cast<long long>(blockIdx.x / n_qtiles) * groups_per_block;
  const long long grp_end = min(static_cast<long long>(n_groups),
                                grp_begin + groups_per_block);

  for (long long grp = grp_begin; grp < grp_end; ++grp) {  // block-uniform
    const long long item_begin = grp * g;
    const long long item_end = min(static_cast<long long>(n), item_begin + g);
    float rmax[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
    for (long long t0 = item_begin; t0 < item_end; t0 += TB) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int d0 = 0; d0 < d; d0 += BK) {
        __syncthreads();  // the previous slice's readers are done
        for (int e = tid; e < TQ * BK; e += THREADS) {
          const int r = e / BK, k = e % BK;
          const int q = q0 + r, dd = d0 + k;
          As[k][r] = (q < q_n && dd < d) ? widen(u[static_cast<long long>(q) * d + dd]) : 0.f;
        }
        for (int e = tid; e < TB * BK; e += THREADS) {
          const int r = e / BK, k = e % BK;
          const long long it = t0 + r;
          const int dd = d0 + k;
          Bs[k][r] = (it < item_end && dd < d) ? widen(v[it * d + dd]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t0 + tx + 16 * j < item_end) {  // items of the next group, or past N
#pragma unroll
          for (int i = 0; i < 4; ++i) rmax[i] = fmaxf(rmax[i], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = half_max(rmax[i]);
      const int q = q0 + ty + 16 * i;
      if (tx == 0 && q < q_n) out[static_cast<long long>(q) * n_groups + grp] = m;
    }
  }
}

template <typename T>
int launch(const T* u, const T* v, int q_n, int n, int d, int g, int groups_per_block,
           float* out, cudaStream_t stream) {
  const int n_groups = static_cast<int>((static_cast<long long>(n) + g - 1) / g);
  const int n_qtiles = (q_n + TQ - 1) / TQ;
  const long long n_chunks = (n_groups + groups_per_block - 1) / groups_per_block;
  const long long n_blocks = n_chunks * n_qtiles;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  blockmax_kernel<T><<<static_cast<unsigned>(n_blocks), THREADS, 0, stream>>>(
      u, v, q_n, n, d, g, n_groups, groups_per_block, n_qtiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u [q_n, d], v [n, d] contiguous, both bf16 (is_bf16 = 1) or both fp32;
// out [q_n, ceil(n / g)] fp32. Returns the cudaError_t of the launch.
extern "C" int blockmax_group_max(const void* u, const void* v, int q_n, int n, int d,
                                  int g, int groups_per_block, int is_bf16, float* out,
                                  void* stream) {
  if (q_n <= 0 || n <= 0) return 0;
  if (d <= 0 || g <= 0 || groups_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(v),
                  q_n, n, d, g, groups_per_block, out, s);
  return launch(static_cast<const float*>(u), static_cast<const float*>(v), q_n, n, d, g,
                groups_per_block, out, s);
}
