// The routed experts' grouped GEMM for Hopper (sm_90a): kernel row 16, and
// the row-wise passes around it. No TPU kernel corresponds: the JAX package
// has no mixture of experts; it serves ops/moe.py (DeepSeekMoE's experts,
// models/mla_moe.py).
//
// One kernel computes C = A B^T of bf16 operands with fp32 sums, both K-major
// (rows of the reduction axis), for every group of a grouped product whose
// groups are given by device offsets [groups + 1] (int32, each a multiple of
// GM: the experts' token rows are padded to whole tiles with zero rows):
//   * rows mode (the forward, Y = X W, and dX = dY W^T): A [rows, K] holds
//     every group's rows end to end, group g in rows [off_g, off_g+1); B
//     [groups N, K] holds each group's [N, K] matrix; C [rows, N] = group g's
//     rows times its matrix, transposed. Only the rows below off_groups are
//     written: the host sizes A and C by a bound (it never reads the
//     offsets), and the blocks loop over the row tiles below the offsets'
//     end, which they read on the device;
//   * weights mode (dW = X^T dY): A [M, rows] and B [N, rows] hold the
//     transposed operands, each group's reduction range [off_g, off_g+1);
//     C [groups, M, N], group g's the sum over its rows in order (a group
//     with no rows: zeros).
// Design: a block a 128 x 128 tile of C at a time, two consumer warpgroups
// of 64 rows each on m64n128k16 wgmma from shared memory, the A and B tiles
// (128 rows x 64 columns, 16 KB each, 128-byte swizzle) brought by TMA into
// a ring of GSTAGES stages by thread 0, the ring's uses counted across a
// block's tiles; each warpgroup releases a stage on its own mbarrier once
// its products have read it. The sums run over K in order, in one block
// (weights mode: in spans of 1,024 rows, each span's sum added to a second
// fp32 accumulator in order): no atomics, two calls give the same bits.
//
// The row-wise passes (moe_gather, moe_swiglu, moe_transpose) loop over the
// rows below the offsets' end in the same way, so a bound-sized buffer costs
// memory but no time past the rows the experts hold.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int GM = 128;                         // rows of a C tile
constexpr int GN = 128;                         // columns of a C tile
constexpr int GK = 64;                          // reduction columns a stage
constexpr int GSTAGES = 4;                      // the ring
constexpr int GTHREADS = 256;                   // two warpgroups
constexpr int A_TILE = GM * GK * 2;             // bytes of an A tile
constexpr int B_TILE = GN * GK * 2;
constexpr size_t GSMEM = 1024 + GSTAGES * (A_TILE + B_TILE) + 2 * GSTAGES * 8 + 16;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// weights mode: the tensor cores' sums are moved into a second fp32
// accumulator (CUDA cores, round to nearest) every PROMOTE k-steps, 1,024
// rows: their own accumulation loses bits as it grows (an expert's 27,800
// rows read 3.6e-5 of the largest value against an fp32 product's sum,
// 6,500 rows 8.9e-6)
constexpr int PROMOTE = 16;

// MODE 0: rows, 1: weights. Grid (N / GN, row-tile slots) or (N / GN, M /
// GM, groups).
template <int MODE>
__global__ void __launch_bounds__(GTHREADS, 1) grouped_gemm_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    const int* __restrict__ offsets, int groups, int n, int k, int m, float* __restrict__ c) {
  constexpr int mode = MODE;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);  // [GSTAGES][A, B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GSTAGES * (A_TILE + B_TILE));
  uint64_t* empty = full + GSTAGES;
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n0 = blockIdx.x * GN;
  const int row_end = mode == 0 ? offsets[groups] : 0;
  int used = 0;  // the ring's uses so far (stage used % GSTAGES, phase used / GSTAGES)
  for (int m0 = blockIdx.y * GM;; m0 += gridDim.y * GM) {
    if (mode == 0 && m0 >= row_end) break;
    int a_row = m0, b_row = n0, k_begin = 0, k_end = k;
    float* c_tile;
    if (mode == 0) {
      int g = 0;
      while (g + 1 < groups && offsets[g + 1] <= m0) ++g;
      b_row = g * n + n0;
      c_tile = c + static_cast<long long>(m0) * n + n0;
    } else {
      const int g = blockIdx.z;
      k_begin = offsets[g];
      k_end = offsets[g + 1];
      c_tile = c + (static_cast<long long>(g) * m + m0) * n + n0;
    }
    float acc[64], sum[MODE == 1 ? 64 : 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (MODE == 1 ? 64 : 1); ++i) sum[i] = 0.f;  // weights mode's promoted sums
    const int nk = (k_end - k_begin) / GK;
    auto issue = [&](int u, int kt) {
      unsigned char* dst = ring + (u % GSTAGES) * (A_TILE + B_TILE);
      uint64_t* fb = full + u % GSTAGES;
      mbar_arrive_expect_tx(fb, A_TILE + B_TILE);
      const int kc = k_begin + kt * GK;
      tma_load_2d(dst, &a_map, kc, a_row, fb);
      tma_load_2d(dst + A_TILE, &b_map, kc, b_row, fb);
    };
    if (tid == 0)
      for (int kt = 0; kt < GSTAGES && kt < nk; ++kt) {
        const int u = used + kt;
        // the stage's previous use (an earlier tile's) released by both warpgroups
        if (u >= GSTAGES) mbar_wait(empty + u % GSTAGES, (u / GSTAGES - 1) & 1);
        issue(u, kt);
      }
    for (int kt = 0; kt < nk; ++kt) {
      const int u = used + kt, s = u % GSTAGES, ph = (u / GSTAGES) & 1;
      mbar_wait(full + s, ph);
      const unsigned char* a_t = ring + s * (A_TILE + B_TILE) + wg * (A_TILE / 2);
      const unsigned char* b_t = ring + s * (A_TILE + B_TILE) + A_TILE;
      // weights mode: the first products of a promotion's span overwrite acc
      const int fresh = MODE == 1 && kt % PROMOTE == 0 ? 0 : 1;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)
        wgmma_ss<128>(acc, sw128_desc(a_t + kk * 32, 16, 1024),
                      sw128_desc(b_t + kk * 32, 16, 1024), kk == 0 ? fresh : 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      if (wt == 0) mbar_arrive(empty + s);
      if constexpr (MODE == 1) {
        if (kt % PROMOTE == PROMOTE - 1 || kt == nk - 1) {
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += acc[i];
        }
      }
      if (tid == 0 && kt + GSTAGES < nk) {
        mbar_wait(empty + s, ph);
        issue(u + GSTAGES, kt + GSTAGES);
      }
    }
    used += nk;
    // warp w of warpgroup wg: rows 64 wg + 16 w + gq + 8 h, columns 8 j + 2 t4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = c_tile + static_cast<long long>(64 * wg + 16 * warp + gq + 8 * h) * n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 v;
        if constexpr (MODE == 1)
          v = make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        else
          v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) = v;
      }
    }
    if (mode == 1) break;
  }
}

// out [rows, d] bf16, each row r below offsets[groups]: src[r] < 0 zeros (an
// expert's padding), else row src[r] / k of x [.., d] fp32, times
// scale[src[r]] where scale is given (a block a row at a time)
__global__ void moe_gather_kernel(const float* __restrict__ x, int d,
                                  const long long* __restrict__ src,
                                  const float* __restrict__ scale, int k,
                                  const int* __restrict__ offsets, int groups,
                                  __nv_bfloat16* __restrict__ out) {
  const int end = offsets[groups];
  for (int r = blockIdx.x; r < end; r += gridDim.x) {
    const long long p = src[r];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r) * d);
    if (p < 0) {
      for (int i = threadIdx.x; i < d / 2; i += blockDim.x) o[i] = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    const float2* xi = reinterpret_cast<const float2*>(x + (p / k) * d);
    if (scale == nullptr) {
      for (int i = threadIdx.x; i < d / 2; i += blockDim.x) {
        const float2 v = xi[i];
        o[i] = __floats2bfloat162_rn(v.x, v.y);
      }
    } else {
      const float w = scale[p];
      for (int i = threadIdx.x; i < d / 2; i += blockDim.x) {
        const float2 v = xi[i];
        o[i] = __floats2bfloat162_rn(w * v.x, w * v.y);
      }
    }
  }
}

// SwiGLU over gu [rows, 2 width] fp32 (g the first width columns, u the
// rest), each row below offsets[groups]: forward (dh null) out [rows, width]
// bf16 = silu(g) u; backward out [rows, 2 width] bf16 = [dh u sg (1 + g (1 -
// sg)), dh g sg], sg = sigmoid(g), dh [rows, width] fp32 (a block a row at a
// time)
__global__ void moe_swiglu_kernel(const float* __restrict__ gu, const float* __restrict__ dh,
                                  int width, const int* __restrict__ offsets, int groups,
                                  __nv_bfloat16* __restrict__ out) {
  const int end = offsets[groups];
  for (int r = blockIdx.x; r < end; r += gridDim.x) {
    const float* gr = gu + static_cast<long long>(r) * 2 * width;
    if (dh == nullptr) {
      __nv_bfloat16* o = out + static_cast<long long>(r) * width;
      for (int i = threadIdx.x; i < width; i += blockDim.x) {
        const float g = gr[i];
        o[i] = __float2bfloat16_rn(g / (1.f + expf(-g)) * gr[width + i]);
      }
    } else {
      const float* dr = dh + static_cast<long long>(r) * width;
      __nv_bfloat16* o = out + static_cast<long long>(r) * 2 * width;
      for (int i = threadIdx.x; i < width; i += blockDim.x) {
        const float g = gr[i], u = gr[width + i], d = dr[i];
        const float sg = 1.f / (1.f + expf(-g));
        o[i] = __float2bfloat16_rn(d * u * sg * (1.f + g * (1.f - sg)));
        o[width + i] = __float2bfloat16_rn(d * g * sg);
      }
    }
  }
}

// out [width, rows] = in [rows, width]^T (bf16), the rows below
// offsets[groups] (a multiple of 32) in 32 x 32 tiles through shared memory
__global__ void moe_transpose_kernel(const unsigned short* __restrict__ in, int width,
                                     const int* __restrict__ offsets, int groups, int rows,
                                     unsigned short* __restrict__ out) {
  __shared__ unsigned short tile[32][33];
  const int cols = width / 32;
  const long long tiles = static_cast<long long>(offsets[groups] / 32) * cols;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = static_cast<int>(t / cols) * 32, c0 = static_cast<int>(t % cols) * 32;
    for (int i = threadIdx.y; i < 32; i += 8)
      tile[i][threadIdx.x] = in[static_cast<long long>(r0 + i) * width + c0 + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8)
      out[static_cast<long long>(c0 + i) * rows + r0 + threadIdx.x] = tile[threadIdx.x][i];
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace

// mode 0 (rows): a [rows, k] and b [groups n, k] bf16 -> c [rows, n] fp32,
// the rows below offsets[groups] written, as many blocks as fill the SMs once
// looping over their row tiles; mode 1 (weights): a [m, rows] and b [n,
// rows] bf16 -> c [groups, m, n] fp32. offsets [groups + 1] int32 on the
// device, multiples of GM (rows mode) or GK (weights mode), offsets[0] = 0,
// offsets[groups] <= rows. n % GN == 0, k % GK == 0 (rows mode), m % GM == 0
// (weights mode), rows % GM == 0. Returns the cudaError_t of the launch.
extern "C" int grouped_gemm(int mode, const void* a, const void* b, const int* offsets,
                            int groups, int rows, int m, int n, int k, float* c, void* stream) {
  if (groups <= 0 || n % GN || rows % GM || (mode == 0 && k % GK) || (mode == 1 && m % GM) ||
      mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    if (mode == 0) return 0;
    const cudaError_t e = cudaMemsetAsync(
        c, 0, static_cast<size_t>(groups) * m * n * sizeof(float), s);
    return static_cast<int>(e);
  }
  CUtensorMap am, bm;
  const bool ok = mode == 0 ? rows_map(&am, a, rows, k, GM) && rows_map(&bm, b, groups * n, k, GN)
                            : rows_map(&am, a, m, rows, GM) && rows_map(&bm, b, n, rows, GN);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  const int slots = std::max(1, std::min(rows / GM, sm_count() / (n / GN)));
  const dim3 grid = mode == 0 ? dim3(n / GN, slots) : dim3(n / GN, m / GM, groups);
  return mode == 0 ? launch(grouped_gemm_kernel<0>, grid, GTHREADS, GSMEM, s, am, bm, offsets,
                            groups, n, k, m, c)
                   : launch(grouped_gemm_kernel<1>, grid, GTHREADS, GSMEM, s, am, bm, offsets,
                            groups, n, k, m, c);
}

// out [rows, d] bf16: the rows below offsets[groups] gathered from x [.., d]
// fp32 by src [rows] int64 (pair index p: row p / k, times scale[p] where
// scale is not null; -1: zeros). d % 2 == 0.
extern "C" int moe_gather(const float* x, int d, const long long* src, const float* scale,
                          int k, const int* offsets, int groups, void* out, void* stream) {
  if (d % 2 || k <= 0 || groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  moe_gather_kernel<<<sm_count() * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, d, src, scale, k, offsets, groups, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// SwiGLU of gu [rows, 2 width] fp32 below offsets[groups]: forward (dh null)
// -> out [rows, width] bf16; backward with dh [rows, width] fp32 -> out
// [rows, 2 width] bf16.
extern "C" int moe_swiglu(const float* gu, const float* dh, int width, const int* offsets,
                          int groups, void* out, void* stream) {
  if (width <= 0 || groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  moe_swiglu_kernel<<<sm_count() * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      gu, dh, width, offsets, groups, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [width, rows] bf16 = in [rows, width]^T below offsets[groups] (a
// multiple of 32); width % 32 == 0.
extern "C" int moe_transpose(const void* in, int width, const int* offsets, int groups, int rows,
                             void* out, void* stream) {
  if (width % 32 || groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  moe_transpose_kernel<<<sm_count() * 8, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(in), width, offsets, groups, rows,
      static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
}
