// Fused DCN cross stack, forward and backward, for Hopper (sm_90a).
//
// Replaces: recsys_tpu/ops/pallas/dcn_cross.py::_fwd_kernel (the TPU
// kernel reached through dcn_cross_fused -> _call_fwd) and ::_bwd_kernel
// (reached through _dcn_cross_bwd); the backward is described below the
// forward.
//
// Computes all L layers of the rank-1 cross recurrence
//     x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
// in one launch, with x0 and the running x_l held in registers, so each
// row of x0 is read once and its output written once.
//
// What bounds it on the H100: memory. Per row it moves F*4 bytes in and
// F*4 bytes out (plus the [L, F] weights, which stay in L2) and does
// about 5*L*F flops, about 2 flops per byte against the card's ~20 fp32
// flops per byte of bandwidth. The design spends nothing beyond those
// bytes: one warp owns one row, each lane keeps F/32 values of x0 and
// x_l in registers, loads are coalesced (lane j reads column j + 32*i),
// and x_l . w_l is a warp-shuffle reduction, so no shared memory and no
// block-wide barrier is needed. The TPU version tiles the batch in
// multiples of 8 rows and falls back to one whole-batch block when the
// row count is ragged; here a warp whose row lies past n simply exits,
// so any n works.
//
// The optional `resid` output ([L, n, F], each layer's input x_l) saves
// what the backward pass needs; inference passes null.
//
// Rounding: each element update is x0*s, then + b, then + x_l, each
// rounded to fp32 (no FMA contraction), as the plain PyTorch version
// computes it; only the order of the F-term sum in x_l . w_l differs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <int VPT>
__global__ void __launch_bounds__(256) dcn_cross_fwd_kernel(
    const float* __restrict__ x0, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out,
    float* __restrict__ resid, int n, int f, int n_layers) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // ragged tail: the whole warp leaves together

  const float* xr = x0 + row * f;
  float x0r[VPT];
  float xl[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    x0r[j] = c < f ? xr[c] : 0.f;
    xl[j] = x0r[j];
  }
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = w + static_cast<long long>(l) * f;
    const float* bl = b + static_cast<long long>(l) * f;
    if (resid != nullptr) {
      float* rr = resid + (static_cast<long long>(l) * n + row) * f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        if (c < f) rr[c] = xl[j];
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < f) s = __fmaf_rn(xl[j], wl[c], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < f) xl[j] = __fadd_rn(__fadd_rn(__fmul_rn(x0r[j], s), bl[c]), xl[j]);
    }
  }
  float* orow = out + row * f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if (c < f) orow[c] = xl[j];
  }
}

template <int VPT>
void launch(const float* x0, const float* w, const float* b, float* out,
            float* resid, int n, int f, int n_layers, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps, one row each
  const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  dcn_cross_fwd_kernel<VPT><<<blocks, kThreads, 0, stream>>>(
      x0, w, b, out, resid, n, f, n_layers);
}


// ---- backward ----------------------------------------------------------
//
// Replaces recsys_tpu/ops/pallas/dcn_cross.py::_bwd_kernel. The
// hand-derived VJP of the TPU kernel (dcn_cross.py:57-81), per row, from
// the last layer down, with g the cotangent of x_{l+1}:
//     s_l = x_l . w_l,  t_l = g . x0,
//     dw_l += t_l * x_l,  db_l += g,  dx0 += g * s_l,  g += t_l * w_l,
// and dx0 + g at the end. x_l comes from the forward's `resid`.
//
// What bounds it on the H100: memory, as the forward. Per row it reads
// x0, g and the L saved x_l (F*4 bytes each) and writes dx0, with about
// 11*L*F flops, ~2 flops per byte: 50 MB at n = 8,192, F = 256, L = 3,
// 0.015 ms at 3.35 TB/s. So the design keeps bytes in flight and spends
// little beside them:
// * One warp owns one row at a time (rows blockIdx.x * 8 + warp, then
//   every gridDim.x * 8th); x0, g and dx0 stay in registers, and the two
//   dot products per layer are warp-shuffle sums. Rows load 16 bytes a
//   lane where F % 4 == 0 and the rows start on 16 bytes.
// * dw and db are sums over all rows. Where L <= 4 and F <= 256
//   (dcn_cross_bwd_kernel, L and F / 32 compile-time) each lane keeps its
//   columns of both in registers (48 floats at the flagship) and issues
//   all L + 2 loads of a row (x0, g and every x_l) before the first
//   reduction, so a row costs one round trip to device memory, not L, and
//   issues the next row's loads before computing this one's, so the
//   device memory streams while the warp computes (one block per SM).
//   Larger stacks (dcn_cross_bwd_smem_kernel) keep each warp's dw and db
//   in shared memory, a read-modify-write per element and row, and load
//   x_l layer by layer. Either way the block adds its warps' sums in warp
//   order through shared memory into a per-block partial [n_blocks, 2, L,
//   F].
// * A second kernel adds the partials (dcn_cross_bwd_reduce_kernel): each
//   column's n_blocks partials in RED_SLICES slices of consecutive blocks
//   (9 partials a slice at 264 blocks: one round of independent loads),
//   each slice summed in block order by its own thread, then the slice sums
//   in order.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits. (The TPU kernel adds dw and db across batch tiles in scratch,
// which is right only because its grid runs in order.)

constexpr int BWD_WARPS = 8;
constexpr int RED_COLS = 32;    // columns per block of the partials' reduction
constexpr int RED_SLICES = 32;  // slices of consecutive partials per column
constexpr int REG_LAYERS = 4;   // dcn_cross_bwd_kernel: L <= REG_LAYERS,
constexpr int REG_VPT = 8;      // F <= 32 REG_VPT

// The column of a lane's value j: lane + 32 j, or with 16-byte rows (V4)
// the lane's (j / 4)-th chunk of 4 consecutive columns.
template <bool V4>
__device__ __forceinline__ int bwd_col(int lane, int j) {
  return V4 ? 4 * (lane + 32 * (j / 4)) + j % 4 : lane + 32 * j;
}

// x[j] = row[bwd_col(lane, j)] for j < VPT, 0 past f
template <int VPT, bool V4>
__device__ __forceinline__ void load_row(float (&x)[VPT], const float* __restrict__ row,
                                         int lane, int f) {
#pragma unroll
  for (int j = 0; j < VPT; j += (V4 ? 4 : 1)) {
    const int c = bwd_col<V4>(lane, j);
    if constexpr (V4) {
      const float4 q = c < f ? *reinterpret_cast<const float4*>(row + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      x[j] = q.x;
      x[j + 1] = q.y;
      x[j + 2] = q.z;
      x[j + 3] = q.w;
    } else {
      x[j] = c < f ? row[c] : 0.f;
    }
  }
}

// One layer of a row's VJP, x = x_l and wl = w_l: s = x . w_l and t = g .
// x0 as warp sums; the layer's dw and db terms go to add(j, t x[j], g[j]);
// then dx += g s and g += t w_l.
template <int VPT, bool V4, typename Add>
__device__ __forceinline__ void bwd_layer(const float (&x0r)[VPT], const float (&x)[VPT],
                                          float (&g)[VPT], float (&dx)[VPT],
                                          const float* __restrict__ wl, int lane, int f,
                                          Add&& add) {
  float wv[VPT];
  load_row<VPT, V4>(wv, wl, lane, f);
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    s = __fmaf_rn(x[j], wv[j], s);
    t = __fmaf_rn(g[j], x0r[j], t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    add(j, __fmul_rn(t, x[j]), g[j]);
    dx[j] = __fadd_rn(dx[j], __fmul_rn(g[j], s));
    g[j] = __fadd_rn(g[j], __fmul_rn(t, wv[j]));
  }
}

// dx0's row: dx + g at the lane's columns
template <int VPT, bool V4>
__device__ __forceinline__ void store_dx(const float (&dx)[VPT], const float (&g)[VPT],
                                         float* __restrict__ row, int lane, int f) {
#pragma unroll
  for (int j = 0; j < VPT; j += (V4 ? 4 : 1)) {
    const int c = bwd_col<V4>(lane, j);
    if (c >= f) continue;
    if constexpr (V4)
      *reinterpret_cast<float4*>(row + c) =
          make_float4(__fadd_rn(dx[j], g[j]), __fadd_rn(dx[j + 1], g[j + 1]),
                      __fadd_rn(dx[j + 2], g[j + 2]), __fadd_rn(dx[j + 3], g[j + 3]));
    else
      row[c] = __fadd_rn(dx[j], g[j]);
  }
}

// The block's warps' slices acc [BWD_WARPS][2 lf] added in warp order into
// its partial `out` [2 lf], after a barrier.
__device__ __forceinline__ void fold_warps(const float* acc, float* __restrict__ out, int lf) {
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * lf; e += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_WARPS; ++k) sum += acc[static_cast<long long>(k) * 2 * lf + e];
    out[e] = sum;
  }
}

// dw and db in registers: L layers (L <= REG_LAYERS), F <= 32 VPT. A warp
// issues the next row's loads before it computes the row it holds, so its
// loads stay in flight while it computes: two rows of registers (~170 a
// thread), one block per SM (the grid is one block per SM).
template <int VPT, int L, bool V4>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1) dcn_cross_bwd_kernel(
    const float* __restrict__ x0, const float* __restrict__ w,
    const float* __restrict__ resid, const float* __restrict__ g_out,
    float* __restrict__ dx0, float* __restrict__ part, int n, int f) {
  extern __shared__ float acc[];  // [BWD_WARPS][2][L][f]: dw, then db, at the end
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float dw[L][VPT], db[L][VPT];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int j = 0; j < VPT; ++j) dw[l][j] = db[l][j] = 0.f;

  // x0, g and every x_l of row r
  auto load = [&](long long r, float (&a)[VPT], float (&b)[VPT], float (&c)[L][VPT]) {
    load_row<VPT, V4>(a, x0 + r * f, lane, f);
    load_row<VPT, V4>(b, g_out + r * f, lane, f);
#pragma unroll
    for (int l = 0; l < L; ++l)
      load_row<VPT, V4>(c[l], resid + (static_cast<long long>(l) * n + r) * f, lane, f);
  };
  const long long stride = static_cast<long long>(gridDim.x) * BWD_WARPS;
  long long row = static_cast<long long>(blockIdx.x) * BWD_WARPS + warp;
  float x0r[VPT], g[VPT], xl[L][VPT];
  if (row < n) load(row, x0r, g, xl);
  for (; row < n; row += stride) {
    float nx0[VPT], ng[VPT], nxl[L][VPT], dx[VPT];
    if (row + stride < n) load(row + stride, nx0, ng, nxl);
#pragma unroll
    for (int j = 0; j < VPT; ++j) dx[j] = 0.f;
#pragma unroll
    for (int l = L - 1; l >= 0; --l)
      bwd_layer<VPT, V4>(x0r, xl[l], g, dx, w + l * f, lane, f, [&](int j, float dwv, float dbv) {
        dw[l][j] = __fadd_rn(dw[l][j], dwv);
        db[l][j] = __fadd_rn(db[l][j], dbv);
      });
    store_dx<VPT, V4>(dx, g, dx0 + row * f, lane, f);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      x0r[j] = nx0[j];
      g[j] = ng[j];
#pragma unroll
      for (int l = 0; l < L; ++l) xl[l][j] = nxl[l][j];
    }
  }
  float* mine = acc + warp * 2 * L * f;
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = bwd_col<V4>(lane, j);
      if (c < f) {
        mine[l * f + c] = dw[l][j];
        mine[(L + l) * f + c] = db[l][j];
      }
    }
  fold_warps(acc, part + static_cast<long long>(blockIdx.x) * 2 * L * f, L * f);
}

// dw and db in shared memory: any L, F <= 32 VPT.
template <int VPT>
__global__ void __launch_bounds__(BWD_WARPS * 32) dcn_cross_bwd_smem_kernel(
    const float* __restrict__ x0, const float* __restrict__ w,
    const float* __restrict__ resid, const float* __restrict__ g_out,
    float* __restrict__ dx0, float* __restrict__ part, int n, int f, int n_layers) {
  extern __shared__ float acc[];  // [BWD_WARPS][2][n_layers][f]: dw, then db
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lf = n_layers * f;
  float* mine = acc + static_cast<long long>(warp) * 2 * lf;
  for (int e = lane; e < 2 * lf; e += 32) mine[e] = 0.f;
  __syncwarp();  // a warp touches only its own slice until the block sum

  for (long long row = static_cast<long long>(blockIdx.x) * BWD_WARPS + warp; row < n;
       row += static_cast<long long>(gridDim.x) * BWD_WARPS) {
    float x0r[VPT], g[VPT], x[VPT], dx[VPT];
    load_row<VPT, false>(x0r, x0 + row * f, lane, f);
    load_row<VPT, false>(g, g_out + row * f, lane, f);
#pragma unroll
    for (int j = 0; j < VPT; ++j) dx[j] = 0.f;
    for (int l = n_layers - 1; l >= 0; --l) {
      load_row<VPT, false>(x, resid + (static_cast<long long>(l) * n + row) * f, lane, f);
      float* dwl = mine + static_cast<long long>(l) * f;
      float* dbl = mine + lf + static_cast<long long>(l) * f;
      bwd_layer<VPT, false>(x0r, x, g, dx, w + static_cast<long long>(l) * f, lane, f,
                            [&](int j, float dwv, float dbv) {
                              const int c = lane + 32 * j;
                              if (c < f) {
                                dwl[c] = __fadd_rn(dwl[c], dwv);
                                dbl[c] = __fadd_rn(dbl[c], dbv);
                              }
                            });
    }
    store_dx<VPT, false>(dx, g, dx0 + row * f, lane, f);
  }
  fold_warps(acc, part + static_cast<long long>(blockIdx.x) * 2 * lf, lf);
}

// part [n_parts, 2 len] -> dw [len], db [len]: block x takes columns
// [32 x, 32 x + 32); thread (s, c) sums slice s of the parts (consecutive,
// in order), then thread (0, c) adds the slice sums in order.
__global__ void __launch_bounds__(RED_COLS * RED_SLICES) dcn_cross_bwd_reduce_kernel(
    const float* __restrict__ part, int n_parts, int len, float* __restrict__ dw,
    float* __restrict__ db) {
  __shared__ float sums[RED_SLICES][RED_COLS];
  const int col = threadIdx.x % RED_COLS, slice = threadIdx.x / RED_COLS;
  const int e = blockIdx.x * RED_COLS + col;
  const int per = (n_parts + RED_SLICES - 1) / RED_SLICES;
  const int p_end = min(n_parts, (slice + 1) * per);
  float sum = 0.f;
  if (e < 2 * len) {
#pragma unroll 4
    for (int p = slice * per; p < p_end; ++p) sum += part[static_cast<long long>(p) * 2 * len + e];
  }
  sums[slice][col] = sum;
  __syncthreads();
  if (slice != 0 || e >= 2 * len) return;
  float total = 0.f;
#pragma unroll
  for (int s = 0; s < RED_SLICES; ++s) total += sums[s][col];
  if (e < len) {
    dw[e] = total;
  } else {
    db[e - len] = total;
  }
}

// kernel<<<n_blocks, 256, bytes, s>>>(args...) after allowing it `bytes`
// of dynamic shared memory (the attribute belongs to the current device: it
// is set on every launch), then the reduction of its partials
template <typename K, typename... A>
int launch_bwd(K kernel, int n_blocks, size_t bytes, const float* part, float* dw, float* db,
               int len, cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, BWD_WARPS * 32, bytes, stream>>>(args...);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dcn_cross_bwd_reduce_kernel<<<(2 * len + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0,
                                stream>>>(part, n_blocks, len, dw, db);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, VPT>{}) for the values per lane of f columns
template <typename F>
int by_vpt(int f, int max_vpt, F&& fn) {
  const int vpt = (f + 31) / 32;
  if (vpt <= 1) return fn(std::integral_constant<int, 1>{});
  if (vpt <= 2) return fn(std::integral_constant<int, 2>{});
  if (vpt <= 4) return fn(std::integral_constant<int, 4>{});
  if (vpt <= 8) return fn(std::integral_constant<int, 8>{});
  if (vpt <= 16 && max_vpt >= 16) return fn(std::integral_constant<int, 16>{});
  if (vpt <= 32 && max_vpt >= 32) return fn(std::integral_constant<int, 32>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(std::integral_constant<int, L>{}) for n_layers <= REG_LAYERS
template <typename F>
int by_layers(int n_layers, F&& fn) {
  switch (n_layers) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x0 [n, f], w and b [n_layers, f], out [n, f], resid [n_layers, n, f] or
// null; all fp32, contiguous, on the stream's device. f <= 1024.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcn_cross_fwd(const float* x0, const float* w, const float* b,
                             float* out, float* resid, int n, int f,
                             int n_layers, void* stream) {
  if (n <= 0) return 0;
  const int vpt = (f + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vpt <= 1) {
    launch<1>(x0, w, b, out, resid, n, f, n_layers, s);
  } else if (vpt <= 2) {
    launch<2>(x0, w, b, out, resid, n, f, n_layers, s);
  } else if (vpt <= 4) {
    launch<4>(x0, w, b, out, resid, n, f, n_layers, s);
  } else if (vpt <= 8) {
    launch<8>(x0, w, b, out, resid, n, f, n_layers, s);
  } else if (vpt <= 16) {
    launch<16>(x0, w, b, out, resid, n, f, n_layers, s);
  } else if (vpt <= 32) {
    launch<32>(x0, w, b, out, resid, n, f, n_layers, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x0 [n, f], w [n_layers, f], resid [n_layers, n, f] (the forward's), g
// [n, f] (the cotangent of the output); out dx0 [n, f], dw and db
// [n_layers, f], with scratch part [n_blocks, 2, n_layers, f]. All fp32,
// contiguous, on the stream's device; f <= 1024 and 8 * 2 * n_layers * f * 4
// bytes of shared memory at most what a block may have. registers != 0
// takes dcn_cross_bwd_kernel (n_layers <= 4, f <= 256), else
// dcn_cross_bwd_smem_kernel. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int dcn_cross_bwd(const float* x0, const float* w, const float* resid,
                             const float* g, float* dx0, float* part, float* dw,
                             float* db, int n, int f, int n_layers, int n_blocks,
                             int registers, void* stream) {
  if (n <= 0 || n_layers <= 0 || n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lf = n_layers * f;
  const size_t bytes = sizeof(float) * BWD_WARPS * 2 * lf;
  if (!registers)
    return by_vpt(f, 32, [&](auto vv) {
      constexpr int VPT = decltype(vv)::value;
      return launch_bwd(dcn_cross_bwd_smem_kernel<VPT>, n_blocks, bytes, part, dw, db, lf, s,
                        x0, w, resid, g, dx0, part, n, f, n_layers);
    });
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(resid) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx0);
  const bool v4 = f % 4 == 0 && addr % 16 == 0;
  return by_vpt(f, REG_VPT, [&](auto vv) {
    constexpr int VPT = decltype(vv)::value;
    return by_layers(n_layers, [&](auto ll) {
      constexpr int L = decltype(ll)::value;
      if constexpr (VPT > REG_VPT) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        if constexpr (VPT >= 4)
          if (v4)
            return launch_bwd(dcn_cross_bwd_kernel<VPT, L, true>, n_blocks, bytes, part, dw, db,
                              lf, s, x0, w, resid, g, dx0, part, n, f);
        return launch_bwd(dcn_cross_bwd_kernel<VPT, L, false>, n_blocks, bytes, part, dw, db,
                          lf, s, x0, w, resid, g, dx0, part, n, f);
      }
    });
  });
}
