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
// The hand-derived VJP of the TPU kernel (dcn_cross.py:57-81), per row,
// from the last layer down, with g the cotangent of x_{l+1}:
//     s_l = x_l . w_l,  t_l = g . x0,
//     dw_l += t_l * x_l,  db_l += g,  dx0 += g * s_l,  g += t_l * w_l,
// and dx0 + g at the end. x_l comes from the forward's `resid`.
//
// What bounds it on the H100: memory, as the forward. Per row it reads
// x0, g and the L saved x_l (F*4 bytes each) and writes dx0, with about
// 11*L*F flops, ~2 flops per byte. One warp owns one row at a time (x0, g
// and dx0 in registers, the two dot products as warp-shuffle sums).
//
// dw and db are sums over all rows. The TPU kernel adds them across batch
// tiles in scratch, which is right only because its grid runs in order.
// Here each warp adds its rows into its own slice of shared memory (each
// lane owns its columns, so no atomics), the block adds its warps' slices
// in warp order into a per-block partial [n_blocks, 2, L, F], and a second
// kernel adds the partials in block order: deterministic, run to run.

constexpr int BWD_WARPS = 8;

template <int VPT>
__global__ void __launch_bounds__(BWD_WARPS * 32) dcn_cross_bwd_kernel(
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
    float x0r[VPT], g[VPT], dx[VPT], xl[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      x0r[j] = c < f ? x0[row * f + c] : 0.f;
      g[j] = c < f ? g_out[row * f + c] : 0.f;
      dx[j] = 0.f;
    }
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* xr = resid + (static_cast<long long>(l) * n + row) * f;
      const float* wl = w + static_cast<long long>(l) * f;
      float s = 0.f, t = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        xl[j] = c < f ? xr[c] : 0.f;
        if (c < f) s = __fmaf_rn(xl[j], wl[c], s);
        t = __fmaf_rn(g[j], x0r[j], t);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        t += __shfl_xor_sync(0xffffffffu, t, off);
      }
      float* dwl = mine + static_cast<long long>(l) * f;
      float* dbl = mine + lf + static_cast<long long>(l) * f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        if (c < f) {
          dwl[c] = __fadd_rn(dwl[c], __fmul_rn(t, xl[j]));
          dbl[c] = __fadd_rn(dbl[c], g[j]);
          dx[j] = __fadd_rn(dx[j], __fmul_rn(g[j], s));
          g[j] = __fadd_rn(g[j], __fmul_rn(t, wl[c]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < f) dx0[row * f + c] = __fadd_rn(dx[j], g[j]);
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * lf;
  for (int e = threadIdx.x; e < 2 * lf; e += blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < BWD_WARPS; ++k) sum += acc[static_cast<long long>(k) * 2 * lf + e];
    out[e] = sum;
  }
}

// part [n_parts, 2, len] -> dw [len], db [len], adding the parts in order
__global__ void dcn_cross_bwd_reduce_kernel(const float* __restrict__ part, int n_parts,
                                            int len, float* __restrict__ dw,
                                            float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * len) return;
  float sum = 0.f;
  for (int p = 0; p < n_parts; ++p) sum += part[static_cast<long long>(p) * 2 * len + e];
  if (e < len) {
    dw[e] = sum;
  } else {
    db[e - len] = sum;
  }
}

template <int VPT>
int launch_bwd(const float* x0, const float* w, const float* resid, const float* g,
               float* dx0, float* part, float* dw, float* db, int n, int f,
               int n_layers, int n_blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * BWD_WARPS * 2 * n_layers * f;
  // the attribute belongs to the current device: set it on every launch
  cudaError_t e = cudaFuncSetAttribute(dcn_cross_bwd_kernel<VPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dcn_cross_bwd_kernel<VPT><<<n_blocks, BWD_WARPS * 32, bytes, stream>>>(
      x0, w, resid, g, dx0, part, n, f, n_layers);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int len = n_layers * f;
  dcn_cross_bwd_reduce_kernel<<<(2 * len + 255) / 256, 256, 0, stream>>>(
      part, n_blocks, len, dw, db);
  return static_cast<int>(cudaGetLastError());
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
// contiguous, on the stream's device; f <= 1024 and
// 8 * 2 * n_layers * f * 4 bytes of shared memory at most what a block
// may have. Returns the cudaError_t of the launches (0 on success).
extern "C" int dcn_cross_bwd(const float* x0, const float* w, const float* resid,
                             const float* g, float* dx0, float* part, float* dw,
                             float* db, int n, int f, int n_layers, int n_blocks,
                             void* stream) {
  if (n <= 0 || n_layers <= 0 || n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vpt = (f + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vpt <= 1) return launch_bwd<1>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  if (vpt <= 2) return launch_bwd<2>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  if (vpt <= 4) return launch_bwd<4>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  if (vpt <= 8) return launch_bwd<8>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  if (vpt <= 16) return launch_bwd<16>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  if (vpt <= 32) return launch_bwd<32>(x0, w, resid, g, dx0, part, dw, db, n, f, n_layers, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
