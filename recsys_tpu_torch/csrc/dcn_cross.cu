// Fused DCN cross stack, forward, for Hopper (sm_90a).
//
// Replaces: recsys_tpu/ops/pallas/dcn_cross.py::_fwd_kernel (the TPU
// kernel reached through dcn_cross_fused -> _call_fwd).
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
// The optional `resid` output ([L, n, F], each layer's input x_l) is for
// the backward pass of the training slice; inference passes null.
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
