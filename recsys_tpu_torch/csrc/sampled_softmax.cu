// The sampled softmax of HSTU's and MLA-MoE's loss for Hopper (sm_90a): kernel row 13.
// No TPU kernel corresponds: the JAX package has no sequential model; these
// serve models/losses.py::sampled_softmax.
//
// Rows q [M, D] fp32 each meet K1 = K + 1 rows of an item table [R, D] fp32,
// ids [M, K1] int32: K sampled negatives, then the row's positive. The
// logits are l_ik = q_i . table[ids_ik] * inv_t, -inf where k < K and
// ids_ik == ids_iK (a negative equal to the positive). Given the logits'
// gradient G [M, K1] (already times inv_t), the backward is two products of
// the sparse matrix of G's entries: dq_i = sum_k G_ik table[ids_ik] and
// dtable_j = sum_{(i, k): ids_ik = j} G_ik q_i, the second through the
// entries sorted by id (a stable sort, made by the caller) in runs of at
// most SS_RUN entries of one item (a popular positive's thousands of
// entries split over warps), the runs' sums then added item by item, so
// that every sum runs in a fixed order: two calls give the same bits.
//
// Design: the three kernels read rows of D fp32 values, which no tile or
// tensor core helps with (each of ~M K1 products reads a row of the table
// once); they are bound by those reads (M K1 D 4 bytes each: ~24 GB at the
// HSTU cell's ~180k rows, K = 128, D = 256). A warp takes a row of q (the
// logits and dq) or a run of entries (dtable), a lane D / 32 values of each
// row it reads in 16-byte loads; a dot product is summed lane-wise, then
// across the warp by xor shuffles.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SS_WARPS = 8;     // warps a block
constexpr int SS_RUN = 256;     // entries of dtable's run: a popular item's entries split
constexpr unsigned SS_FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(SS_FULL, x, o);
  return x;
}

template <int V>
__device__ __forceinline__ float dot_row(const float4 (&a)[V], const float* row, int lane) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 b = __ldg(r + lane + 32 * v);
    acc += (a[v].x * b.x + a[v].y * b.y) + (a[v].z * b.z + a[v].w * b.w);
  }
  return warp_sum(acc);
}

// logits [M, K1]; a warp a row
template <int V>
__global__ void __launch_bounds__(SS_WARPS * 32) sampled_logits_kernel(
    const float* __restrict__ q, const float* __restrict__ table, const int* __restrict__ ids,
    int m, int k1, float inv_t, float* __restrict__ logits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * SS_WARPS + warp;
  if (i >= m) return;
  constexpr int D = 128 * V;
  float4 a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = reinterpret_cast<const float4*>(q + i * D)[lane + 32 * v];
  const int* row_ids = ids + i * k1;
  const int pos = row_ids[k1 - 1];
#pragma unroll 4
  for (int k = 0; k < k1; ++k) {
    const int id = row_ids[k];
    const float x = dot_row<V>(a, table + static_cast<long long>(id) * D, lane) * inv_t;
    if (lane == 0) logits[i * k1 + k] = (k < k1 - 1 && id == pos) ? -CUDART_INF_F : x;
  }
}

// dq [M, D] = sum_k G_ik table[ids_ik]; a warp a row
template <int V>
__global__ void __launch_bounds__(SS_WARPS * 32) sampled_dq_kernel(
    const float* __restrict__ g, const float* __restrict__ table, const int* __restrict__ ids,
    int m, int k1, float* __restrict__ dq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * SS_WARPS + warp;
  if (i >= m) return;
  constexpr int D = 128 * V;
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < k1; ++k) {
    const float w = g[i * k1 + k];
    const float4* r =
        reinterpret_cast<const float4*>(table + static_cast<long long>(ids[i * k1 + k]) * D);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 b = __ldg(r + lane + 32 * v);
      acc[v].x += w * b.x;
      acc[v].y += w * b.y;
      acc[v].z += w * b.z;
      acc[v].w += w * b.w;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) reinterpret_cast<float4*>(dq + i * D)[lane + 32 * v] = acc[v];
}

// dtable's partial sums: run s of at most SS_RUN entries of item
// sub_item[s], from entry sub_begin[s] (order: flat indices i K1 + k sorted
// by id, stable; seg[j]: item j's first entry), sum G_ik q_i -> part[s];
// a warp a run (sub_item < 0: none)
template <int V>
__global__ void __launch_bounds__(SS_WARPS * 32) sampled_dtable_part_kernel(
    const float* __restrict__ g, const float* __restrict__ q, const int* __restrict__ order,
    const long long* __restrict__ seg, const int* __restrict__ sub_item,
    const long long* __restrict__ sub_begin, int n_sub, int k1, float* __restrict__ part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * SS_WARPS + warp;
  if (s >= n_sub) return;
  const int j = sub_item[s];
  if (j < 0) return;
  constexpr int D = 128 * V;
  const long long p0 = sub_begin[s], p1 = min(p0 + SS_RUN, seg[j + 1]);
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (long long p = p0; p < p1; ++p) {
    const int f = order[p];
    const float w = g[f];
    const float4* row = reinterpret_cast<const float4*>(q + static_cast<long long>(f / k1) * D);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 b = __ldg(row + lane + 32 * v);
      acc[v].x += w * b.x;
      acc[v].y += w * b.y;
      acc[v].z += w * b.z;
      acc[v].w += w * b.w;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) reinterpret_cast<float4*>(part + s * D)[lane + 32 * v] = acc[v];
}

// dtable [R, D]: item j's runs sub_first[j] .. sub_first[j] + n_runs[j]
// added in order (no run: a zero row); a warp an item
template <int V>
__global__ void __launch_bounds__(SS_WARPS * 32) sampled_dtable_sum_kernel(
    const float* __restrict__ part, const long long* __restrict__ sub_first,
    const long long* __restrict__ n_runs, int r, float* __restrict__ dtable) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j = static_cast<long long>(blockIdx.x) * SS_WARPS + warp;
  if (j >= r) return;
  constexpr int D = 128 * V;
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long s = sub_first[j], e = s + n_runs[j]; s < e; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 b = reinterpret_cast<const float4*>(part + s * D)[lane + 32 * v];
      acc[v].x += b.x;
      acc[v].y += b.y;
      acc[v].z += b.z;
      acc[v].w += b.w;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) reinterpret_cast<float4*>(dtable + j * D)[lane + 32 * v] = acc[v];
}

// f(std::integral_constant<int, V>{}) for D = 128 V
template <typename F>
int by_rows(int d, F&& f) {
  if (d == 128) return f(std::integral_constant<int, 1>{});
  if (d == 256) return f(std::integral_constant<int, 2>{});
  if (d == 384) return f(std::integral_constant<int, 3>{});
  if (d == 512) return f(std::integral_constant<int, 4>{});
  if (d == 2048) return f(std::integral_constant<int, 16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + SS_WARPS - 1) / SS_WARPS); }

}  // namespace

// All contiguous, on the stream's device, rows on 16 bytes; d one of 128,
// 256, 384, 512, 2048; every id in [0, r). Each returns the cudaError_t of its
// launch.
extern "C" int sampled_softmax_logits(const float* q, const float* table, const int* ids, int m,
                                      int k1, int d, float inv_t, float* logits, void* stream) {
  if (m <= 0) return 0;
  return by_rows(d, [&](auto v) {
    constexpr int V = decltype(v)::value;
    sampled_logits_kernel<V><<<blocks(m), SS_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        q, table, ids, m, k1, inv_t, logits);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int sampled_softmax_dq(const float* g, const float* table, const int* ids, int m,
                                  int k1, int d, float* dq, void* stream) {
  if (m <= 0) return 0;
  return by_rows(d, [&](auto v) {
    constexpr int V = decltype(v)::value;
    sampled_dq_kernel<V><<<blocks(m), SS_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        g, table, ids, m, k1, dq);
    return static_cast<int>(cudaGetLastError());
  });
}

// dtable through runs of at most SS_RUN entries: sub_item [n_sub] int32
// (-1: no run), sub_begin [n_sub] int64, sub_first and n_runs [r] int64
// (item j's first run and its count), part [n_sub, d] fp32 scratch.
extern "C" int sampled_softmax_dtable(const float* g, const float* q, const int* order,
                                      const long long* seg, const int* sub_item,
                                      const long long* sub_begin, int n_sub,
                                      const long long* sub_first, const long long* n_runs, int r,
                                      int k1, int d, float* part, float* dtable, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_rows(d, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (n_sub > 0) {
      sampled_dtable_part_kernel<V><<<blocks(n_sub), SS_WARPS * 32, 0, st>>>(
          g, q, order, seg, sub_item, sub_begin, n_sub, k1, part);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    sampled_dtable_sum_kernel<V><<<blocks(r), SS_WARPS * 32, 0, st>>>(part, sub_first, n_runs,
                                                                       r, dtable);
    return static_cast<int>(cudaGetLastError());
  });
}
