// Pooled multi-hot embedding bags over one concatenated table, forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no multi-hot model. Added for
// DLRM-DCNv2 (models/dlrm.py), whose 26 categorical features each pool a
// bag of ids (1 to 100 of them) from their own table; the tables live
// end to end in one fp32 table [n_rows, d], table t from row bag_offset[t].
//
// Forward: out[e, t, :] = sum_j table[bag_offset[t] + ids[e, bag_start[t] + j], :]
// for every example e and bag t, in one launch. One warp owns one bag: its
// lanes read the bag's ids together, then each id's row is read as float4s
// (lane j holds columns 4j .. 4j + 3, and 128 + 4j .. on wider rows), four
// rows in flight at a time, and summed in the bag's order, each row added
// to the running sum as the plain version adds it, so the two agree bit for
// bit. Bound by memory: a row is 4d bytes read for d adds; the design reads
// each looked-up row once a lookup (the small tables stay in L2) and
// writes each bag once.
//
// Backward with the row-wise Adagrad update (FBGEMM's exact row-wise
// Adagrad): for each row r that the batch looked up,
//     g_r = sum over the lookups of r of the gradient of their bag,
//     G_r += mean_d(g_r^2),  w_r -= lr * g_r / (sqrt(G_r) + eps),
// with no [lookups, d] tensor and no atomics on the rows. The caller sorts
// the lookups' global row ids once (keys, with each lookup's position
// e * s + c in pos). The sorted lookups are cut into chunks of 32; one warp
// owns a chunk (bag_bwd_chunk_kernel) and sums the bag gradients of each
// run of equal keys in sorted order. A run inside its chunk is a whole row:
// the warp updates it at once. A run cut by a chunk edge leaves its pieces
// in `partial` ([n_chunks, 2, d]: slot 0 the piece that continues a run
// from before the chunk, slot 1 the piece that runs on past it), and a
// second launch (bag_bwd_join_kernel) gives each such run to the warp of
// the chunk it starts in, which adds its pieces in order and updates the
// row. A table of 3 rows, hit 65,536 times a step, so spreads each row's sum
// over ~700 warps instead of serialising it on one address. Every row is
// written by one warp and every sum runs in a fixed order: two calls give
// the same bits. Bound by memory: each lookup reads its bag's gradient row
// (4d bytes), each touched row of the table is read and written once, its
// accumulator once. `counter` gains the number of rows updated (the unique
// keys), counted per block and added once a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;   // warps a block
constexpr int CHUNK = 32;  // sorted lookups a warp of the backward owns

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int V>
__global__ void __launch_bounds__(WARPS * 32) bag_fwd_kernel(
    const float4* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ bag_start, const long long* __restrict__ bag_offset,
    const int* __restrict__ bag_rows, float4* __restrict__ out, long long n_bags_total,
    int s, int n_bags, int d4) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_bags_total) return;
  const long long e = w / n_bags;
  const int t = (int)(w - e * n_bags);
  const int c0 = bag_start[t];
  const int h = bag_start[t + 1] - c0;
  const long long off = bag_offset[t];
  const int rows = bag_rows[t];
  const int* id_row = ids + e * s + c0;
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < h; base += 32) {
    const int cnt = min(32, h - base);
    int my = lane < cnt ? id_row[base + lane] : 0;
    my = min(max(my, 0), rows - 1);  // ids outside the table are clamped to it
    for (int k = 0; k < cnt; k += 4) {
      float4 r[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int src = min(k + u, cnt - 1);
        const long long row = off + __shfl_sync(FULL, my, src);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = lane + 32 * v;
          r[u][v] = (k + u < cnt && c < d4) ? __ldg(table + row * d4 + c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u < cnt)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = add4(acc[v], r[u][v]);
    }
  }
  float4* o = out + w * d4;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + 32 * v;
    if (c < d4) o[c] = acc[v];
  }
}

// The row-wise Adagrad update of row `row` with the warp's gradient g.
template <int V>
__device__ __forceinline__ void rowwise_update(float4* __restrict__ table,
                                               float* __restrict__ accum, long long row,
                                               const float4 (&g)[V], int lane, int d4,
                                               float lr, float eps) {
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (lane + 32 * v < d4)
      ss += g[v].x * g[v].x + g[v].y * g[v].y + g[v].z * g[v].z + g[v].w * g[v].w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  const float m = ss / (float)(4 * d4);
  const float acc = accum[row] + m;
  __syncwarp();
  if (lane == 0) accum[row] = acc;
  const float den = sqrtf(acc) + eps;
  float4* w = table + row * d4;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + 32 * v;
    if (c < d4) {
      float4 x = w[c];
      x.x = x.x - lr * g[v].x / den;
      x.y = x.y - lr * g[v].y / den;
      x.z = x.z - lr * g[v].z / den;
      x.w = x.w - lr * g[v].w / den;
      w[c] = x;
    }
  }
}

// Adds each warp's count of updated rows to the block's, then once to
// `counter`. Every thread of the block calls it.
__device__ __forceinline__ void add_count(unsigned* shared, unsigned mine, int lane,
                                          unsigned* counter) {
  if (lane == 0 && mine) atomicAdd(shared, mine);
  __syncthreads();
  if (threadIdx.x == 0 && *shared) atomicAdd(counter, *shared);
}

template <int V>
__global__ void __launch_bounds__(WARPS * 32) bag_bwd_chunk_kernel(
    float4* __restrict__ table, float* __restrict__ accum, const int* __restrict__ keys,
    const long long* __restrict__ pos, const float4* __restrict__ grad,
    const int* __restrict__ col_bag, float4* __restrict__ partial, unsigned* counter,
    long long n, int s, int n_bags, int d4, float lr, float eps) {
  __shared__ unsigned block_rows;
  if (threadIdx.x == 0) block_rows = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long i0 = chunk * CHUNK;
  unsigned rows_done = 0;
  if (i0 < n) {
    const int cnt = (int)min((long long)CHUNK, n - i0);
    const int key = lane < cnt ? keys[i0 + lane] : -1;
    int prev = __shfl_up_sync(FULL, key, 1);
    if (lane == 0) prev = i0 > 0 ? keys[i0 - 1] : -1;
    int next = __shfl_down_sync(FULL, key, 1);
    if (lane == cnt - 1) next = i0 + cnt < n ? keys[i0 + cnt] : -1;
    const unsigned first = __ballot_sync(FULL, lane < cnt && key != prev);
    const unsigned last = __ballot_sync(FULL, lane < cnt && key != next);
    // each lookup's row of the bag gradient [examples * n_bags, d]
    long long bag = 0;
    if (lane < cnt) {
      const long long p = pos[i0 + lane];
      const long long e = p / s;
      bag = e * n_bags + col_bag[p - e * s];
    }
    float4 acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    bool cont = !(first & 1u);  // the chunk's first piece continues a run from before it
    for (int j = 0; j < cnt; j += 4) {
      float4 r[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long b = __shfl_sync(FULL, bag, min(j + u, cnt - 1));
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = lane + 32 * v;
          r[u][v] = (j + u < cnt && c < d4) ? __ldg(grad + b * d4 + c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u;
        if (jj >= cnt) break;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = add4(acc[v], r[u][v]);
        const bool run_end = (last >> jj) & 1u;
        if (run_end || jj == cnt - 1) {
          const int row = __shfl_sync(FULL, key, jj);
          if (run_end && !cont) {
            rowwise_update<V>(table, accum, row, acc, lane, d4, lr, eps);
            ++rows_done;
          } else {
            float4* slot = partial + (chunk * 2 + (cont ? 0 : 1)) * d4;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const int c = lane + 32 * v;
              if (c < d4) slot[c] = acc[v];
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
          cont = false;
        }
      }
    }
  }
  add_count(&block_rows, rows_done, lane, counter);
}

template <int V>
__global__ void __launch_bounds__(WARPS * 32) bag_bwd_join_kernel(
    float4* __restrict__ table, float* __restrict__ accum, const int* __restrict__ keys,
    const float4* __restrict__ partial, unsigned* counter, long long n, long long n_chunks,
    int d4, float lr, float eps) {
  __shared__ unsigned block_rows;
  if (threadIdx.x == 0) block_rows = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long i0 = chunk * CHUNK;
  const long long i1 = i0 + CHUNK;
  unsigned rows_done = 0;
  // a run that starts in this chunk and goes on past its end (the chunk is full)
  if (chunk < n_chunks && i1 < n) {
    const int kk = keys[i1 - 1];
    if (keys[i1] == kk && (i0 == 0 || keys[i0 - 1] != kk)) {
      // the chunk the run ends in: the first after this one whose successor starts elsewhere
      long long c_end = -1;
      for (long long base = chunk + 1; c_end < 0; base += 32) {
        const long long c = base + lane;
        const long long nxt = (c + 1) * CHUNK;
        const bool stop = c < n_chunks && (nxt >= n || keys[nxt] != kk);
        const unsigned m = __ballot_sync(FULL, stop);
        if (m) c_end = base + __ffs(m) - 1;
      }
      float4 acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = lane + 32 * v;
        acc[v] = c < d4 ? partial[(chunk * 2 + 1) * d4 + c] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (long long c0 = chunk + 1; c0 <= c_end; c0 += 4) {
        float4 r[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c = lane + 32 * v;
            r[u][v] = (c0 + u <= c_end && c < d4) ? partial[((c0 + u) * 2) * d4 + c]
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c0 + u <= c_end)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = add4(acc[v], r[u][v]);
      }
      rowwise_update<V>(table, accum, kk, acc, lane, d4, lr, eps);
      rows_done = 1;
    }
  }
  add_count(&block_rows, rows_done, lane, counter);
}

template <typename F>
int by_width(int d4, F&& fn) {
  if (d4 <= 32) return fn(std::integral_constant<int, 1>{});
  if (d4 <= 64) return fn(std::integral_constant<int, 2>{});
  if (d4 <= 128) return fn(std::integral_constant<int, 4>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table [n_rows, d] fp32; ids [b, s] int32, each column's ids local to its
// bag's table; bag_start [n_bags + 1] int32 (the columns of bag t are
// bag_start[t] .. bag_start[t + 1] - 1); bag_offset [n_bags] int64 (table
// t's first row); bag_rows [n_bags] int32 (its rows); out [b, n_bags, d]
// fp32. d % 4 == 0, d <= 512; every pointer 16-byte aligned where it holds
// float4s. Returns the cudaError_t of the launch (0 on success).
extern "C" int embedding_bag_fwd(const float* table, const int* ids, const int* bag_start,
                                 const long long* bag_offset, const int* bag_rows, float* out,
                                 long long b, int s, int n_bags, int d, void* stream) {
  if (d % 4 != 0 || d <= 0 || n_bags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = b * n_bags;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (total + WARPS - 1) / WARPS;
  return by_width(d / 4, [&](auto vv) {
    constexpr int V = decltype(vv)::value;
    bag_fwd_kernel<V><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
        reinterpret_cast<const float4*>(table), ids, bag_start, bag_offset, bag_rows,
        reinterpret_cast<float4*>(out), total, s, n_bags, d / 4);
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward with the row-wise Adagrad update, in place on table [n_rows,
// d] and accum [n_rows] (fp32). keys [n] int32: the lookups' global rows,
// sorted ascending; pos [n] int64: each sorted lookup's position e * s + c
// in the ids; grad [b, n_bags, d] fp32: the bags' gradient; col_bag [s]
// int32: each column's bag; partial: scratch of [ceil(n / 32), 2, d] fp32;
// counter: one uint32 that gains the rows updated. Two launches on the
// stream. Returns the cudaError_t of the launches (0 on success).
extern "C" int embedding_bag_bwd_rowwise_adagrad(float* table, float* accum, const int* keys,
                                                 const long long* pos, const float* grad,
                                                 const int* col_bag, float* partial,
                                                 unsigned* counter, long long n, int s,
                                                 int n_bags, int d, float lr, float eps,
                                                 void* stream) {
  if (d % 4 != 0 || d <= 0 || s <= 0 || n_bags <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long blocks = (n_chunks + WARPS - 1) / WARPS;
  return by_width(d / 4, [&](auto vv) {
    constexpr int V = decltype(vv)::value;
    float4* t4 = reinterpret_cast<float4*>(table);
    float4* p4 = reinterpret_cast<float4*>(partial);
    bag_bwd_chunk_kernel<V><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
        t4, accum, keys, pos, reinterpret_cast<const float4*>(grad), col_bag, p4, counter, n,
        s, n_bags, d / 4, lr, eps);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    bag_bwd_join_kernel<V><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
        t4, accum, keys, p4, counter, n, n_chunks, d / 4, lr, eps);
    return static_cast<int>(cudaGetLastError());
  });
}
