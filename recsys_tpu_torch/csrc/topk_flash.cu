// Exact running top-k of u . v^T for Hopper (sm_90a), fp32.
//
// Replaces: recsys_tpu/ops/pallas/topk_flash.py::_kernel (the TPU kernel
// reached through flash_topk).
//
// Scores Q queries [Q, d] against N items [N, d] and keeps each query's
// best KBUF candidates without ever writing the [Q, N] score matrix.
//
// What bounds it on the H100: operations. Scoring is 2*Q*N*d fp32 flops
// on the FMA units (fp32, not TF32, so selection matches the fp32
// contract of the plain version), against Q*d + N*d floats read. At
// Q = 4096, N = 1M it is ~1 TFLOP. At serving shapes (Q = 1..64,
// N ~ 4k) the work is tiny and what bounds this design is its small
// grid: with KBUF = 256 a chunk holds at least 256 items, so N ~ 4k
// gives 16 blocks at one block per SM (shared memory), and at Q = 1
// the 64-row query tile multiplies zero padding in 63 of 64 rows.
// There it is slower than a dense product + torch.topk (PERF.md).
//
// Design, and how it departs from the TPU kernel:
// * The TPU grid walks item blocks in order and carries its candidate
//   buffer across grid steps. CUDA blocks run in no order, so each block
//   owns one chunk of the catalog and a loop inside the block sweeps the
//   chunk's 64-item tiles, carrying the buffer in shared memory.
// * A served request has Q = 1: one block per query tile would leave
//   the other SMs idle. So the catalog is split into chunks across
//   blocks (blockIdx.x), each block writes its buffer to
//   [Q, n_chunks, KBUF], and the final selection over those buffers is
//   a small top-k outside the kernel (as the TPU wrapper leaves its final
//   [Q, 128] -> [Q, k] sort to XLA).
// * Each 64 x 64 score tile comes from a plain shared-memory tiled
//   product (a 4 x 4 register tile per thread, the depth staged 32 at a
//   time), written to shared memory; then one warp per query row
//   inserts the candidates that beat the row's buffer minimum. The gate
//   (one ballot per 32 scores) skips the insertion when none does, so
//   after the buffers fill, most tiles cost the product and one pass.
// * KBUF is k rounded up to a power of two, 32 to 256, not the TPU's
//   lane width of 128: the documented two-stage setting retrieves 200
//   candidates. While a buffer is not full, the candidates of a ballot
//   are appended in parallel, each lane at its rank among the set bits;
//   once full, a candidate replaces the buffer minimum only if strictly
//   greater, one at a time. An evicted minimum is dominated by
//   KBUF >= k others, so the buffer always holds the true top-k of what
//   the block has seen.
// * Items past N are never candidates; slots that stay empty keep score
//   -1e30 and id 0, so k > N yields -1e30 past N, as on the TPU.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TB = 64;        // items per scoring tile
constexpr int BK = 32;        // depth slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int ROWS_PER_WARP = TQ / (THREADS / 32);
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int KBUF>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BK * (TQ + 1) + BK * (TB + 1) + TQ * (TB + 1)) +
         (sizeof(float) + sizeof(int)) * TQ * KBUF +
         (2 * sizeof(int) + sizeof(float)) * TQ;
}

// Buffer minimum of one row: (value, lowest slot holding it), the same
// on every lane of the warp.
template <int KBUF>
__device__ __forceinline__ void row_min(const float* rs, int lane, float& th, int& mp) {
  float mv = CUDART_INF_F;
  int ms = KBUF;
#pragma unroll
  for (int j = 0; j < KBUF / 32; ++j) {
    const int s = lane + 32 * j;
    const float x = rs[s];
    if (x < mv) { mv = x; ms = s; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, mv, off);
    const int os = __shfl_xor_sync(FULL, ms, off);
    if (ov < mv || (ov == mv && os < ms)) { mv = ov; ms = os; }
  }
  th = mv;
  mp = ms;
}

template <int KBUF>
__global__ void __launch_bounds__(THREADS) topk_flash_kernel(
    const float* __restrict__ u, const float* __restrict__ v, int q_n, int n,
    int d, int chunk, int n_chunks, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* As = smem;                  // [BK][TQ + 1]  query slice, transposed
  float* Bs = As + BK * (TQ + 1);    // [BK][TB + 1]  item slice, transposed
  float* S = Bs + BK * (TB + 1);     // [TQ][TB + 1]  score tile
  float* bs = S + TQ * (TB + 1);     // [TQ][KBUF]    candidate scores
  int* bi = reinterpret_cast<int*>(bs + TQ * KBUF);  // [TQ][KBUF] ids
  int* cnt = bi + TQ * KBUF;                         // [TQ] filled slots
  int* minpos = cnt + TQ;                            // [TQ] slot of the min
  float* thr = reinterpret_cast<float*>(minpos + TQ);  // [TQ] min, or -inf

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.y * TQ;
  const int item_begin = blockIdx.x * chunk;
  const int item_end = min(n, item_begin + chunk);

  for (int i = tid; i < TQ * KBUF; i += THREADS) {
    bs[i] = NEG_INF;
    bi[i] = 0;
  }
  if (tid < TQ) {
    cnt[tid] = 0;
    minpos[tid] = 0;
    thr[tid] = -CUDART_INF_F;
  }

  for (int t0 = item_begin; t0 < item_end; t0 += TB) {
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
        As[k * (TQ + 1) + r] =
            (q < q_n && dd < d) ? u[static_cast<long long>(q) * d + dd] : 0.f;
      }
      for (int e = tid; e < TB * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int it = t0 + r, dd = d0 + k;
        Bs[k * (TB + 1) + r] =
            (it < item_end && dd < d) ? v[static_cast<long long>(it) * d + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k * (TQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[k * (TB + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    // S is free: every warp finished the previous tile's selection
    // before it passed the first barrier of this tile's depth loop
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = acc[i][j];
    __syncthreads();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (q0 + r >= q_n) break;  // warp-uniform
      float* rs = bs + r * KBUF;
      int* ri = bi + r * KBUF;
      float th = thr[r];
      int ct = cnt[r];
      int mp = minpos[r];
#pragma unroll
      for (int h = 0; h < TB / 32; ++h) {
        const int col = h * 32 + lane;
        const float sc = S[r * (TB + 1) + col];
        // warp-uniform from here: every lane holds the same mask
        unsigned m = __ballot_sync(FULL, t0 + col < item_end && sc > th);
        if (m != 0 && ct < KBUF) {
          // filling: the first `take` candidates append in parallel, each
          // lane at its rank among the set bits
          const int take = min(KBUF - ct, __popc(m));
          const int rank = __popc(m & ((1u << lane) - 1u));
          if (((m >> lane) & 1u) && rank < take) {
            rs[ct + rank] = sc;
            ri[ct + rank] = t0 + col;
          }
          for (int t = 0; t < take; ++t) m &= m - 1;  // drop the appended bits
          ct += take;
          if (ct == KBUF) {
            __syncwarp();
            row_min<KBUF>(rs, lane, th, mp);
          }
        }
        while (m) {  // the buffer is full: replace its minimum, one by one
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cs = __shfl_sync(FULL, sc, src);
          const int cid = t0 + h * 32 + src;
          if (cs > th) {
            if (lane == 0) { rs[mp] = cs; ri[mp] = cid; }
            __syncwarp();
            row_min<KBUF>(rs, lane, th, mp);
          }
        }
      }
      __syncwarp();
      if (lane == 0) { thr[r] = th; cnt[r] = ct; minpos[r] = mp; }
    }
  }
  __syncthreads();

  for (int e = tid; e < TQ * KBUF; e += THREADS) {
    const int r = e / KBUF, s = e % KBUF;
    const int q = q0 + r;
    if (q < q_n) {
      const size_t o = (static_cast<size_t>(q) * n_chunks + blockIdx.x) * KBUF + s;
      out_s[o] = bs[e];
      out_i[o] = bi[e];
    }
  }
}

template <int KBUF>
int launch(const float* u, const float* v, int q_n, int n, int d, int chunk,
           int n_chunks, float* out_s, int* out_i, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<KBUF>();
  // the attribute belongs to the current device: set it on every launch
  // (a host-side call of about a microsecond) so that any device works
  const cudaError_t e = cudaFuncSetAttribute(
      topk_flash_kernel<KBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_chunks, (q_n + TQ - 1) / TQ);
  topk_flash_kernel<KBUF><<<grid, THREADS, bytes, stream>>>(
      u, v, q_n, n, d, chunk, n_chunks, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u [q_n, d], v [n, d] fp32 contiguous; out_s / out_i [q_n, n_chunks, kbuf]
// (fp32 / int32). kbuf in {32, 64, 128, 256}; chunk a multiple of 64 with
// n_chunks * chunk >= n. Returns the cudaError_t of the launch.
extern "C" int topk_flash(const float* u, const float* v, int q_n, int n, int d,
                          int kbuf, int chunk, int n_chunks, float* out_s,
                          int* out_i, void* stream) {
  if (q_n <= 0 || n <= 0) return 0;
  if (chunk <= 0 || chunk % TB != 0 || static_cast<long long>(chunk) * n_chunks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kbuf) {
    case 32: return launch<32>(u, v, q_n, n, d, chunk, n_chunks, out_s, out_i, s);
    case 64: return launch<64>(u, v, q_n, n, d, chunk, n_chunks, out_s, out_i, s);
    case 128: return launch<128>(u, v, q_n, n, d, chunk, n_chunks, out_s, out_i, s);
    case 256: return launch<256>(u, v, q_n, n, d, chunk, n_chunks, out_s, out_i, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
