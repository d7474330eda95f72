// Exact top-k of u . v^T for Hopper (sm_90a), fp32, in two kernels.
//
// Replaces: recsys_tpu/ops/pallas/topk_flash.py::_kernel (the TPU kernel
// reached through flash_topk), and the final [Q, 128] -> [Q, k] sort that
// the TPU wrapper leaves to XLA.
//
// Scores Q queries [Q, d] against N items [N, d] and keeps each query's
// best k without ever writing the [Q, N] score matrix (at large N).
//
// What bounds it on the H100: at Q = 4096, N = 1M, operations (2*Q*N*d
// fp32 flops on the FMA units; fp32, not TF32, so selection matches the
// fp32 contract of the plain version). At the served shapes (Q = 1..64,
// N ~ 4k) the products are about a microsecond of work, and what bounds
// the call is how many SMs the grid keeps busy and how fast the final
// selection is. The design is sized for that:
//
// * Stage 1, topk_flash_kernel<TQ, KBUF>: a block owns a tile of TQ query
//   rows (16 or 64: the wrapper's plan takes 16 where Q is small or the
//   grid would be thin, so Q = 1 multiplies 15, not 63, rows of padding)
//   and one chunk of the catalog (blockIdx.x), and writes the top
//   `slots` = min(KBUF, chunk) candidates of each of its rows to
//   [Q, n_chunks, slots]. A chunk no larger than the buffer (KBUF = 0
//   below: slots = chunk) writes its scores directly, with no selection
//   in the block at all; so the plan can cut N = 3,883 into one chunk
//   per 64-item tile (61 chunks, times the query tiles) and the blocks,
//   each ~14 KB of shared memory, spread over the card. A larger chunk
//   sweeps its 64-item tiles keeping a running buffer of KBUF slots per
//   row in shared memory, as PR 1's kernel did: each 64-item tile from a
//   shared-memory tiled product (the depth staged 32 at a time), then one
//   warp per query row inserts the candidates that beat the row's buffer
//   minimum (one ballot per 32 scores gates it; while the buffer fills,
//   the candidates of a ballot append in parallel, each lane at its rank
//   among the set bits; once full, a candidate replaces the minimum only
//   if strictly greater, so the buffer always holds the true top KBUF of
//   what the block has seen). At Q = 4,096 the plan keeps PR 1's 64-row
//   tiles and buffer-sized chunks, so the large shape runs the same code.
// * Stage 2, topk_select_kernel: one block per query row selects the top
//   k of the row's n_chunks * slots candidates (a second launch on the
//   same stream, made by the same host call as the first: at served
//   shapes the host's work per call, not the card's, sets the pace). A
//   radix select on the order-preserving integer image of the fp32
//   score (staged in shared memory once, up to 8,192 candidates a row)
//   finds the k-th largest key in four 8-bit passes
//   (warp-aggregated shared-memory histograms, a suffix scan); an ordered
//   compaction (ballots and per-warp counts, so the same inputs always
//   pick the same candidates) gathers the keys above it and the first of
//   those equal to it; a bitonic sort in shared memory orders the k by
//   (score descending, id ascending). Output [Q, k] fp32 scores and int64
//   ids. Ties at the k boundary may resolve to other equal-scoring ids
//   than the plain version's; ids stay distinct and carry their scores.
// * Items past N are never candidates; slots that stay empty keep score
//   -1e30 and id 0, so k > N yields -1e30 and id 0 past N, as on the TPU.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;        // items per scoring tile
constexpr int BK = 32;        // depth slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads; TQ / 16 rows x 4 items each
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int TQ, int KBUF>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BK * (TQ + 1) + BK * (TB + 1)) +
         (KBUF == 0 ? 0
                    : sizeof(float) * TQ * (TB + 1) +
                          (sizeof(float) + sizeof(int)) * TQ * KBUF +
                          (2 * sizeof(int) + sizeof(float)) * TQ);
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

// acc[a][j] = u[q0 + ty + 16a] . v[t0 + tx + 16j] over the whole depth,
// zero past q_n and past item_end
template <int TQ>
__device__ __forceinline__ void score_tile(const float* __restrict__ u,
                                           const float* __restrict__ v, float* As,
                                           float* Bs, int q0, int q_n, int t0,
                                           int item_end, int d, int tid, int tx, int ty,
                                           float acc[TQ / 16][4]) {
  constexpr int RA = TQ / 16;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
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
      float a[RA], bb[4];
#pragma unroll
      for (int i = 0; i < RA; ++i) a[i] = As[k * (TQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[k * (TB + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

template <int TQ, int KBUF>
__global__ void __launch_bounds__(THREADS) topk_flash_kernel(
    const float* __restrict__ u, const float* __restrict__ v, int q_n, int n,
    int d, int chunk, int n_chunks, int slots, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  constexpr int RA = TQ / 16;
  extern __shared__ float smem[];
  float* As = smem;                  // [BK][TQ + 1]  query slice, transposed
  float* Bs = As + BK * (TQ + 1);    // [BK][TB + 1]  item slice, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.y * TQ;
  const int item_begin = blockIdx.x * chunk;
  const int item_end = min(n, item_begin + chunk);

  if constexpr (KBUF == 0) {
    // the chunk fits its slots: every score goes out as it is
    for (int t0 = item_begin; t0 < item_begin + chunk; t0 += TB) {
      float acc[RA][4];
      score_tile<TQ>(u, v, As, Bs, q0, q_n, t0, item_end, d, tid, tx, ty, acc);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int q = q0 + ty + 16 * a;
        if (q >= q_n) continue;
        const size_t row = (static_cast<size_t>(q) * n_chunks + blockIdx.x) * slots;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int it = t0 + tx + 16 * j;
          const bool real = it < item_end;
          out_s[row + (it - item_begin)] = real ? acc[a][j] : NEG_INF;
          out_i[row + (it - item_begin)] = real ? it : 0;
        }
      }
    }
  } else {
    constexpr int ROWS_PER_WARP = TQ / (THREADS / 32);
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float* S = Bs + BK * (TB + 1);     // [TQ][TB + 1]  score tile
    float* bs = S + TQ * (TB + 1);     // [TQ][KBUF]    candidate scores
    int* bi = reinterpret_cast<int*>(bs + TQ * KBUF);  // [TQ][KBUF] ids
    int* cnt = bi + TQ * KBUF;                         // [TQ] filled slots
    int* minpos = cnt + TQ;                            // [TQ] slot of the min
    float* thr = reinterpret_cast<float*>(minpos + TQ);  // [TQ] min, or -inf

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
      float acc[RA][4];
      score_tile<TQ>(u, v, As, Bs, q0, q_n, t0, item_end, d, tid, tx, ty, acc);
      // S is free: every warp finished the previous tile's selection
      // before it passed the first barrier of this tile's depth loop
#pragma unroll
      for (int i = 0; i < RA; ++i)
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
}

// Set a kernel's dynamic shared-memory limit once per device (the
// attribute belongs to the current device; at served shapes each host
// microsecond of a call counts). `done` is the kernel's own bit set of
// devices; a race sets the attribute twice, which is harmless.
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) done |= bit;
  return e;
}

template <int TQ, int KBUF>
int launch(const float* u, const float* v, int q_n, int n, int d, int chunk,
           int n_chunks, int slots, float* out_s, int* out_i, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<TQ, KBUF>();
  static unsigned long long done = 0;
  const cudaError_t e = smem_limit_once(topk_flash_kernel<TQ, KBUF>, bytes, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_chunks, (q_n + TQ - 1) / TQ);
  topk_flash_kernel<TQ, KBUF><<<grid, THREADS, bytes, stream>>>(
      u, v, q_n, n, d, chunk, n_chunks, slots, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int TQ>
int launch_tq(const float* u, const float* v, int q_n, int n, int d, int kbuf, int chunk,
              int n_chunks, float* out_s, int* out_i, cudaStream_t s) {
  if (chunk <= kbuf)  // the chunk fits its slots: no selection in the block
    return launch<TQ, 0>(u, v, q_n, n, d, chunk, n_chunks, chunk, out_s, out_i, s);
  switch (kbuf) {
    case 32: return launch<TQ, 32>(u, v, q_n, n, d, chunk, n_chunks, 32, out_s, out_i, s);
    case 64: return launch<TQ, 64>(u, v, q_n, n, d, chunk, n_chunks, 64, out_s, out_i, s);
    case 128: return launch<TQ, 128>(u, v, q_n, n, d, chunk, n_chunks, 128, out_s, out_i, s);
    case 256: return launch<TQ, 256>(u, v, q_n, n, d, chunk, n_chunks, 256, out_s, out_i, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- stage 2: the top k of each row's candidates --------------------------

constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_MAX_K = 256;

// order-preserving integer image of an fp32 value (larger float, larger key)
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// rows of at most this many candidates are staged in shared memory once
// (their keys and ids, 8 bytes each) and every pass reads them there
constexpr int SEL_STAGE_MAX = 8192;

template <bool STAGED>
__global__ void __launch_bounds__(SEL_THREADS) topk_select_kernel(
    const float* __restrict__ cand_s, const int* __restrict__ cand_i, int m, int k,
    float* __restrict__ out_s, long long* __restrict__ out_i) {
  extern __shared__ uint32_t staged[];  // STAGED: [m] keys, then [m] ids
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel_key[SEL_MAX_K];
  __shared__ int sel_id[SEL_MAX_K];
  __shared__ int warp_gt[SEL_WARPS], warp_eq[SEL_WARPS];
  __shared__ uint32_t warp_tot[SEL_WARPS];
  __shared__ uint32_t s_prefix;
  __shared__ int s_left;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* rs = cand_s + row * m;
  const int* ri = cand_i + row * m;
  if constexpr (STAGED) {
#pragma unroll 4
    for (int i = tid; i < m; i += SEL_THREADS) {
      staged[i] = key_of(rs[i]);
      staged[m + i] = static_cast<uint32_t>(ri[i]);
    }
    __syncthreads();
  }
  auto key_at = [&](int i) -> uint32_t {
    if constexpr (STAGED) return staged[i];
    else return key_of(rs[i]);
  };
  auto id_at = [&](int i) -> int {
    if constexpr (STAGED) return static_cast<int>(staged[m + i]);
    else return ri[i];
  };
  const int take = min(k, m);
  const bool all = m <= k;  // every candidate is taken
  // after the passes: the k-th largest key, and how many keys equal to
  // it are taken (the rest of the k lie strictly above it)
  uint32_t prefix = 0, mask = 0;
  int left = all ? 0 : take;

  if (!all) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      hist[tid] = 0;
      __syncthreads();
      for (int base = 0; base < m; base += SEL_THREADS) {  // uniform trip count
        const int i = base + tid;
        const uint32_t key = i < m ? key_at(i) : 0u;
        const bool in = i < m && (key & mask) == prefix;
        const uint32_t bin = (key >> shift) & 255u;
        const unsigned act = __ballot_sync(FULL, in);
        if (in) {  // one shared-memory atomic per distinct bin in the warp
          const unsigned peers = __match_any_sync(act, bin);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
        }
      }
      __syncthreads();
      // suffix sums, bin b = tid: number of candidates in bins >= b
      // (within each warp by shuffles, then the later warps' totals)
      uint32_t x = hist[tid];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_down_sync(FULL, x, off);
        if (lane + off < 32) x += y;
      }
      if (lane == 0) warp_tot[warp] = x;
      __syncthreads();
      uint32_t later = 0;
      for (int w = warp + 1; w < SEL_WARPS; ++w) later += warp_tot[w];
      x += later;
      const uint32_t next = __shfl_down_sync(FULL, x, 1);
      const uint32_t above = lane == 31 ? later : next;  // suffix of bin b + 1
      if (x >= static_cast<uint32_t>(left) && above < static_cast<uint32_t>(left)) {
        s_prefix = prefix | (static_cast<uint32_t>(tid) << shift);
        s_left = left - static_cast<int>(above);
      }
      __syncthreads();
      prefix = s_prefix;
      left = s_left;
      mask |= 255u << shift;
    }
  }

  // ordered compaction: keys above the k-th, then the first `left` equal
  // to it, in candidate order. Warp w takes the w-th contiguous segment:
  // it counts its winners, the warps' counts give each segment's offset,
  // and a second sweep writes them.
  const int n_above = take - left;
  const unsigned below_me = (1u << lane) - 1u;
  const int seg = ((m + SEL_WARPS - 1) / SEL_WARPS + 31) / 32 * 32;
  const int lo = min(m, warp * seg), hi = min(m, lo + seg);
  int n_gt = 0, n_eq = 0;
  for (int base = lo; base < hi; base += 32) {  // uniform in the warp
    const int i = base + lane;
    const uint32_t key = i < hi ? key_at(i) : 0u;
    n_gt += __popc(__ballot_sync(FULL, i < hi && (all || key > prefix)));
    n_eq += __popc(__ballot_sync(FULL, i < hi && !all && key == prefix));
  }
  if (lane == 0) {
    warp_gt[warp] = n_gt;
    warp_eq[warp] = n_eq;
  }
  __syncthreads();
  int og = 0, oe = 0;
  for (int w = 0; w < warp; ++w) {
    og += warp_gt[w];
    oe += warp_eq[w];
  }
  for (int base = lo; base < hi && (og < n_above || oe < left); base += 32) {
    const int i = base + lane;
    const uint32_t key = i < hi ? key_at(i) : 0u;
    const bool gt = i < hi && (all || key > prefix);
    const bool eq = i < hi && !all && key == prefix;
    const unsigned bg = __ballot_sync(FULL, gt), be = __ballot_sync(FULL, eq);
    const int g_at = og + __popc(bg & below_me), e_at = oe + __popc(be & below_me);
    if (gt) { sel_key[g_at] = key; sel_id[g_at] = id_at(i); }
    if (eq && e_at < left) { sel_key[n_above + e_at] = key; sel_id[n_above + e_at] = id_at(i); }
    og += __popc(bg);
    oe += __popc(be);
  }
  __syncthreads();

  // bitonic sort of the `take` winners, padded to a power of two (key 0,
  // the largest id), score descending, then id ascending; thread t holds
  // element t in registers, strides below 32 exchange by shuffles
  int kp = 1;
  while (kp < take) kp <<= 1;
  uint32_t my_key = tid < take ? sel_key[tid] : 0u;
  int my_id = tid < take ? sel_id[tid] : 0x7fffffff;
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      uint32_t o_key;
      int o_id;
      if (stride >= 32) {  // block-uniform branch
        __syncthreads();  // the previous exchange's readers are done
        sel_key[tid] = my_key;
        sel_id[tid] = my_id;
        __syncthreads();
        o_key = sel_key[tid ^ stride];
        o_id = sel_id[tid ^ stride];
      } else {
        o_key = __shfl_xor_sync(FULL, my_key, stride);
        o_id = __shfl_xor_sync(FULL, my_id, stride);
      }
      const bool mine_first = my_key > o_key || (my_key == o_key && my_id < o_id);
      // the lower position of a pair holds the first of the two in a
      // descending run (every run at size == kp), the second otherwise
      const bool want_first = (tid < (tid ^ stride)) == ((tid & size) == 0);
      if (mine_first != want_first) {
        my_key = o_key;
        my_id = o_id;
      }
    }
  }
  if (tid < take) {
    out_s[row * k + tid] = float_of(my_key);
    out_i[row * k + tid] = static_cast<long long>(my_id);
  }
  for (int j = take + tid; j < k; j += SEL_THREADS) {
    out_s[row * k + j] = NEG_INF;
    out_i[row * k + j] = 0LL;
  }
}

}  // namespace

namespace {

int launch_stage1(const float* u, const float* v, int q_n, int n, int d, int tq, int kbuf,
                  int chunk, int n_chunks, float* cand_s, int* cand_i, cudaStream_t s) {
  if (chunk <= 0 || chunk % TB != 0 || static_cast<long long>(chunk) * n_chunks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tq) {
    case 16: return launch_tq<16>(u, v, q_n, n, d, kbuf, chunk, n_chunks, cand_s, cand_i, s);
    case 64: return launch_tq<64>(u, v, q_n, n, d, kbuf, chunk, n_chunks, cand_s, cand_i, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_select(const float* cand_s, const int* cand_i, int q_n, int m, int k,
                  float* out_s, long long* out_i, cudaStream_t s) {
  if (m <= 0 || k <= 0 || k > SEL_MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  if (m > SEL_STAGE_MAX) {
    topk_select_kernel<false><<<q_n, SEL_THREADS, 0, s>>>(cand_s, cand_i, m, k, out_s, out_i);
  } else {
    static unsigned long long done = 0;
    const cudaError_t e = smem_limit_once(topk_select_kernel<true>, 8 * SEL_STAGE_MAX, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    topk_select_kernel<true><<<q_n, SEL_THREADS, 8 * m, s>>>(cand_s, cand_i, m, k, out_s,
                                                             out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both stages, one call from the host: u [q_n, d], v [n, d] fp32
// contiguous; the candidates cand_s / cand_i [q_n, n_chunks, slots]
// (fp32 / int32 scratch), slots = chunk if chunk <= kbuf, else kbuf; out
// out_s [q_n, k] fp32 and out_i [q_n, k] int64, descending. tq in {16,
// 64}; kbuf in {32, 64, 128, 256}, k <= kbuf; chunk a multiple of 64 with
// n_chunks * chunk >= n. Returns the first cudaError_t of the launches.
extern "C" int topk_flash(const float* u, const float* v, int q_n, int n, int d, int tq,
                          int kbuf, int chunk, int n_chunks, int k, float* cand_s,
                          int* cand_i, float* out_s, long long* out_i, void* stream) {
  if (q_n <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_stage1(u, v, q_n, n, d, tq, kbuf, chunk, n_chunks, cand_s, cand_i, s);
  if (err != 0) return err;
  const int slots = chunk <= kbuf ? chunk : kbuf;
  return launch_select(cand_s, cand_i, q_n, n_chunks * slots, k, out_s, out_i, s);
}

// cand_s [q_n, m] fp32, cand_i [q_n, m] int32 contiguous; out_s [q_n, k]
// fp32 and out_i [q_n, k] int64, descending; 1 <= k <= 256. Rows with
// fewer than k candidates pad with -1e30 and id 0. Returns the
// cudaError_t of the launch.
extern "C" int topk_select(const float* cand_s, const int* cand_i, int q_n, int m, int k,
                           float* out_s, long long* out_i, void* stream) {
  if (q_n <= 0) return 0;
  return launch_select(cand_s, cand_i, q_n, m, k, out_s, out_i,
                       static_cast<cudaStream_t>(stream));
}
