// Level-histogram and routing kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of spark_ensemble_tpu/ops/pallas_hist.py:
//   _hist_kernel  (hist_precision="pallas"): level histogram over i32 bins,
//                 statistics split into bf16 hi + lo;
//   _fused_kernel (hist="fused"): unpack 4/8-bit lane-major packed bins,
//                 route rows through the previous level's split tables, then
//                 the level histogram with a 3-term bf16 split, or exact f32
//                 leaf sums in leaf mode.
//
// What they compute.  H[m, p, c, f, b] = sum over rows r with node[r, m] == p
// and bin[r, f] == b of term(vals[r, m, c]), where term() is the TPU kernel's
// per-row split: hi = bf16(v), lo = bf16(v - hi) (and lo2 = bf16(v - hi - lo)
// for the fused tier), summed in f32.  The TPU builds this as a one-hot matmul
// because that is how its matrix unit makes a histogram; here the histogram
// is written directly, so each row adds its term to one cell per feature.
//
// The level histogram (level_hist, both tiers).  i32 bins are read as
// words of 32 bits, one feature per word, so one kernel serves both tiers.
// - One CTA per (member group, feature tile, node tile, row chunk) keeps its
//   whole output tile in shared memory.  Its rows' node ids, statistics and
//   bin words are staged once per CTA with cp.async, three tiles of R rows
//   in flight, and every warp reads them from there.  The thread that copied
//   a statistic also splits it into its bf16 terms, once per (row, member).
// - One warp is the only writer of the cells of one (member, feature).  Its
//   lanes take 32 consecutive rows.  To find lanes that share a cell (key =
//   node * B + bin), each lane writes its lane id into a per-warp byte tag of
//   its key and reads the tag back: all lanes of a key read the same id, so
//   a lane that reads another's id shares its cell.  Without such a lane
//   (the common case at deep levels) every lane adds its term to its cell.
//   Otherwise five ballots over the tag give each lane its group, and the
//   lowest lane adds the group's terms, in lane (= row) order, fetched by
//   shuffles.  No atomics; the order is fixed by the shapes and the data.
//   (__match_any_sync finds the same groups, but its cost grows with the
//   number of distinct keys in the warp, and on this card it took most of
//   a step.)
// - The row chunks of one output tile are the CTAs of one thread-block
//   cluster (at most 8).  At the end, CTA rank k reads its 1/size slice of
//   the tile from every peer's shared memory in rank order (distributed
//   shared memory) and writes it to the output once: no scratch buffer and
//   no second launch.  Two launches give the same bits.
// - The plan (ops/hist_kernels.py::level_plan, a function of the shapes)
//   gives a warp every node of the level unless its cells pass 16 KB (then
//   it tiles nodes), gives a CTA as many features (and, for narrow d,
//   members) as fit 128 KB, and picks the largest cluster size that lets every
//   tile's cluster run in one wave.
//
// What bounds it.  At letter scale one level reads ~5.6 MB and writes at
// most 3.4 MB: ~3 us at 3.35 TB/s.  The kernel is bound instead by the SM's
// shared-memory pipe.  A step of 32 (row, member, feature) updates makes
// about 15 shared-memory accesses (node, bin, tag write and read, two terms,
// two cells read and written, shuffles on conflicts), and random cells and
// tags conflict on banks about 3-way, so it takes ~30 wavefronts (a count
// from the access pattern); staging gathers node ids and statistics at a
// stride of M (one wavefront per value).
//
// Why not the tensor cores: the one-hot product the TPU runs on its matrix
// unit costs 2 * n * M * (nodes * C * terms) * (d * B) flops, ~77 GFLOP at
// the fused tier's deepest letter level: ~80 us at the full bf16 rate, 30x
// the byte bound and no better than a direct histogram.  Why not Triton: it
// has no shared-memory scatter short of float atomics, which would break the
// fixed summation order.
//
// Leaf sums (hist_accumulate<kSrcNone, 1>): one CTA per (member, node tile,
// row chunk); thread L is the only writer of the nodes congruent to L mod K
// and adds its rows in ascending row order; row chunks go to scratch and a
// second grid sums them in chunk order.
//
// Routing (fused tier) is a separate, one-thread-per-(row, member) launch:
// node_out = 2 * node + 1 - (bin[r, best_f[m, node]] <= best_t[m, node]),
// unpacking only the word that holds best_f.  It runs once per row, not once
// per output tile, and is integer-exact.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 128;  // rows staged in shared memory per step
constexpr int kMaskRows = 32;   // rows per ownership mask

enum BinSource { kSrcI32 = 0, kSrcPacked = 1, kSrcNone = 2 };

// The TPU kernels' per-row statistic split, summed in f32.  NTERMS == 1 is
// the plain f32 value (leaf sums).
template <int NTERMS>
__device__ __forceinline__ float split_terms(float v) {
  if (NTERMS == 1) return v;
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  const float l = __bfloat162float(__float2bfloat16_rn(v - h));
  if (NTERMS == 2) return h + l;
  const float l2 = __bfloat162float(__float2bfloat16_rn(v - h - l));
  return h + l + l2;
}

// Bin of feature f from lane-major packed words: word f % W, lane f / W.
__device__ __forceinline__ int unpack_bin(const int32_t* __restrict__ packed,
                                          long long r, int W, int bits,
                                          int f) {
  const uint32_t word = static_cast<uint32_t>(packed[r * W + (f % W)]);
  if (bits >= 32) return static_cast<int>(word);
  return static_cast<int>((word >> ((f / W) * bits)) & ((1u << bits) - 1u));
}

template <int SRC, int NTERMS>
__global__ void hist_accumulate(const int32_t* __restrict__ bins,
                                const int32_t* __restrict__ node,
                                const float* __restrict__ vals,
                                float* __restrict__ dst, int n, int d, int M,
                                int C, int B, int n_nodes, int W, int bits,
                                int nf, int np, int K, int rows_per_chunk) {
  extern __shared__ float smem[];
  const int n_ft = (d + nf - 1) / nf;
  const int n_pt = (n_nodes + np - 1) / np;
  int bx = blockIdx.x;
  const int pt = bx % n_pt;
  bx /= n_pt;
  const int ft = bx % n_ft;
  const int m = bx / n_ft;
  const int chunk = blockIdx.y;
  const int p0 = pt * np, f0 = ft * nf;
  const int np_t = min(np, n_nodes - p0), nf_t = min(nf, d - f0);
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);

  // shared layout: hist [np][C][nf][B] | node [R] | term [R][C] | bin [R][nf]
  float* hist = smem;
  int* node_s = reinterpret_cast<int*>(smem + np * C * nf * B);
  float* term_s = reinterpret_cast<float*>(node_s + kTileRows);
  int* bin_s = reinterpret_cast<int*>(term_s + kTileRows * C);

  const int tid = threadIdx.x;
  const int hist_cells = np_t * C * nf_t * B;
  for (int i = tid; i < hist_cells; i += blockDim.x) hist[i] = 0.f;

  const int fl = tid / K, L = tid % K;
  const bool active = fl < nf_t;
  const int cstride = nf_t * B;

  for (int r0 = r_begin; r0 < r_end; r0 += kTileRows) {
    const int rows = min(kTileRows, r_end - r0);
    __syncthreads();  // the previous tile is consumed; hist is zeroed
    for (int i = tid; i < rows; i += blockDim.x) {
      const long long rm = static_cast<long long>(r0 + i) * M + m;
      node_s[i] = node[rm];
      for (int c = 0; c < C; ++c) {
        term_s[i * C + c] = split_terms<NTERMS>(vals[rm * C + c]);
      }
    }
    if (SRC != kSrcNone) {
      for (int i = tid; i < rows * nf_t; i += blockDim.x) {
        const long long r = r0 + i / nf_t;
        const int f = f0 + i % nf_t;
        bin_s[i] = SRC == kSrcI32 ? bins[r * d + f]
                                  : unpack_bin(bins, r, W, bits, f);
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < rows; j0 += kMaskRows) {
      const int jn = min(kMaskRows, rows - j0);
      unsigned mask = 0u;
      for (int j = 0; j < jn; ++j) {
        const int p = node_s[j0 + j] - p0;
        const int b = SRC == kSrcNone ? 0 : bin_s[(j0 + j) * nf_t + fl];
        const bool mine = static_cast<unsigned>(p) <
                              static_cast<unsigned>(np_t) &&
                          ((p * B + b) & (K - 1)) == L;
        mask |= static_cast<unsigned>(mine) << j;
      }
      while (mask) {  // this thread's rows, ascending
        const int jj = j0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        const int p = node_s[jj] - p0;
        const int b = SRC == kSrcNone ? 0 : bin_s[jj * nf_t + fl];
        float* cell = hist + (p * C * nf_t + fl) * B + b;
        for (int c = 0; c < C; ++c) cell[c * cstride] += term_s[jj * C + c];
      }
    }
  }
  __syncthreads();
  float* out = dst + static_cast<size_t>(chunk) * M * n_nodes * C * d * B;
  for (int i = tid; i < hist_cells; i += blockDim.x) {
    const int b = i % B;
    int t = i / B;
    const int f = t % nf_t;
    t /= nf_t;
    const int c = t % C;
    const int p = t / C;
    out[((((static_cast<size_t>(m) * n_nodes + p0 + p) * C + c) * d + f0 + f) *
         B) +
        b] = hist[i];
  }
}

// Fixed-order split-K reduce: out[i] = chunk 0 + chunk 1 + ... (in order).
__global__ void reduce_chunks(const float* __restrict__ scratch,
                              float* __restrict__ out, long long total,
                              int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = scratch[i];
    for (int k = 1; k < chunks; ++k) s += scratch[k * total + i];
    out[i] = s;
  }
}

__global__ void route_packed(const int32_t* __restrict__ packed,
                             const int32_t* __restrict__ node_in,
                             const int32_t* __restrict__ best_f,
                             const int32_t* __restrict__ best_t,
                             int32_t* __restrict__ node_out, int n, int M,
                             int half, int W, int bits) {
  const long long total = static_cast<long long>(n) * M;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / M;
    const int m = static_cast<int>(i % M);
    const int p = node_in[i];
    const int f = best_f[m * half + p];
    const int t = best_t[m * half + p];
    const int b = unpack_bin(packed, r, W, bits, f);
    node_out[i] = 2 * p + 1 - (b <= t ? 1 : 0);
  }
}

constexpr int kMaxCluster = 8;
constexpr int kMaxLevelThreads = 512;
constexpr int kLevelStages = 3;  // row tiles in flight: one split, two landing
constexpr long long kMaxSmem = 232448;  // 227 KB, the most one CTA may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's walk over the elements e = q * R + r of a [Q][R] staging array
// in steps of blockDim.x, without a division inside the loop.
struct Walk {
  int q, r, dq, dr;
};

__device__ __forceinline__ void walk_next(Walk& w, int R) {
  w.q += w.dq;
  w.r += w.dr;
  if (w.r >= R) {
    w.r -= R;
    ++w.q;
  }
}

// Level histogram over words [n, W] (packed bins, or i32 bins as W = d words
// of 32 bits).  Grid: (member group, feature tile, node tile) x cluster of
// row chunks.  Shared layout: hist [g][nf][np][C][B] | kLevelStages x stage
// | tags, a stage being words [S][R] | node [g][R] | terms [g][C][R] for R
// rows and S word slots, tags one byte per (warp, node, bin), rounded up to
// 4 bytes per warp.  At most 64 registers a thread, so that two CTAs of 512
// threads share an SM.
template <int NTERMS>
__global__ void __launch_bounds__(kMaxLevelThreads, 2)
    level_hist(const int32_t* __restrict__ words,
               const int32_t* __restrict__ node,
               const float* __restrict__ vals, float* __restrict__ out, int n,
               int d, int M, int C, int B, int n_nodes, int W, int bits, int g,
               int nf, int np, int R, int rows_per_chunk) {
  extern __shared__ __align__(16) float lsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_pt = (n_nodes + np - 1) / np;
  const int n_ft = (d + nf - 1) / nf;
  int t = blockIdx.x / cs;
  const int pt = t % n_pt;
  t /= n_pt;
  const int ft = t % n_ft;
  const int mt = t / n_ft;
  const int m0 = mt * g, f0 = ft * nf, p0 = pt * np;
  const int g_t = min(g, M - m0), nf_t = min(nf, d - f0);
  const int np_t = min(np, n_nodes - p0);
  const int r_begin = min(n, rank * rows_per_chunk);
  const int r_end = min(n, r_begin + rows_per_chunk);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // Which words a stage holds: one per feature of the tile (i32 bins, or
  // packed rows wider than the tile), or else every word of the row once.
  const bool word_per_feature = bits >= 32 || W > nf;
  const int slot_cap = word_per_feature ? nf : W;
  const int n_slots = word_per_feature ? nf_t : W;
  const int gc = g_t * C;

  float* hist = lsmem;
  const int hist_cells = g * nf * np * C * B;
  const int stage_words = R * (slot_cap + g + g * C);
  int* stages = reinterpret_cast<int*>(lsmem + hist_cells);
  const int tag_bytes = (np * B + 3) & ~3;
  unsigned char* tags =
      reinterpret_cast<unsigned char*>(stages + kLevelStages * stage_words);
  for (int i = tid; i < hist_cells / 4; i += nthreads) {
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = hist_cells / 4 * 4 + tid; i < hist_cells; i += nthreads) {
    hist[i] = 0.f;
  }

  const Walk w0 = {tid / R, tid % R, nthreads / R, nthreads % R};
  auto stage_at = [&](int buf, int** sw, int** sn, float** sv) {
    *sw = stages + buf * stage_words;
    *sn = *sw + R * slot_cap;
    *sv = reinterpret_cast<float*>(*sn + R * g);
  };
  // Copies row tile `tile` into its stage as one copy group, each element by
  // the same thread on every tile, so that the thread that copied a value
  // also splits it, after its own wait.  Past the last tile the group is
  // empty, which keeps the group count the same on every thread.
  const int n_tiles = (r_end - r_begin + R - 1) / R;
  auto issue = [&](int tile) {
    const int r0 = r_begin + tile * R;
    const int rows = tile < n_tiles ? min(R, r_end - r0) : 0;
    int *sw, *sn;
    float* sv;
    stage_at(tile % kLevelStages, &sw, &sn, &sv);
    for (Walk w = w0; rows > 0 && w.q < n_slots; walk_next(w, R)) {
      if (w.r >= rows) continue;
      const int wd = !word_per_feature ? w.q
                     : bits >= 32      ? f0 + w.q
                                       : (f0 + w.q) % W;
      cp_async4(sw + w.q * R + w.r,
                words + static_cast<long long>(r0 + w.r) * W + wd);
    }
    for (Walk w = w0; rows > 0 && w.q < g_t; walk_next(w, R)) {
      if (w.r >= rows) continue;
      cp_async4(sn + w.q * R + w.r,
                node + static_cast<long long>(r0 + w.r) * M + m0 + w.q);
    }
    for (Walk w = w0; rows > 0 && w.q < gc; walk_next(w, R)) {
      if (w.r >= rows) continue;
      cp_async4(sv + w.q * R + w.r,
                vals + (static_cast<long long>(r0 + w.r) * M + m0) * C + w.q);
    }
    cp_async_commit();
  };

  // this warp's (member, feature) and where its bin sits in a staged word
  const int lane = tid & 31, warp = tid >> 5;
  const int mg = warp / nf, fl = warp - mg * nf;
  const bool worker = mg < g_t && fl < nf_t;
  const int f = f0 + fl;
  const int slot = word_per_feature ? fl : f % W;
  const int shift = (f / W) * bits;  // 0 for 32-bit words (f < d == W)
  const unsigned bmask = bits >= 32 ? kFull : ((1u << bits) - 1u);
  float* hw = hist + (mg * nf + fl) * np * C * B;
  unsigned char* tw = tags + warp * tag_bytes;

  for (int tile = 0; tile < kLevelStages - 1; ++tile) issue(tile);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int rows = min(R, r_end - r_begin - tile * R);
    int *sw, *sn;
    float* sv;
    stage_at(tile % kLevelStages, &sw, &sn, &sv);
    cp_async_wait<kLevelStages - 2>();  // this tile's copies (by this thread)
    for (Walk w = w0; w.q < gc; walk_next(w, R)) {
      if (w.r >= rows) continue;
      float* v = sv + w.q * R + w.r;
      *v = split_terms<NTERMS>(*v);
    }
    __syncthreads();  // this tile is split and visible; the oldest stage is free
    issue(tile + kLevelStages - 1);
    if (!worker) continue;
    const int* sn_w = sn + mg * R;
    const int* sw_w = sw + slot * R;
    const float* sv_w = sv + mg * C * R;
    // This step's node and bin, loaded one step ahead: the loads of a step
    // then wait on nothing of the step before.
    auto load_key = [&](int r, int* p, int* b) {
      *p = -1;
      *b = 0;
      if (r < rows) {
        *p = sn_w[r] - p0;
        *b = static_cast<int>((static_cast<unsigned>(sw_w[r]) >> shift) & bmask);
      }
    };
    int p_next, b_next;
    load_key(lane, &p_next, &b_next);
    for (int s0 = 0; s0 < rows; s0 += 32) {
      const int r = s0 + lane;
      const int p = p_next, b = b_next;
      load_key(r + 32, &p_next, &b_next);
      const bool mine = static_cast<unsigned>(p) < static_cast<unsigned>(np_t);
      const int key = p * B + b;
      float* cell = hw + (p * C) * B + b;
      // Conflict check: each lane tags its cell with its lane; all lanes of
      // a cell read back the same tag (the one write that landed), so a
      // lane that reads another lane's tag shares its cell.
      if (mine) tw[key] = static_cast<unsigned char>(lane);
      __syncwarp();  // also orders the last step's cell writes before this step's reads
      const int won = mine ? tw[key] : 0;
      const bool clash = __any_sync(kFull, mine && won != lane);
      unsigned peers = 0u, span = 1u;
      bool leader = mine;
      if (clash) {
        // lanes with equal keys are the lanes with equal tags: one ballot
        // per tag bit; the lowest lane of each group adds the group's
        // terms in lane (= row) order
        peers = __ballot_sync(kFull, mine);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const bool bit = (won >> i) & 1;
          const unsigned ones = __ballot_sync(kFull, bit);
          peers &= bit ? ones : ~ones;
        }
        leader = mine && __ffs(peers) - 1 == lane;
        span = __reduce_max_sync(
            kFull, mine ? static_cast<unsigned>(__popc(peers)) : 1u);
      }
      for (int c = 0; c < C; ++c) {
        const float term = r < rows ? sv_w[c * R + r] : 0.f;
        const float old = mine ? cell[c * B] : 0.f;
        float acc = term;
        unsigned rest = peers & (peers - 1u);  // the leader's group after itself
        for (unsigned k = 1; k < span; ++k) {
          const int src = rest ? __ffs(rest) - 1 : lane;
          const float v = __shfl_sync(kFull, term, src);
          if (rest) {
            acc += v;
            rest &= rest - 1u;
          }
        }
        if (leader) cell[c * B] = old + acc;
      }
    }
  }

  // Sum the cluster's chunks: rank k owns lines [k, k + 1) * lines / cs of
  // the tile (a line being the B bins of one member, node, channel and
  // feature), in output order, and adds the peers' copies in rank order.
  cluster.sync();
  const int lines = g_t * np_t * C * nf_t;
  const int l_lo = static_cast<int>(static_cast<long long>(lines) * rank / cs);
  const int l_hi =
      static_cast<int>(static_cast<long long>(lines) * (rank + 1) / cs);
  const int vec = (B & 3) == 0 ? 4 : 1;
  const int bv = B / vec;
  for (int i = tid; i < (l_hi - l_lo) * bv; i += nthreads) {
    const int li = i / bv;
    const int b = (i - li * bv) * vec;
    int l = l_lo + li;
    const int fo = l % nf_t;
    l /= nf_t;
    const int c = l % C;
    l /= C;
    const int p = l % np_t;
    const int mo = l / np_t;
    float* cell = hist + (((mo * nf + fo) * np + p) * C + c) * B + b;
    float* dst = out + (((static_cast<long long>(m0 + mo) * n_nodes + p0 + p) *
                             C + c) * d + f0 + fo) * B + b;
    if (vec == 4) {
      float4 v[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (j < cs) {
          v[j] = *reinterpret_cast<float4*>(cluster.map_shared_rank(cell, j));
        }
      }
      float4 s = v[0];
#pragma unroll
      for (int j = 1; j < kMaxCluster; ++j) {
        if (j < cs) {
          s.x += v[j].x;
          s.y += v[j].y;
          s.z += v[j].z;
          s.w += v[j].w;
        }
      }
      *reinterpret_cast<float4*>(dst) = s;
    } else {
      float v[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (j < cs) v[j] = *cluster.map_shared_rank(cell, j);
      }
      float s = v[0];
#pragma unroll
      for (int j = 1; j < kMaxCluster; ++j) {
        if (j < cs) s += v[j];
      }
      *dst = s;
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its tile
}

using HistKernel = void (*)(const int32_t*, const int32_t*, const float*,
                            float*, int, int, int, int, int, int, int, int,
                            int, int, int, int);

int grid_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
}

template <int NTERMS>
cudaError_t launch_level(const int32_t* words, const int32_t* node,
                         const float* vals, float* out, int n, int d, int M,
                         int C, int B, int n_nodes, int W, int bits, int g,
                         int nf, int np, int cs, int R, int rows_per_chunk,
                         long long smem, cudaStream_t stream) {
  auto kern = level_hist<NTERMS>;
  static long long smem_set = 48 * 1024;  // the largest allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // all of the SM's unified L1 that can be shared memory, so that as many
    // CTAs fit an SM as the plan counts on
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const long long tiles = static_cast<long long>((M + g - 1) / g) *
                          ((d + nf - 1) / nf) * ((n_nodes + np - 1) / np);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cs));
  cfg.blockDim = dim3(32 * g * nf);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, words, node, vals, out, n, d, M, C, B,
                            n_nodes, W, bits, g, nf, np, R, rows_per_chunk);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of se_hist_level uses.
long long se_hist_smem_bytes(int C, int B, int nf, int np) {
  return 4LL * (static_cast<long long>(np) * C * nf * B + kTileRows +
                kTileRows * C + static_cast<long long>(kTileRows) * nf);
}

// Leaf sums (src 2 = none, d = B = 1, nterms 1).  When chunks > 1, scratch
// holds chunks * |out| floats.  Returns cudaGetLastError() after the launches.
int se_hist_level(int src, int nterms, const int32_t* bins,
                  const int32_t* node, const float* vals, float* out,
                  float* scratch, int n, int d, int M, int C, int B,
                  int n_nodes, int W, int bits, int nf, int np, int K,
                  int chunks, int rows_per_chunk, void* stream) {
  HistKernel kern = nullptr;
  if (src == kSrcNone && nterms == 1) {
    kern = hist_accumulate<kSrcNone, 1>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = se_hist_smem_bytes(C, B, nf, np);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_ft = (d + nf - 1) / nf;
  const int n_pt = (n_nodes + np - 1) / np;
  const dim3 grid(M * n_ft * n_pt, chunks);
  const int threads = ((nf * K + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = chunks > 1 ? scratch : out;
  kern<<<grid, threads, static_cast<size_t>(smem), s>>>(
      bins, node, vals, dst, n, d, M, C, B, n_nodes, W, bits, nf, np, K,
      rows_per_chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks <= 1) return static_cast<int>(e);
  const long long total = static_cast<long long>(M) * n_nodes * C * d * B;
  reduce_chunks<<<grid_for(total, 256), 256, 0, s>>>(scratch, out, total,
                                                     chunks);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one CTA of se_level_hist uses.
long long se_level_smem_bytes(int g, int nf, int np, int C, int B, int R,
                              int W, int bits) {
  const long long slot_cap = bits >= 32 || W > nf ? nf : W;
  return 4LL * (static_cast<long long>(g) * nf * np * C * B +
                static_cast<long long>(kLevelStages) * R *
                    (slot_cap + g + static_cast<long long>(g) * C)) +
         static_cast<long long>(g) * nf *
             ((static_cast<long long>(np) * B + 3) & ~3LL);
}

// One level histogram H [M, n_nodes, C, d, B] from words [n, W] of `bits`
// bits (i32 bins: W = d, bits = 32), with the statistics split into nterms
// (2: pallas tier, 3: fused tier) bf16 terms.  g members, nf features and np
// nodes per CTA; cs row chunks of rows_per_chunk rows, one cluster, staged
// R rows at a time.
int se_level_hist(int nterms, const int32_t* words, const int32_t* node,
                  const float* vals, float* out, int n, int d, int M, int C,
                  int B, int n_nodes, int W, int bits, int g, int nf, int np,
                  int cs, int R, int rows_per_chunk, void* stream) {
  const long long smem = se_level_smem_bytes(g, nf, np, C, B, R, W, bits);
  const bool ok = (bits == 4 || bits == 8 || bits == 32) && g >= 1 &&
                  nf >= 1 && np >= 1 && cs >= 1 && cs <= kMaxCluster &&
                  R >= 32 && R % 32 == 0 &&
                  32 * g * nf <= kMaxLevelThreads && smem <= kMaxSmem &&
                  static_cast<long long>(rows_per_chunk) * cs >= n;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nterms == 2) {
    e = launch_level<2>(words, node, vals, out, n, d, M, C, B, n_nodes, W,
                        bits, g, nf, np, cs, R, rows_per_chunk, smem, s);
  } else if (nterms == 3) {
    e = launch_level<3>(words, node, vals, out, n, d, M, C, B, n_nodes, W,
                        bits, g, nf, np, cs, R, rows_per_chunk, smem, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Route every (row, member) one level down through split tables [M, half].
int se_route_packed(const int32_t* packed, const int32_t* node_in,
                    const int32_t* best_f, const int32_t* best_t,
                    int32_t* node_out, int n, int M, int half, int W,
                    int bits, void* stream) {
  const long long total = static_cast<long long>(n) * M;
  route_packed<<<grid_for(total, 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      packed, node_in, best_f, best_t, node_out, n, M, half, W, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
