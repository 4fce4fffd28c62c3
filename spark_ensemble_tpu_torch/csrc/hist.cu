// Level-histogram, routing and leaf-sum kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of spark_ensemble_tpu/ops/pallas_hist.py:
//   _hist_kernel  (hist_precision="pallas"): level histogram over i32 bins,
//                 statistics split into bf16 hi + lo;
//   _fused_kernel (hist="fused"): unpack 4/8-bit lane-major packed bins,
//                 route rows through the previous level's split tables, then
//                 the level histogram with a 3-term bf16 split, or exact f32
//                 leaf sums in leaf mode.
// Three kernels: level_hist (both level histograms), route_packed (the
// fused tier's route before a level histogram) and leaf_sums (the leaf
// mode: the route and the sums in one launch).
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
// The leaf pass (leaf_sums<ROUTE>), the TPU kernel's leaf mode in one
// launch.  L[m, leaf, c] = sum in f32 of vals[r, m, c] over the rows whose
// leaf is `leaf`.  With split tables (ROUTE) each (row, member) is first
// routed from its parent id, as route_packed does, and its leaf id written
// out (the GBM round reads it); without them the ids are given.
// What bounds it.  At the main path's shapes (15000 rows, 26 members, 32
// leaves, C = 2) it moves ~6.5 MB (packed words, parent and leaf ids,
// statistics, tables, L): ~2 us at 3.35 TB/s, and its n * M * C adds are
// nothing beside that.  So it is bound by bytes and, with a few rows per
// lane, by latency: the row loads, and the combine's barriers and global
// round trips after them, each take their turn.  The design:
// - Lanes map to members (groups of 32 when M > 32); when M is small a warp
//   takes several rows, lane = (row slot, member).  A warp's loads of
//   node[r, :] and vals[r, :, :] are then contiguous.  Each lane loads
//   kLeafSteps rows before it adds any of them, and the plan gives a CTA
//   whole chunks of rows (one at the main path), whose loads are in flight
//   while the CTA stages its tables and zeroes its columns.
// - Each lane owns a private column of sums in shared memory, laid out
//   [leaf][C][32 lanes]: every access hits the lane's own bank whatever the
//   leaf, and no lane waits on another.  The plan tiles leaves when a
//   warp's columns pass 16 KB, and members when they pass a CTA.
// - The CTA stages its members' split tables once per tile as
//   (word << 5 | lane shift, best_t), and each chunk of its rows' packed
//   words with cp.async, one chunk ahead: a row's words are read once for
//   all of its members, and a route costs two shared-memory loads.
// - The combine is in a fixed order: a member's columns in warp order (four
//   lanes a thread, as float4), then row-slot order into the CTA's
//   partial, with no division and no bank conflict; the CTAs of a thread-block
//   cluster in rank order through distributed shared memory.  With more
//   than one cluster each writes its partial to a workspace (a few KB per
//   cluster, kept per stream by the caller), and the last cluster to finish,
//   found by an integer ticket that it resets, sums them in cluster order.
//   No float atomics and no second launch: two launches give the same bits.
//
// Routing (route_packed), before each level histogram of the fused tier but
// the first: node_out = 2 * node + 1 - [bin(r, best_f[m, node]) <=
// best_t[m, node]], integer-exact.  At the main path's deepest level (8
// parents) it moves ~3.4 MB, ~1 us, with a few integer operations per
// element: bound by bytes and load latency.  The grid is one wave; a CTA
// stages its tables once, and each tile's packed words (R x W contiguous)
// with cp.async while its threads' node loads are in flight.  A thread
// takes 4 consecutive (row, member) elements, member-fastest, as one
// 16-byte load and store, and walks (row, member) with no division per
// element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kMaxLevelThreads = 512;
constexpr int kLevelStages = 3;  // row tiles in flight: one split, two landing
constexpr long long kMaxSmem = 232448;  // 227 KB, the most one CTA may use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRouteThreads = 256;
constexpr int kMaxLeafThreads = 512;
constexpr int kLeafSteps = 8;  // rows a lane loads before it adds them
constexpr int kLeafPre = 2;    // channels of a row loaded ahead; more are loaded as added
constexpr int kLeafBatch = 16;  // cluster partials a thread of the last cluster loads at once

// The TPU kernels' per-row statistic split into NTERMS bf16 terms, summed
// in f32.
template <int NTERMS>
__device__ __forceinline__ float split_terms(float v) {
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  const float l = __bfloat162float(__float2bfloat16_rn(v - h));
  if (NTERMS == 2) return h + l;
  const float l2 = __bfloat162float(__float2bfloat16_rn(v - h - l));
  return h + l + l2;
}

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

// A thread's walk over the elements e = q * R + r of a [Q][R] array in a
// fixed step (dq * R + dr), without a division inside the loop.
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

// A split-table entry as staged in shared memory: x = the word of a packed
// row that holds feature best_f (word f % W, lane f / W of the lane-major
// layout) << 5 | the lane's bit offset, y = best_t; x = -1 for a feature
// outside [0, d).
__device__ __forceinline__ int2 split_entry(int f, int t, int W, int bits,
                                            int d) {
  return static_cast<unsigned>(f) < static_cast<unsigned>(d)
             ? make_int2(((f % W) << 5) | ((f / W) * bits), t)
             : make_int2(-1, t);
}

// Stages `count` split-table entries.  The first kTabPre per thread are
// loaded by load() into registers, so that a caller can issue further loads
// before store() waits on them.
constexpr int kTabPre = 4;

struct SplitStage {
  int f[kTabPre], t[kTabPre];

  __device__ __forceinline__ void load(const int32_t* __restrict__ best_f,
                                       const int32_t* __restrict__ best_t,
                                       int count) {
#pragma unroll
    for (int j = 0; j < kTabPre; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      f[j] = i < count ? __ldg(best_f + i) : 0;
      t[j] = i < count ? __ldg(best_t + i) : 0;
    }
  }

  __device__ __forceinline__ void store(int2* tab,
                                        const int32_t* __restrict__ best_f,
                                        const int32_t* __restrict__ best_t,
                                        int count, int W, int bits, int d) {
#pragma unroll
    for (int j = 0; j < kTabPre; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < count) tab[i] = split_entry(f[j], t[j], W, bits, d);
    }
    for (int i = threadIdx.x + kTabPre * blockDim.x; i < count; i += blockDim.x) {
      tab[i] = split_entry(__ldg(best_f + i), __ldg(best_t + i), W, bits, d);
    }
  }
};

// The child of parent p of one (row, member), from the member's staged
// table row and the row's staged words; -1 for a parent outside [0, half)
// or a feature outside [0, d).
__device__ __forceinline__ int route_one(int p, const int2* tab_m, int half,
                                         const int* words_r, unsigned mask) {
  if (static_cast<unsigned>(p) >= static_cast<unsigned>(half)) return -1;
  const int2 e = tab_m[p];
  if (e.x < 0) return -1;
  const int b = static_cast<int>(
      (static_cast<unsigned>(words_r[e.x >> 5]) >> (e.x & 31)) & mask);
  return 2 * p + 1 - (b <= e.y ? 1 : 0);
}

__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p, int e,
                                     int count, bool vec) {
  if (vec && e + 3 < count) return __ldg(reinterpret_cast<const int4*>(p + e));
  int4 q = make_int4(0, 0, 0, 0);
  if (e < count) q.x = __ldg(p + e);
  if (e + 1 < count) q.y = __ldg(p + e + 1);
  if (e + 2 < count) q.z = __ldg(p + e + 2);
  if (e + 3 < count) q.w = __ldg(p + e + 3);
  return q;
}

__device__ __forceinline__ void store4(int32_t* __restrict__ p, int e,
                                       int count, bool vec, int4 q) {
  if (vec && e + 3 < count) {
    *reinterpret_cast<int4*>(p + e) = q;
    return;
  }
  if (e < count) p[e] = q.x;
  if (e + 1 < count) p[e + 1] = q.y;
  if (e + 2 < count) p[e + 2] = q.z;
  if (e + 3 < count) p[e + 3] = q.w;
}

// Route every (row, member) one level down.  Tiles of R rows (R % 4 == 0)
// over a one-wave grid.  Shared layout: tables int2 [M][half] | words
// [R][W].
__global__ void __launch_bounds__(kRouteThreads)
    route_packed(const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ node_in,
                 const int32_t* __restrict__ best_f,
                 const int32_t* __restrict__ best_t,
                 int32_t* __restrict__ node_out, int n, int M, int half,
                 int W, int bits, int d, int R) {
  extern __shared__ __align__(16) int rsmem[];
  int2* tab = reinterpret_cast<int2*>(rsmem);
  int* words = rsmem + 2 * M * half;
  const int tid = threadIdx.x;
  const unsigned mask = bits >= 32 ? kFull : (1u << bits) - 1u;
  // a tile starts at element r0 * M, a multiple of 4 when R * M is
  const bool vec = ((reinterpret_cast<uintptr_t>(node_in) |
                     reinterpret_cast<uintptr_t>(node_out)) & 15) == 0 &&
                   (R * M) % 4 == 0;
  SplitStage st;
  st.load(best_f, best_t, M * half);
  st.store(tab, best_f, best_t, M * half, W, bits, d);
  const int step = 4 * kRouteThreads;
  const Walk w0 = {4 * tid / M, 4 * tid % M, step / M, step % M};
  for (int tile = blockIdx.x; static_cast<long long>(tile) * R < n;
       tile += gridDim.x) {
    const int r0 = tile * R;
    const int rows = min(R, n - r0);
    const int count = rows * M;
    const int32_t* in = node_in + static_cast<long long>(r0) * M;
    int32_t* out = node_out + static_cast<long long>(r0) * M;
    int4 q = load4(in, 4 * tid, count, vec);  // in flight during the staging
    if (tile != static_cast<int>(blockIdx.x)) __syncthreads();  // last tile's words are consumed
    const int32_t* src = packed + static_cast<long long>(r0) * W;
    for (int i = tid; i < rows * W; i += kRouteThreads) cp_async4(words + i, src + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the tables and this tile's words are in place
    Walk w = w0;  // (row, member) of this thread's first element
    for (int e = 4 * tid; e < count; e += step, walk_next(w, M)) {
      if (e != 4 * tid) q = load4(in, e, count, vec);
      int v[4] = {q.x, q.y, q.z, q.w};
      int row = w.q, m = w.r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e + j < count) {
          v[j] = route_one(v[j], tab + m * half, half, words + row * W, mask);
        }
        if (++m == M) {
          m = 0;
          ++row;
        }
      }
      store4(out, e, count, vec, make_int4(v[0], v[1], v[2], v[3]));
    }
  }
}

// The leaf pass.  Grid: clusters of cs CTAs; CTA b takes rows [b, b + 1) *
// rows_per_cta.  A CTA has n_mg x n_rw warps: warp w serves member group
// w % n_mg (g members, S = 32 / g row slots) of the member tile and row warp
// w / n_mg.  Shared layout: columns [warps][LT][C][32] | partial
// [n_mg][LT][C][32] | tables int2 [MT][half] | words [2][RC][W] | flag, for MT =
// n_mg * g members per tile and RC = kLeafSteps * n_rw * S rows per chunk.
template <bool ROUTE>
__global__ void __launch_bounds__(kMaxLeafThreads)
    leaf_sums(const int32_t* __restrict__ packed,
              const int32_t* __restrict__ node,
              const float* __restrict__ vals,
              const int32_t* __restrict__ best_f,
              const int32_t* __restrict__ best_t,
              int32_t* __restrict__ node_out, float* __restrict__ out,
              float* __restrict__ partials, unsigned* __restrict__ ticket,
              int n, int M, int C, int leaves, int half, int W, int bits,
              int d, int g, int n_mg, int n_rw, int LT, int rows_per_cta) {
  extern __shared__ __align__(16) float fsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cl = static_cast<int>(gridDim.x) / cs;
  const int cl = static_cast<int>(blockIdx.x) / cs;
  const int S = 32 / g, MT = n_mg * g, nw = n_mg * n_rw;
  const int RC = kLeafSteps * n_rw * S;
  const int col_words = LT * C * 32;  // one warp's columns
  float* cols = fsmem;
  float* part = cols + nw * col_words;
  int2* tab = reinterpret_cast<int2*>(part + n_mg * col_words);
  int* words = reinterpret_cast<int*>(tab + MT * half);
  int* flag = words + 2 * RC * W;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int mg = warp % n_mg, rw = warp / n_mg;
  const int slot = lane / g, mi = lane - slot * g;
  const int r_begin = static_cast<int>(
      min(static_cast<long long>(n),
          static_cast<long long>(blockIdx.x) * rows_per_cta));
  const int r_end = min(n, r_begin + rows_per_cta);
  const int n_chunks = (r_end - r_begin + RC - 1) / RC;
  const unsigned mask = bits >= 32 ? kFull : (1u << bits) - 1u;
  float* colw = cols + warp * col_words;
  const long long LC = static_cast<long long>(leaves) * C;

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    const int mm = mg * g + mi;  // this lane's member within the tile
    const bool lane_on = slot < S && mm < mt;
    const long long m = m0 + mm;
    for (int l0 = 0; l0 < leaves; l0 += LT) {
      const int lt = min(LT, leaves - l0);
      // chunk k's packed words into buffer k % 2, as one copy group (empty
      // past the last chunk, so that every thread counts the same groups)
      auto issue = [&](int k) {
        const int r0 = r_begin + k * RC;
        const int rows = k < n_chunks ? min(RC, r_end - r0) : 0;
        int* buf = words + (k & 1) * RC * W;
        const int32_t* src = packed + static_cast<long long>(r0) * W;
        for (int i = tid; i < rows * W; i += nthreads) cp_async4(buf + i, src + i);
        cp_async_commit();
      };
      // this lane's rows of chunk k, row (u * n_rw + rw) * S + slot at step
      // u: their ids and statistics, in registers
      int id[kLeafSteps];
      long long rm[kLeafSteps];
      float v[kLeafSteps][kLeafPre];
      auto load_rows = [&](int k) {
        const int rc0 = r_begin + k * RC;
#pragma unroll
        for (int u = 0; u < kLeafSteps; ++u) {
          const int r = rc0 + (u * n_rw + rw) * S + slot;
          const bool on = lane_on && k < n_chunks && r < r_end;
          rm[u] = on ? static_cast<long long>(r) * M + m : -1;
          id[u] = on ? __ldg(node + rm[u]) : -1;
#pragma unroll
          for (int c = 0; c < kLeafPre; ++c) {
            v[u][c] = on && c < C ? __ldg(vals + rm[u] * C + c) : 0.f;
          }
        }
      };
      // the tables' loads go out first, then the first chunk's words and
      // rows; the columns are zeroed while they land
      SplitStage st;
      if (ROUTE) st.load(best_f + m0 * half, best_t + m0 * half, mt * half);
      if (ROUTE) issue(0);
      load_rows(0);
      if (ROUTE) {
        st.store(tab, best_f + m0 * half, best_t + m0 * half, mt * half, W,
                 bits, d);
      }
      for (int k = lane; k < LT * C * 8; k += 32) {
        reinterpret_cast<float4*>(colw)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();  // a lane adds into cells its neighbours zeroed
      for (int k = 0; k < n_chunks; ++k) {
        if (ROUTE) {
          issue(k + 1);
          cp_async_wait<1>();
          __syncthreads();  // chunk k's words and the tables are in place
        }
        if (k > 0) load_rows(k);
        const int* wk = words + (k & 1) * RC * W;
#pragma unroll
        for (int u = 0; u < kLeafSteps; ++u) {
          if (rm[u] < 0) continue;
          if (ROUTE) {
            const int i = (u * n_rw + rw) * S + slot;  // the row within the chunk
            id[u] = route_one(id[u], tab + mm * half, half, wk + i * W, mask);
            if (l0 == 0) node_out[rm[u]] = id[u];
          }
          const int l = id[u] - l0;
          if (static_cast<unsigned>(l) < static_cast<unsigned>(lt)) {
            float* cell = colw + l * C * 32 + lane;
#pragma unroll
            for (int c = 0; c < kLeafPre; ++c) {
              if (c < C) cell[c * 32] += v[u][c];
            }
            for (int c = kLeafPre; c < C; ++c) {
              cell[c * 32] += __ldg(vals + rm[u] * C + c);
            }
          }
        }
        if (ROUTE) __syncthreads();  // buffer k % 2 is free for chunk k + 2
      }
      if (ROUTE) cp_async_wait<0>();
      __syncthreads();  // every warp's columns are complete
      // The CTA's partial P [n_mg][LT * C][32 lanes]: each lane's columns
      // summed over its member group's warps in warp order, four lanes a
      // thread (float4); then, when a warp holds several row slots, the
      // slots of each member in slot order into lane `member`.
      const int ltc = lt * C;
      for (int e4 = tid; e4 < n_mg * ltc * 8; e4 += nthreads) {
        int t = e4 >> 3, gi = 0;
        if (n_mg > 1) {
          gi = t / ltc;
          t -= gi * ltc;
        }
        const float4* cw = reinterpret_cast<const float4*>(cols + gi * col_words) + t * 8 + (e4 & 7);
        float4 s4 = cw[0];
        for (int r2 = 1; r2 < n_rw; ++r2) {
          const float4 x = cw[r2 * n_mg * col_words / 4];
          s4.x += x.x;
          s4.y += x.y;
          s4.z += x.z;
          s4.w += x.w;
        }
        reinterpret_cast<float4*>(part + gi * LT * C * 32)[t * 8 + (e4 & 7)] = s4;
      }
      if (S > 1) {
        __syncthreads();
        // lane mi of row t is read and written only by its own thread
        for (int e = tid; e < n_mg * ltc * g; e += nthreads) {
          const int mi2 = e % g, t = e / g;  // t runs over n_mg x ltc rows
          float* row = part + (t / ltc * LT * C + t % ltc) * 32;
          float s = row[mi2];
          for (int sl = 1; sl < S; ++sl) s += row[sl * g + mi2];
          row[mi2] = s;
        }
      }
      // The cluster's sum: rank k adds its slice of the partial over the
      // ranks in order, into L (one cluster) or this cluster's workspace.
      cluster.sync();
      const int E = mt * ltc;
      const int lo = static_cast<int>(static_cast<long long>(E) * rank / cs);
      const int hi = static_cast<int>(static_cast<long long>(E) * (rank + 1) / cs);
      float* dst = n_cl == 1 ? out : partials + cl * M * LC;
      for (int e = lo + tid; e < hi; e += nthreads) {
        const int mm2 = e % mt, t = e / mt;
        const int gi = mm2 / g;
        float* cell = part + (gi * LT * C + t) * 32 + mm2 - gi * g;
        float pv[kMaxCluster];
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j) {
          if (j < cs) pv[j] = *cluster.map_shared_rank(cell, j);
        }
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j) {
          if (j < cs) s += pv[j];
        }
        const int c = t % C, l = t / C;
        dst[(m0 + mm2) * LC + static_cast<long long>(l0 + l) * C + c] = s;
      }
      // with more than one cluster, this thread's writes to the workspace
      // are visible device-wide before rank 0 takes the cluster's ticket
      if (n_cl > 1) __threadfence();
      cluster.sync();  // no peer still reads this CTA's partial
    }
  }
  if (n_cl == 1) return;
  // The last cluster to take a ticket sums the clusters' partials in
  // cluster order.
  if (rank == 0 && tid == 0) {
    const int last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_cl - 1);
    for (int j = 0; j < cs; ++j) *cluster.map_shared_rank(flag, j) = last;
  }
  cluster.sync();
  if (!*flag) return;
  __threadfence();
  const long long E = M * LC;
  const long long lo = E * rank / cs, hi = E * (rank + 1) / cs;
  for (long long e = lo + tid; e < hi; e += nthreads) {
    float s = 0.f;
    for (int k0 = 0; k0 < n_cl; k0 += kLeafBatch) {  // kLeafBatch loads in flight
      float pv[kLeafBatch];
#pragma unroll
      for (int j = 0; j < kLeafBatch; ++j) {
        pv[j] = k0 + j < n_cl ? __ldcg(partials + (k0 + j) * E + e) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kLeafBatch; ++j) {
        if (k0 + j < n_cl) s += pv[j];
      }
    }
    out[e] = s;
  }
  if (rank == 0 && tid == 0) *ticket = 0u;  // every cluster has taken its ticket
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

template <bool ROUTE>
cudaError_t launch_leaf(const int32_t* packed, const int32_t* node,
                        const float* vals, const int32_t* best_f,
                        const int32_t* best_t, int32_t* node_out, float* out,
                        float* partials, unsigned* ticket, int n, int M, int C,
                        int leaves, int half, int W, int bits, int d, int g,
                        int n_mg, int n_rw, int LT, int cs, int grid,
                        int rows_per_cta, long long smem, cudaStream_t stream) {
  auto kern = leaf_sums<ROUTE>;
  static long long smem_set = 48 * 1024;  // the largest allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(32 * n_mg * n_rw);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, packed, node, vals, best_f, best_t,
                            node_out, out, partials, ticket, n, M, C, leaves,
                            half, W, bits, d, g, n_mg, n_rw, LT, rows_per_cta);
}
}  // namespace

extern "C" {

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

// Bytes of dynamic shared memory one CTA of se_leaf_sums uses (half = W = 0
// without split tables).
long long se_leaf_smem_bytes(int C, int g, int n_mg, int n_rw, int LT,
                             int half, int W) {
  const long long MT = static_cast<long long>(n_mg) * g;
  const long long RC = static_cast<long long>(kLeafSteps) * n_rw * (32 / g);
  return 4LL * (static_cast<long long>(n_mg) * (n_rw + 1) * LT * C * 32 +
                2 * MT * half + 2 * RC * W + 1);
}

// Leaf sums L [M, leaves, C] of vals [n, M, C] by the ids in node [n, M];
// with split tables best_f / best_t [M, half] (non-null), node holds parent
// ids, which are routed through them into node_out first.  More than one
// cluster (grid > cs) needs the workspace: a ticket (0 between launches) and
// grid / cs * M * leaves * C floats of partials.
int se_leaf_sums(const int32_t* packed, const int32_t* node, const float* vals,
                 const int32_t* best_f, const int32_t* best_t,
                 int32_t* node_out, float* out, float* partials,
                 unsigned* ticket, int n, int M, int C, int leaves, int half,
                 int W, int bits, int d, int g, int n_mg, int n_rw, int LT,
                 int cs, int grid, int rows_per_cta, void* stream) {
  const bool route = best_f != nullptr;
  const long long smem =
      se_leaf_smem_bytes(C, g, n_mg, n_rw, LT, route ? half : 0, route ? W : 0);
  const bool ok =
      n >= 1 && M >= 1 && C >= 1 && leaves >= 1 && g >= 1 && g <= 32 &&
      n_mg >= 1 && n_rw >= 1 && 32 * n_mg * n_rw <= kMaxLeafThreads &&
      LT >= 1 && cs >= 1 && cs <= kMaxCluster && grid % cs == 0 &&
      static_cast<long long>(rows_per_cta) * grid >= n && smem <= kMaxSmem &&
      (grid == cs || (partials != nullptr && ticket != nullptr)) &&
      (!route || (best_t != nullptr && packed != nullptr &&
                  node_out != nullptr && half >= 1 && W >= 1 && d >= 1 &&
                  (bits == 4 || bits == 8 || bits == 32)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      route ? launch_leaf<true>(packed, node, vals, best_f, best_t, node_out,
                                out, partials, ticket, n, M, C, leaves, half,
                                W, bits, d, g, n_mg, n_rw, LT, cs, grid,
                                rows_per_cta, smem, s)
            : launch_leaf<false>(packed, node, vals, best_f, best_t, node_out,
                                 out, partials, ticket, n, M, C, leaves, 0, 0,
                                 bits, d, g, n_mg, n_rw, LT, cs, grid,
                                 rows_per_cta, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one CTA of se_route_packed uses.
long long se_route_smem_bytes(int M, int half, int W, int R) {
  return 8LL * M * half + 4LL * R * W;
}

// Route every (row, member) one level down through split tables [M, half]:
// tiles of R rows (R % 4 == 0) over `grid` CTAs.
int se_route_packed(const int32_t* packed, const int32_t* node_in,
                    const int32_t* best_f, const int32_t* best_t,
                    int32_t* node_out, int n, int M, int half, int W,
                    int bits, int d, int R, int grid, void* stream) {
  const long long smem = se_route_smem_bytes(M, half, W, R);
  const bool ok = n >= 1 && M >= 1 && half >= 1 && W >= 1 && d >= 1 &&
                  R >= 4 && R % 4 == 0 && grid >= 1 && smem <= kMaxSmem &&
                  (bits == 4 || bits == 8 || bits == 32);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static long long smem_set = 48 * 1024;  // the largest allowed so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_packed, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  route_packed<<<grid, kRouteThreads, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(
      packed, node_in, best_f, best_t, node_out, n, M, half, W, bits, d, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
