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
// Deterministic by construction: no float atomics.  A CTA owns one tile of
// the output (member m, a feature tile, a node tile) for one chunk of rows and
// keeps it in shared memory.  Within the tile, thread (fl, L) is the only
// writer of the cells of feature fl whose key = node * B + bin is congruent to
// L mod K, and it adds its rows in ascending row order.  When rows are split
// into chunks, each chunk's tile goes to scratch the wrapper allocates, and a
// second grid sums the chunks in chunk order.  The result is bit-identical
// from launch to launch.
//
// What bounds it.  The bytes it must move are small (at letter scale, one
// level reads ~5.6 MB and writes at most 3.4 MB: ~3 us at 3.35 TB/s).  This
// first version is bound instead by its shared-memory read-modify-write
// chains and by the K-fold scan of the row stream (every thread of a feature
// reads every row to find its own).  The design limits the chains: each
// thread first builds a 32-row ownership mask from independent loads, then
// walks only its own rows, so the lanes of a warp update different cells in
// the same step instead of taking turns row by row.
//
// Routing (fused tier) is a separate, one-thread-per-(row, member) launch:
// node_out = 2 * node + 1 - (bin[r, best_f[m, node]] <= best_t[m, node]),
// unpacking only the word that holds best_f.  It runs once per row, not once
// per output tile, and is integer-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

using HistKernel = void (*)(const int32_t*, const int32_t*, const float*,
                            float*, int, int, int, int, int, int, int, int,
                            int, int, int, int);

int grid_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of se_hist_level uses.
long long se_hist_smem_bytes(int C, int B, int nf, int np) {
  return 4LL * (static_cast<long long>(np) * C * nf * B + kTileRows +
                kTileRows * C + static_cast<long long>(kTileRows) * nf);
}

// One level histogram.  src: 0 = i32 bins [n, d], 1 = packed words [n, W],
// 2 = none (leaf sums: d = B = 1).  nterms: 2 (pallas tier), 3 (fused tier),
// 1 (leaf sums).  When chunks > 1, scratch holds chunks * |out| floats.
// Returns cudaGetLastError() after the launches.
int se_hist_level(int src, int nterms, const int32_t* bins,
                  const int32_t* node, const float* vals, float* out,
                  float* scratch, int n, int d, int M, int C, int B,
                  int n_nodes, int W, int bits, int nf, int np, int K,
                  int chunks, int rows_per_chunk, void* stream) {
  HistKernel kern = nullptr;
  if (src == kSrcI32 && nterms == 2) {
    kern = hist_accumulate<kSrcI32, 2>;
  } else if (src == kSrcPacked && nterms == 3) {
    kern = hist_accumulate<kSrcPacked, 3>;
  } else if (src == kSrcNone && nterms == 1) {
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
