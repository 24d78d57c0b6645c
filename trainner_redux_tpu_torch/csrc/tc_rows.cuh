// The per-token kernels of the tensor-core engine (tc_gemm.cuh), shared by
// the training backwards and the pre-LN block forwards (block_fwd.cuh):
// LayerNorm rows, the products y W (+ b) and A W^T over 128-token block
// tiles, and the epilogues that take whole rows of a product (the LayerNorm
// backward, a residual). fp32 in 3xTF32, for sm_90a; 256 threads a block,
// two warpgroups of 64 rows each, one block a SM. The backwards take rows of
// C <= 256 channels, C a multiple of 4: rows move with 16-byte loads and
// copies. The forwards' kernels (ln_rows_kernel, linear_kernel) also take
// rows of up to 512 channels (768 in the post-norm blocks' residual row
// pass) and, where a width is not a multiple of 4, move them a float at a
// time (VEC false).
#pragma once

#include "tc_gemm.cuh"

// Return a C launcher's cudaError_t as an int if `call` fails.
#define TRR_TRY(call)                      \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

namespace trr {

constexpr int kColTile = 128;       // columns of a y W block tile
constexpr int kHidTile = kColTile;  // hidden units of a mlp_hidden_kernel tile
constexpr int kRowLd = kTcK + 4;    // row stride of a [row][k] chunk (conflict-free A loads)
// What rows_kernel does with the rows of its product dy = A W^T.
constexpr int kRowsStore = 0;       // out = dy
constexpr int kRowsResidual = 1;    // out = dres + dy
constexpr int kRowsLn = 2;          // the LayerNorm backward of the rows
constexpr int kLnMaxC = 512;        // channels of a ln_rows_kernel row
constexpr int kPnMaxC = 768;        // channels of its residual (post-norm) form's row
// What linear_kernel does with its product acc = A W.
constexpr int kLinearBias = 0;      // out = acc + b
constexpr int kLinearGelu = 1;      // out = gelu_erf(acc + b)
constexpr int kLinearResidual = 2;  // out = x + s[t / hw] (acc + b)

// The columns of a rows_kernel tile: the least of 64, 128, 192, 256 >= C.
__host__ __device__ inline int rows_cols(int C) { return C <= 64 ? 64 : (C + 63) / 64 * 64; }

// A per-token stage: a (128, kTcK) token chunk [row][k] (row stride
// kRowLd) and a raw (BN, kTcK) weight chunk, [n][k] (stride kRowLd) or
// [k][n] (stride BN + 8). The kernels keep the split buffers of
// tc_gemm.cuh ahead of their ring.
__host__ __device__ constexpr int token_stage_floats(int bn) {
  return kTcRows * kRowLd + (bn * kRowLd > kTcK * (bn + 8) ? bn * kRowLd : kTcK * (bn + 8));
}

// Shared memory, in bytes, of rows_kernel and of linear_kernel at BN
// columns.
__host__ __device__ inline int rows_smem_bytes(int C) {
  return split_floats(rows_cols(C)) * (int)sizeof(float) +
         Ring<>::bytes(token_stage_floats(rows_cols(C)));
}
__host__ __device__ inline int linear_smem_bytes(int bn = kColTile) {
  return split_floats(bn) * (int)sizeof(float) + Ring<>::bytes(token_stage_floats(bn));
}

// The columns of a linear_kernel tile, whatever its epilogue: 64 or 128
// where one tile spans the row, 96 for rows of 129-192 (two tiles: 192
// columns at C 180, where 128-column tiles would take 256), else 128 (256
// at C 240). At most 128: a promoted product holds two accumulators of BN
// / 2 floats a thread.
__host__ __device__ inline int linear_cols(int N) {
  return N <= 64 ? 64 : N <= 128 ? 128 : N <= 192 ? 96 : kColTile;
}

// mlp_hidden_kernel keeps gelu'(h) of its tile in shared memory between
// its two products, [element][thread].
constexpr int kGeluFloats = kHidTile / 2 * kThreads;
__host__ __device__ inline int hidden_smem_bytes() {
  return (kGeluFloats + split_floats(kHidTile)) * (int)sizeof(float) +
         Ring<>::bytes(token_stage_floats(kHidTile));
}

// y = LN(x) (T, C) with g and be, two-pass mean and variance as the forward;
// stats (T, 2) the mean and 1/std of each row, when not null. When dm is
// not null, dm = s[t / hw] dout as well. One warp a token, C <= kLnMaxC;
// VEC (C a multiple of 4): 16-byte loads and stores, else a float at a time.
// RES, the post-norm blocks' last stage: y = res + s[t / hw] LN(x) instead,
// res (T, C) the block's input, C <= kPnMaxC.
template <bool VEC, bool RES = false>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ be, const float* __restrict__ res,
                   float* __restrict__ y, float* __restrict__ stats,
                   const float* __restrict__ dout, const float* __restrict__ s,
                   float* __restrict__ dm, long long T, long long hw, int C, float eps) {
  constexpr int V = VEC ? 4 : 1;                             // floats a load
  constexpr int PER = (RES ? kPnMaxC : kLnMaxC) / (32 * V);  // loads a lane
  const long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x % 32, nv = C / V;
  const float* xr = x + t * C;
  float v[PER * V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    if constexpr (VEC) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(xr) + e);
      v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z, v[4 * i + 3] = a.w;
      sum += (a.x + a.y) + (a.z + a.w);
    } else {
      v[i] = __ldg(xr + e);
      sum += v[i];
    }
  }
  const float mean = warp_sum(sum) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i >= nv) continue;
    if constexpr (VEC) {
      const float a = v[4 * i] - mean, b = v[4 * i + 1] - mean, c = v[4 * i + 2] - mean,
                  d = v[4 * i + 3] - mean;
      q += (a * a + b * b) + (c * c + d * d);
    } else {
      const float a = v[i] - mean;
      q += a * a;
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
  if (lane == 0 && stats != nullptr) {
    stats[2 * t] = mean;
    stats[2 * t + 1] = inv;
  }
  const float sr = RES ? __ldg(s + t / hw) : 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    if constexpr (VEC) {
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g) + e);
      const float4 bb = __ldg(reinterpret_cast<const float4*>(be) + e);
      float4 o = make_float4(
          (v[4 * i] - mean) * inv * gg.x + bb.x, (v[4 * i + 1] - mean) * inv * gg.y + bb.y,
          (v[4 * i + 2] - mean) * inv * gg.z + bb.z, (v[4 * i + 3] - mean) * inv * gg.w + bb.w);
      if constexpr (RES) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(res + t * C) + e);
        o = make_float4(r.x + sr * o.x, r.y + sr * o.y, r.z + sr * o.z, r.w + sr * o.w);
      }
      reinterpret_cast<float4*>(y + t * C)[e] = o;
    } else {
      const float o = (v[i] - mean) * inv * __ldg(g + e) + __ldg(be + e);
      y[t * C + e] = RES ? __ldg(res + t * C + e) + sr * o : o;
    }
  }
  if (dm != nullptr) {
    const float sc = __ldg(s + t / hw);
    for (int e = lane; e < nv; e += 32) {
      if constexpr (VEC) {
        const float4 d = __ldg(reinterpret_cast<const float4*>(dout + t * C) + e);
        reinterpret_cast<float4*>(dm + t * C)[e] =
            make_float4(sc * d.x, sc * d.y, sc * d.z, sc * d.w);
      } else {
        dm[t * C + e] = sc * __ldg(dout + t * C + e);
      }
    }
  }
}

// Issue the copies of chunk j: A (T, K) rows t0.. and, B_KMAJOR, W (N, K)
// rows n0.., else W (K, N) columns n0... VEC: 16-byte copies (K and N
// multiples of 4), else 4-byte ones.
template <int BN, bool B_KMAJOR, bool VEC = true>
__device__ __forceinline__ void load_wg_stage(float* st, const float* __restrict__ A,
                                              long long t0, long long T,
                                              const float* __restrict__ W, int n0, int N, int K,
                                              int j) {
  load_tile<kTcRows, kTcK, VEC>(st, kRowLd, A, K, t0, T, j * kTcK, K);
  if constexpr (B_KMAJOR)
    load_tile<BN, kTcK, VEC>(st + kTcRows * kRowLd, kRowLd, W, K, n0, N, j * kTcK, K);
  else
    load_tile<kTcK, BN, VEC>(st + kTcRows * kRowLd, BN + 8, W, N, j * kTcK, K, n0, N);
}

template <int BN, bool B_KMAJOR>
__device__ __forceinline__ void use_wg_stage(float (&acc)[BN / 2], const float* st, float* split,
                                             int j, AFrag<> (&af)[2]) {
  wgmma_chunk<BN, kTcK, true, B_KMAJOR>(acc, st, kRowLd, 16 * (threadIdx.x / 32),
                                  st + kTcRows * kRowLd, B_KMAJOR ? kRowLd : BN + 8, split, j, af);
}

// Row and column, in the block tile, of accumulator element i of a thread
// (the warpgroup layout of tc_gemm.cuh; warp w owns rows 16 w..16 w+15).
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// acc (this warpgroup's 64 x BN of the block tile) = A W over K: A (T, K)
// rows t0.., W (K, N) columns n0.. (N-major: transposed as it is split),
// promoted every PROMOTE chunks (tc_gemm.cuh). Chunk j of the product is
// chunk j0 + j of the block's split buffers.
template <int BN, bool VEC = true, int PROMOTE = kPromoteChunks>
__device__ __forceinline__ void xw_product(float (&acc)[BN / 2], Ring<>& ring, float* split,
                                           AFrag<> (&af)[2], const float* __restrict__ A,
                                           long long t0, long long T,
                                           const float* __restrict__ W, int n0, int N, int K,
                                           int j0) {
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring.run(
      (K + kTcK - 1) / kTcK,
      [&](int j, float* st) { load_wg_stage<BN, false, VEC>(st, A, t0, T, W, n0, N, K, j); },
      [&](int j, const float* st) {
        wgmma_chunk_promoted<BN, kTcK, true, false, PROMOTE>(
            acc, part, st, kRowLd, 16 * (threadIdx.x / 32), st + kTcRows * kRowLd, BN + 8, split,
            j0 + j, j, af);
      });
  wgmma_promote_last(acc, part);
}

// Per 128 tokens t0.. and BN columns n0..: out (T, N) = A (T, K) W (K, N)
// + b (EPI kLinearBias), its gelu_erf (kLinearGelu), or x + s[t / hw] (A W
// + b) (kLinearResidual, x (T, N)); W as it lies (N-major); a ragged last
// column tile is masked. BN is linear_cols(N). The column tiles of a
// token tile are neighbours in the grid, so A's rows come from L2 after the
// first. VEC: K and N multiples of 4 (16-byte copies, 8-byte loads and
// stores), else a float at a time. PROMOTE: as xw_product's.
template <int BN, bool VEC, int EPI, int PROMOTE = kPromoteChunks>
__global__ void __launch_bounds__(kThreads, 1)
    linear_kernel(const float* __restrict__ A, const float* __restrict__ W,
                  const float* __restrict__ b, const float* __restrict__ x,
                  const float* __restrict__ s, float* __restrict__ out, long long T,
                  long long hw, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* split = smem;
  Ring<> ring;
  ring.init(split + split_floats(BN), token_stage_floats(BN));
  const int ncol = (N + BN - 1) / BN;  // column tiles: the grid's fastest index
  const long long t0 = (long long)(blockIdx.x / ncol) * kTcRows;
  const int n0 = (int)(blockIdx.x % ncol) * BN;
  float acc[BN / 2];
  AFrag<> af[2];
  xw_product<BN, VEC, PROMOTE>(acc, ring, split, af, A, t0, T, W, n0, N, K, 0);
  // a thread's elements lie in two rows, acc_row(0) and 8 below it
  long long tr[2];
  float sc[2] = {1.f, 1.f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    tr[k] = t0 + acc_row(2 * k);
    if constexpr (EPI == kLinearResidual) sc[k] = tr[k] < T ? __ldg(s + tr[k] / hw) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i), k = (i / 2) % 2;
    const long long t = tr[k];
    if (c >= N || t >= T) continue;
    if constexpr (VEC) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
      float2 y = make_float2(acc[i] + bb.x, acc[i + 1] + bb.y);
      if constexpr (EPI == kLinearGelu) y = make_float2(gelu_erf(y.x), gelu_erf(y.y));
      if constexpr (EPI == kLinearResidual) {
        const float2 xv = __ldg(reinterpret_cast<const float2*>(x + t * N + c));
        y = make_float2(xv.x + sc[k] * y.x, xv.y + sc[k] * y.y);
      }
      *reinterpret_cast<float2*>(out + t * N + c) = y;
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (c + u >= N) break;
        float y = acc[i + u] + __ldg(b + c + u);
        if constexpr (EPI == kLinearGelu) y = gelu_erf(y);
        if constexpr (EPI == kLinearResidual) y = __ldg(x + t * N + c + u) + sc[k] * y;
        out[t * N + c + u] = y;
      }
    }
  }
}

// Per 128 tokens t0.. and 128 hidden units n0..: h = y w1 + b1, hg =
// gelu(h) (unless hg is null); dh = (dm w2^T) gelu'(h). y, dm (T, C); w1
// (C, hidden) read N-major (transposed as it is split), w2 (hidden, C)
// K-major; hg, dh (T, hidden). gelu'(h) waits in shared memory while the
// second product runs.
__global__ void __launch_bounds__(kThreads, 1)
    mlp_hidden_kernel(const float* __restrict__ y, const float* __restrict__ dm,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ hg,
                      float* __restrict__ dh, long long T, int C, int hidden) {
  constexpr int BN = kHidTile;
  extern __shared__ __align__(16) float smem[];
  float* gp = smem;  // gelu'(h), element e of thread i at gp[e * kThreads + i]
  float* split = gp + kGeluFloats;
  Ring<> ring;
  ring.init(split + split_floats(BN), token_stage_floats(BN));
  const long long t0 = (long long)blockIdx.x * kTcRows;
  const int n0 = blockIdx.y * kHidTile;
  const int nk = (C + kTcK - 1) / kTcK;
  float acc[BN / 2];
  AFrag<> af[2];
  xw_product<BN>(acc, ring, split, af, y, t0, T, w1, n0, hidden, C, 0);
  // h = acc + b1: gelu(h) to hg, gelu'(h) to gp
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i);
    const long long t = t0 + acc_row(i);
    if (c < hidden) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
      const float h0 = acc[i] + bb.x, h1 = acc[i + 1] + bb.y;
      if (hg != nullptr && t < T)
        *reinterpret_cast<float2*>(hg + t * hidden + c) = make_float2(gelu_erf(h0), gelu_erf(h1));
      gp[i * kThreads + threadIdx.x] = gelu_erf_grad(h0);
      gp[(i + 1) * kThreads + threadIdx.x] = gelu_erf_grad(h1);
    }
    acc[i] = 0.f;
    acc[i + 1] = 0.f;
  }
  ring.run(
      nk,
      [&](int j, float* st) { load_wg_stage<BN, true>(st, dm, t0, T, w2, n0, hidden, C, j); },
      [&](int j, const float* st) { use_wg_stage<BN, true>(acc, st, split, nk + j, af); });
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i);
    const long long t = t0 + acc_row(i);
    if (c < hidden && t < T)
      *reinterpret_cast<float2*>(dh + t * hidden + c) =
          make_float2(acc[i] * gp[i * kThreads + threadIdx.x],
                      acc[i + 1] * gp[(i + 1) * kThreads + threadIdx.x]);
  }
}

// Per 128 tokens t0.., every column (BN >= C): dy = A W^T with A (T, K) and
// W (C, K) as it lies (K-major). EPI kRowsStore: out = dy; kRowsResidual:
// out = dres + dy; kRowsLn: the
// LayerNorm backward of the rows, out = dres + inv (dy g - mean(dy g) - xn
// mean(dy g xn)) with xn = (xln - mean) inv from stats (T, 2); outs = s[t /
// hw] out when not null; the block's partial sums of dg = sum dy xn (first
// C) and dbe = sum dy (next C) to ln_part[blockIdx.x]. dy goes to a shared
// tile after the products; each warp then walks its own 16 rows, four at a
// time, reading xln and dres a row at a time with 16-byte loads.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    rows_kernel(const float* __restrict__ A, const float* __restrict__ W, long long T, int K,
                int C, const float* __restrict__ xln, const float* __restrict__ stats,
                const float* __restrict__ g, const float* __restrict__ dres,
                const float* __restrict__ s, long long hw, float* __restrict__ out,
                float* __restrict__ outs, float* __restrict__ ln_part) {
  constexpr int LDY = BN + 8;  // 8 mod 32: the tile's float2 stores hit 32 banks a half-warp
  extern __shared__ __align__(16) float smem[];
  float* split = smem;
  Ring<> ring;
  ring.init(split + split_floats(BN), token_stage_floats(BN));
  const long long t0 = (long long)blockIdx.x * kTcRows;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  AFrag<> af[2];
  ring.run(
      (K + kTcK - 1) / kTcK,
      [&](int j, float* st) { load_wg_stage<BN, true>(st, A, t0, T, W, 0, C, K, j); },
      [&](int j, const float* st) { use_wg_stage<BN, true>(acc, st, split, j, af); });
  wgmma_wait_all();
  __syncthreads();  // every warp is done with the buffers: they become the dy tile
  float* dy = smem;  // (128, LDY)
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    *reinterpret_cast<float2*>(dy + acc_row(i) * LDY + acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
  __syncwarp();  // a warp reads back only its own 16 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = C / 4;
  const float4* dy4 = reinterpret_cast<const float4*>(dy);
  if constexpr (EPI != kRowsLn) {
    for (int r = 16 * warp; r < 16 * warp + 16 && t0 + r < T; ++r)
      for (int c4 = lane; c4 < n4; c4 += 32) {
        float4 d = dy4[r * (LDY / 4) + c4];
        if constexpr (EPI == kRowsResidual) {
          const float4 rv = __ldg(reinterpret_cast<const float4*>(dres + (t0 + r) * C) + c4);
          d = make_float4(d.x + rv.x, d.y + rv.y, d.z + rv.z, d.w + rv.w);
        }
        reinterpret_cast<float4*>(out + (t0 + r) * C)[c4] = d;
      }
  } else {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 gv[2], cg[2] = {zero4, zero4}, cb[2] = {zero4, zero4};
#pragma unroll
    for (int v = 0; v < 2; ++v)
      gv[v] =
          lane + 32 * v < n4 ? __ldg(reinterpret_cast<const float4*>(g) + lane + 32 * v) : zero4;
    for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += 4) {
      float4 xv[4][2], rv[4][2];
      float mean[4], inv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long t = t0 + r0 + u;
        const bool ok = t < T;
        mean[u] = ok ? __ldg(stats + 2 * t) : 0.f;
        inv[u] = ok ? __ldg(stats + 2 * t + 1) : 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          const bool in = ok && c4 < n4;
          xv[u][v] = in ? __ldg(reinterpret_cast<const float4*>(xln + t * C) + c4) : zero4;
          rv[u][v] = in ? __ldg(reinterpret_cast<const float4*>(dres + t * C) + c4) : zero4;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u;
        const long long t = t0 + r;
        float4 d[2], xn[2];
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          d[v] = c4 < n4 ? dy4[r * (LDY / 4) + c4] : zero4;
          xn[v] = make_float4((xv[u][v].x - mean[u]) * inv[u], (xv[u][v].y - mean[u]) * inv[u],
                              (xv[u][v].z - mean[u]) * inv[u], (xv[u][v].w - mean[u]) * inv[u]);
          const float4 e = make_float4(d[v].x * gv[v].x, d[v].y * gv[v].y, d[v].z * gv[v].z,
                                       d[v].w * gv[v].w);
          sa += (e.x + e.y) + (e.z + e.w);
          sb += (e.x * xn[v].x + e.y * xn[v].y) + (e.z * xn[v].z + e.w * xn[v].w);
          cg[v] = make_float4(fmaf(d[v].x, xn[v].x, cg[v].x), fmaf(d[v].y, xn[v].y, cg[v].y),
                              fmaf(d[v].z, xn[v].z, cg[v].z), fmaf(d[v].w, xn[v].w, cg[v].w));
          cb[v] = make_float4(cb[v].x + d[v].x, cb[v].y + d[v].y, cb[v].z + d[v].z,
                              cb[v].w + d[v].w);
        }
        const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
        if (t >= T) continue;
        const float sc = outs != nullptr ? __ldg(s + t / hw) : 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          if (c4 >= n4) continue;
          const float4 dx = make_float4(
              rv[u][v].x + inv[u] * (d[v].x * gv[v].x - ma - xn[v].x * mb),
              rv[u][v].y + inv[u] * (d[v].y * gv[v].y - ma - xn[v].y * mb),
              rv[u][v].z + inv[u] * (d[v].z * gv[v].z - ma - xn[v].z * mb),
              rv[u][v].w + inv[u] * (d[v].w * gv[v].w - ma - xn[v].w * mb));
          reinterpret_cast<float4*>(out + t * C)[c4] = dx;
          if (outs != nullptr)
            reinterpret_cast<float4*>(outs + t * C)[c4] =
                make_float4(sc * dx.x, sc * dx.y, sc * dx.z, sc * dx.w);
        }
      }
    }
    float* colred = smem + kTcRows * LDY;  // [8 warps][dg | dbe][C]
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c4 = lane + 32 * v;
      if (c4 < n4) {
        reinterpret_cast<float4*>(colred + 2 * warp * C)[c4] = cg[v];
        reinterpret_cast<float4*>(colred + (2 * warp + 1) * C)[c4] = cb[v];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float dg = 0.f, db = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        dg += colred[2 * w * C + c];
        db += colred[(2 * w + 1) * C + c];
      }
      ln_part[(size_t)blockIdx.x * 2 * C + c] = dg;
      ln_part[(size_t)blockIdx.x * 2 * C + C + c] = db;
    }
  }
}

// ln_rows_kernel over the T rows: 16-byte rows where C is a multiple of 4
// (dm, the backwards' scaled gradient, needs them), else a float at a time.
inline cudaError_t ln_rows(const float* x, const float* g, const float* be, float* y,
                           float* stats, const float* dout, const float* s, float* dm,
                           long long T, long long hw, int C, float eps, cudaStream_t stream) {
  if (C > kLnMaxC || (C % 4 && dm != nullptr)) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kWarps - 1) / kWarps);
  if (C % 4 == 0)
    ln_rows_kernel<true><<<blocks, kThreads, 0, stream>>>(x, g, be, nullptr, y, stats, dout, s,
                                                          dm, T, hw, C, eps);
  else
    ln_rows_kernel<false><<<blocks, kThreads, 0, stream>>>(x, g, be, nullptr, y, stats, dout, s,
                                                           dm, T, hw, C, eps);
  return cudaGetLastError();
}

// The post-norm blocks' row pass: out = res + s[t / hw] LN(x) over the T
// rows of C <= kPnMaxC channels, g and be the LayerNorm's affine.
inline cudaError_t postnorm_rows(const float* x, const float* g, const float* be,
                                 const float* res, const float* s, float* out, long long T,
                                 long long hw, int C, float eps, cudaStream_t stream) {
  if (C > kPnMaxC) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kWarps - 1) / kWarps);
  if (C % 4 == 0)
    ln_rows_kernel<true, true><<<blocks, kThreads, 0, stream>>>(
        x, g, be, res, out, nullptr, nullptr, s, nullptr, T, hw, C, eps);
  else
    ln_rows_kernel<false, true><<<blocks, kThreads, 0, stream>>>(
        x, g, be, res, out, nullptr, nullptr, s, nullptr, T, hw, C, eps);
  return cudaGetLastError();
}

template <int BN, bool VEC, int EPI>
inline cudaError_t linear_launch(const float* A, const float* W, const float* b, const float* x,
                                 const float* s, float* out, long long T, long long hw, int K,
                                 int N, cudaStream_t stream) {
  const int smem = linear_smem_bytes(BN);
  const cudaError_t err = cudaFuncSetAttribute(
      linear_kernel<BN, VEC, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((T + kTcRows - 1) / kTcRows) * (unsigned)((N + BN - 1) / BN);
  linear_kernel<BN, VEC, EPI><<<grid, kThreads, smem, stream>>>(A, W, b, x, s, out, T, hw, K, N);
  return cudaGetLastError();
}

template <bool VEC, int EPI>
inline cudaError_t linear_vec(const float* A, const float* W, const float* b, const float* x,
                              const float* s, float* out, long long T, long long hw, int K, int N,
                              cudaStream_t stream) {
  switch (linear_cols(N)) {
    case 64:
      return linear_launch<64, VEC, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
    case 96:
      return linear_launch<96, VEC, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
    default:
      return linear_launch<kColTile, VEC, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
  }
}

// linear_kernel: out (T, N) = A (T, K) W (K, N) + b (EPI kLinearBias), its
// gelu_erf (kLinearGelu) or x + s[t / hw] (A W + b) (kLinearResidual).
template <int EPI = kLinearBias>
inline cudaError_t linear(const float* A, const float* W, const float* b, float* out, long long T,
                          int K, int N, cudaStream_t stream, const float* x = nullptr,
                          const float* s = nullptr, long long hw = 1) {
  return K % 4 == 0 && N % 4 == 0
             ? linear_vec<true, EPI>(A, W, b, x, s, out, T, hw, K, N, stream)
             : linear_vec<false, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
}

inline cudaError_t mlp_hidden(const float* y, const float* dm, const float* w1, const float* b1,
                              const float* w2, float* hg, float* dh, long long T, int C,
                              int hidden, cudaStream_t stream) {
  const int smem = hidden_smem_bytes();
  const cudaError_t err =
      cudaFuncSetAttribute(mlp_hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + kTcRows - 1) / kTcRows), (hidden + kHidTile - 1) / kHidTile);
  mlp_hidden_kernel<<<grid, kThreads, smem, stream>>>(y, dm, w1, b1, w2, hg, dh, T, C, hidden);
  return cudaGetLastError();
}

template <int BN, int EPI>
inline cudaError_t rows_launch(const float* A, const float* W, long long T, int K, int C,
                               const float* xln, const float* stats, const float* g,
                               const float* dres, const float* s, long long hw, float* out,
                               float* outs, float* ln_part, cudaStream_t stream) {
  const int smem = rows_smem_bytes(C);
  const cudaError_t err = cudaFuncSetAttribute(
      rows_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((T + kTcRows - 1) / kTcRows);
  rows_kernel<BN, EPI><<<blocks, kThreads, smem, stream>>>(A, W, T, K, C, xln, stats, g, dres, s,
                                                          hw, out, outs, ln_part);
  return cudaGetLastError();
}

// rows_kernel at the column tile of C (<= 256); W (C, K).
template <int EPI>
inline cudaError_t rows(const float* A, const float* W, long long T, int K, int C,
                        const float* xln, const float* stats, const float* g, const float* dres,
                        const float* s, long long hw, float* out, float* outs, float* ln_part,
                        cudaStream_t stream) {
  switch (rows_cols(C)) {
    case 64:
      return rows_launch<64, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                 ln_part, stream);
    case 128:
      return rows_launch<128, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                  ln_part, stream);
    case 192:
      return rows_launch<192, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                  ln_part, stream);
    default:
      return rows_launch<256, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                  ln_part, stream);
  }
}

}  // namespace trr
