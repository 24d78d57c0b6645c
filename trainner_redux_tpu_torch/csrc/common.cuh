// Shared device code of the port's Swin block kernels: the block-wide fp32
// GEMMs, row LayerNorm and the attention of one window and one head. Every
// kernel here runs 256 threads per block on tiles of 64 tokens (one 8x8
// window, or 64 consecutive tokens).
//
// Layout contract (that of the JAX package's Pallas kernels): activations
// are NHWC and contiguous, weights are (in, out) row-major, and the bias
// table is (K, nh, 64, 64) fp32. K = 1 (one kind, unshifted) or 4
// (shifted: interior, right edge, bottom edge, corner); the kind of a
// window is 2 * is_bottom_row + is_rightmost_column.
//
// Tiles in shared memory are kept TRANSPOSED (feature-major, "At[k][r]",
// row stride kTLd) wherever they are the left operand of a GEMM, so that a
// thread's four rows are one 16-byte load; the right operand's columns of a
// thread are contiguous too. The thread grid of every GEMM is 16 row groups
// (4 rows each) by 16 column lanes (CT columns each).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace trr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // tokens of a tile: one 8x8 window
constexpr int kTLd = kTile + 4;      // row stride of a transposed tile (16-byte rows)
constexpr int kLanes = 16;           // column lanes (and row groups) of a GEMM
constexpr int kKChunk = 32;          // rows of B staged in shared memory at a time
constexpr int kWeightCT = 6;         // columns per thread of the weight GEMMs
constexpr int kWeightNC = kLanes * kWeightCT;  // 96 columns per chunk
constexpr int kVLd = 32;             // row stride of v: head_dim <= 32

// Floats of the staging buffers of one weight GEMM (double-buffered).
constexpr int kStageFloats = 2 * kKChunk * kWeightNC;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float gelu_erf(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  return cdf + h * expf(-0.5f * h * h) * 0.39894228040143268f;
}

// Allow `kernel` `floats` floats of dynamic shared memory.
template <class Kernel>
cudaError_t set_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

// C (64 x N) = A (64 x K) B[:, bcol(0..N-1)]:
//   At  transposed A in shared memory, At[k * kTLd + r];
//   B   (K x ldb) row-major in device memory, read through L2 and staged
//       kKChunk rows at a time in Bs (kStageFloats), double-buffered: the
//       next chunk's loads are in flight while this one is multiplied.
// out(r0, c, v) receives rows r0..r0+3 of column c (v[0..3]) for every
// c < N; rows are always the full 64.
template <class BCol, class Out>
__device__ __forceinline__ void gemm_weights(const float* At, int K,
                                             const float* __restrict__ B, int ldb, int N,
                                             BCol bcol, float* Bs, Out out) {
  constexpr int CT = kWeightCT, NC = kWeightNC;
  constexpr int PER = kKChunk * NC / kThreads;  // staged floats per thread
  static_assert(kKChunk * NC % kThreads == 0, "staging must split evenly");
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  int buf = 0;
  __syncthreads();  // Bs and At are free and written
  for (int n0 = 0; n0 < N; n0 += NC) {
    int gcol[PER], krow[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * kThreads;
      krow[i] = e / NC;
      gcol[i] = bcol(min(n0 + e % NC, N - 1));
    }
    float reg[PER];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + krow[i];
        reg[i] = k < K ? __ldg(B + (size_t)k * ldb + gcol[i]) : 0.f;
      }
    };
    float acc[4][CT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kKChunk) {
      float* bs = Bs + buf * (kKChunk * NC);
#pragma unroll
      for (int i = 0; i < PER; ++i) bs[threadIdx.x + i * kThreads] = reg[i];
      __syncthreads();
      if (k0 + kKChunk < K) fetch(k0 + kKChunk);
      const float* a_col = At + (size_t)k0 * kTLd + rg * 4;
      const float* b_row = bs + cl * CT;
      auto step = [&](int kc) {
        const float4 a = ld4(a_col + kc * kTLd);
        float b[CT];
#pragma unroll
        for (int j = 0; j < CT; j += 2) {
          const float2 t = *reinterpret_cast<const float2*>(b_row + kc * NC + j);
          b[j] = t.x;
          b[j + 1] = t.y;
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          acc[0][j] = fmaf(a.x, b[j], acc[0][j]);
          acc[1][j] = fmaf(a.y, b[j], acc[1][j]);
          acc[2][j] = fmaf(a.z, b[j], acc[2][j]);
          acc[3][j] = fmaf(a.w, b[j], acc[3][j]);
        }
      };
      if (K - k0 >= kKChunk) {  // a full chunk: a fixed trip count the compiler pipelines
#pragma unroll
        for (int kc = 0; kc < kKChunk; ++kc) step(kc);
      } else {
        for (int kc = 0; kc < K - k0; ++kc) step(kc);
      }
      buf ^= 1;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = n0 + cl * CT + j;
      if (c < N) {
        const float v[4] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
        out(rg * 4, c, v);
      }
    }
  }
}

// LayerNorm of the M <= 64 rows row(r) (C contiguous fp32 each, in device
// memory) into the transposed tile dstT[c * kTLd + r]; rows M..63 become 0.
// Two-pass mean and variance, as the JAX package's _ln_f32. `scratch`
// holds 64 * (C + 1) floats and `stats` 128 floats.
template <class Row>
__device__ __forceinline__ void layernorm_t(Row row, int M, int C, const float* __restrict__ g,
                                            const float* __restrict__ b, float eps,
                                            float* scratch, float* stats, float* dstT) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldx = C + 1;  // odd: the transposing reads below hit distinct banks
  for (int r = warp; r < kTile; r += kWarps) {
    if (r >= M) continue;
    float* xs = scratch + r * ldx;
    const float* x = row(r);
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = __ldg(x + c);
      xs[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xs[c] - mean;
      q += v * v;
    }
    const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
    if (lane == 0) {
      stats[r] = mean;
      stats[kTile + r] = inv;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int c = e / kTile, r = e % kTile;
    dstT[c * kTLd + r] =
        r < M ? (scratch[r * ldx + c] - stats[r]) * stats[kTile + r] * __ldg(g + c) + __ldg(b + c)
              : 0.f;
  }
}

// Attention of one 64-token window and one head, operands in shared memory:
// qT, kT (hd, kTLd) transposed, v (64, kVLd) row-major, S a (64, kTLd)
// scratch tile, bias the (64, 64) table of this window's kind and head.
//   S = q k^T * scale + bias;  P = row softmax(S);  out(r0, d, (P v)[r0..r0+3, d]).
// When `P_out` is not null, P is also written there, (64, 64) row-major.
// The caller synchronises before (q, k, v written) and after (S reused).
template <class Out>
__device__ __forceinline__ void attention_head(const float* qT, const float* kT, const float* v,
                                               int hd, float scale,
                                               const float* __restrict__ bias, float* S,
                                               float* __restrict__ P_out, Out out) {
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = ld4(qT + d * kTLd + rg * 4);
      const float4 b = ld4(kT + d * kTLd + cl * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + r * kTile + cl * 4));
      *reinterpret_cast<float4*>(S + r * kTLd + cl * 4) =
          make_float4(acc[i][0] * scale + bb.x, acc[i][1] * scale + bb.y,
                      acc[i][2] * scale + bb.z, acc[i][3] * scale + bb.w);
    }
  }
  __syncthreads();
  // per-row max and sum (the JAX kernels take one max per tile; a per-row
  // max is the softmax of the plain reference and guards each row alone)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kWarps) {
    float* s = S + r * kTLd;
    const float s0 = s[lane], s1 = s[lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = expf(s0 - m), p1 = expf(s1 - m);
    const float inv = 1.f / warp_sum(p0 + p1);
    s[lane] = p0 * inv;
    s[lane + 32] = p1 * inv;
    if (P_out != nullptr) {
      P_out[r * kTile + lane] = p0 * inv;
      P_out[r * kTile + lane + 32] = p1 * inv;
    }
  }
  __syncthreads();
  {
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    const float* p = S + rg * 4 * kTLd;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(v + j * kVLd + cl * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = p[i * kTLd + j];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = cl * 2 + j;
      if (d < hd) {
        const float o[4] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
        out(rg * 4, d, o);
      }
    }
  }
}

// Index (into the B*H*W tokens) of token r of the 8x8 window (b, wi, wj)
// of the map cyclically rolled by (-shift, -shift): the token at rolled
// (y, x) is the one at ((y + shift) mod H, (x + shift) mod W). With
// 0 <= shift < min(H, W) the sum wraps at most once.
__device__ __forceinline__ long long window_token(int b, int wi, int wj, int r, int H, int W,
                                                  int shift) {
  int y = wi * 8 + r / 8 + shift, x = wj * 8 + r % 8 + shift;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
  return ((long long)b * H + y) * W + x;
}

__device__ __forceinline__ int window_kind(int kinds, int wi, int wj, int nwh, int nww) {
  return kinds == 1 ? 0 : 2 * (wi == nwh - 1) + (wj == nww - 1);
}

// dbias[kind][h] = the sum of dS over the windows of that kind, windows in
// order; dS (B, nwh, nww, nh, nn) with nn = n * n entries per window and
// head. One thread per (head, entry): no atomics, the same sums every run.
__global__ void __launch_bounds__(kThreads)
    dbias_kernel(const float* __restrict__ dS, int B, int nwh, int nww, int nh, int kinds,
                 int nn, float* __restrict__ dbias) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)nh * nn) return;
  const int h = (int)(idx / nn), e = (int)(idx % nn);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < B; ++b)
    for (int wi = 0; wi < nwh; ++wi)
      for (int wj = 0; wj < nww; ++wj) {
        const float v = __ldg(dS + ((((size_t)b * nwh + wi) * nww + wj) * nh + h) * nn + e);
        const int kind = window_kind(kinds, wi, wj, nwh, nww);
        if (kind == 0) acc[0] += v;
        else if (kind == 1) acc[1] += v;
        else if (kind == 2) acc[2] += v;
        else acc[3] += v;
      }
  for (int kind = 0; kind < kinds; ++kind) dbias[((size_t)kind * nh + h) * nn + e] = acc[kind];
}

inline cudaError_t launch_dbias(const float* dS, int B, int nwh, int nww, int nh, int kinds,
                                int nn, float* dbias, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long long)nh * nn + kThreads - 1) / kThreads);
  dbias_kernel<<<blocks, kThreads, 0, stream>>>(dS, B, nwh, nww, nh, kinds, nn, dbias);
  return cudaGetLastError();
}

}  // namespace trr
