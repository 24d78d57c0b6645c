// Shifted-window multi-head self-attention from packed qkv, forward and
// backward, fp32, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels of fused_window_mhsa and
// fused_rect_mhsa in trainner_redux_tpu/ops/pallas/window_attention.py:
//   forward  (_fwd_kernel, pallas_call at :337):
//       out (B, H, W, C) = window-MHSA(qkv (B, H, W, 3C), bias kinds (K, nh, n, n))
//   backward (_bwd_kernel, pallas_call at :371): dqkv (B, H, W, 3C) and
//       dbias (K, nh, n, n), the softmax recomputed from qkv and the bias
// with qkv's channels grouped [q | k | v] and heads contiguous in each, and
// n = wr * wc tokens per window of wr rows and wc columns: square 8x8 (n 64,
// SwinIR) and 16x16 (n 256, HAT), or DAT's rectangles of n 256 (8x32,
// 32x8) and n 128 (8x16, 16x8).
//
// What bounds them on the card. The ws-8 forward is bound by device memory:
// at SwinIR-M widths it does 0.76 GFLOP at 16,384 tokens against 47 MB moved
// (qkv in, out back). At ws 16 the work per token is four times larger and
// the forward (6 GFLOP at 32,768 tokens against 100 MB) and the backward
// (15 GFLOP against 180 MB) are bound by fp32 arithmetic. The designs read
// each qkv value once and keep every n x n tile on chip, so device memory
// sees nothing of that size but the backward's per-window dS, which the
// bias-kind reduction needs:
//   - window_mhsa_fwd_kernel (ws 8): one thread block per (8x8 window,
//     head) stages that head's q, k (transposed) and v, builds the 64x64
//     scores with the bias of the window's kind, takes the row softmax and
//     writes P v straight to the output; 42 KB of shared memory.
//   - window_mhsa_rows_fwd_kernel<N> (N 128 or 256): one block per (window,
//     head) stages k and v of the window's N tokens once and walks the
//     queries in blocks of 64 rows: a 64 x 256 score tile (64 KB) does fit
//     one block where the whole 256 x 256 tile (256 KB) does not. The row
//     softmax is taken in registers and the rows go through shared memory
//     to the P v product; 138 KB of shared memory at N 256 and head_dim 30.
//   - the backward is tc_attn.cuh's attn_rows_bwd_tc_kernel, #6's window
//     attention without its att output: one block per (window, head), the
//     heads fastest in the grid, query rows in blocks of 64: recompute P,
//     then dV += P^T dO, dP = dO v^T, dS = P (dP - rowsum(P dP)), dQ =
//     scale dS k (written per row block) and dK += scale dS^T q, five
//     products a row block on mma.sync in 3xTF32 (bound: 3 x its 15 GFLOP
//     at HAT-M's block on the tensor cores). dK and dV of the
//     window sum over every row block, so they stay in registers across the
//     blocks. At n 256 four warps share a 16-row tile, each over a quarter
//     of the keys, so a thread holds 32 floats of S or dP and 32 of dK and
//     dV: 16 warps, 172,032 B and one block a SM. At n 128 four warps
//     share a tile of a 32-row block, at n 64 two warps one of a 64-row
//     block, two blocks a SM. q, k, v and dO arrive a head row at a
//     time through shared memory, the bias rows with 16-byte loads, and dq,
//     dk, dv leave the same way. dS of each (window, head) goes to a buffer
//     shaped as the windows' P, and dbias_kernel (common.cuh) adds it over
//     the windows of each kind in window order: no atomics, two runs are
//     bit-identical.
// The kernels take no shift: the caller rolls qkv and the output, as the
// JAX package's contract has it. The forwards' products run on the fp32
// FMA units.
#include "tc_attn.cuh"

namespace trr {

// Index (into the B*H*W tokens) of token r, row-major, of the wr x wc
// window (wi, wj) of sample b.
__device__ __forceinline__ long long win_token(int b, int wi, int wj, int r, int H, int W,
                                               int wr, int wc) {
  return ((long long)b * H + wi * wr + r / wc) * W + wj * wc + r % wc;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int window_mhsa_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return 2 * hd * kTLd + kTile * kVLd + kTile * kTLd;
}

// Shared memory of the row-block forward (N = 128 or 256): this row block's q (hd, 64)
// transposed, k (hd, N) transposed, v (N, 32), the P rows (64, N + 4).
__host__ __device__ inline int window_mhsa_rows_smem_floats(int N, int hd) {
  return hd * kTLd + hd * N + N * kVLd + kTile * (N + 4);
}

__global__ void __launch_bounds__(kThreads)
    window_mhsa_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                           float* __restrict__ out, int H, int W, int C, int nh, int kinds,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh;
  const int nww = W / 8, nwh = H / 8;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y, h = blockIdx.z;
  float* qT = smem;
  float* kT = qT + hd * kTLd;
  float* v = kT + hd * kTLd;
  float* S = v + kTile * kVLd;
  const int kind = window_kind(kinds, wi, wj, nwh, nww);

  for (int e = threadIdx.x; e < 3 * kTile * hd; e += kThreads) {
    const int part = e / (kTile * hd), rem = e % (kTile * hd);
    const int r = rem / hd, d = rem % hd;
    const long long t = window_token(b, wi, wj, r, H, W, 0);
    const float val = __ldg(qkv + t * 3 * C + part * C + h * hd + d);
    if (part == 2) {
      v[r * kVLd + d] = val;
    } else {
      (part == 0 ? qT : kT)[d * kTLd + r] = val;
    }
  }
  __syncthreads();
  attention_head(qT, kT, v, hd, scale, bias + ((size_t)kind * nh + h) * kTile * kTile, S,
                 nullptr, [&](int r0, int d, const float* o) {
#pragma unroll
                   for (int i = 0; i < 4; ++i)
                     out[window_token(b, wi, wj, r0 + i, H, W, 0) * C + h * hd + d] = o[i];
                 });
}

// P (64 x N) of one block of 64 query rows against the window's N keys,
// left in registers: S = q k^T * scale + bias, then the row softmax.
//   qT    (hd, kTLd) the block's q, transposed;
//   kT    (hd, N) the window's k, transposed;
//   bias  (64, N) rows of this window kind's and head's table (global / L2).
// Thread (rg, cl) holds rows rg*4 + i and columns jj*64 + cl*4 + e in
// p[i][jj*4 + e]; a row's 16 threads are one half-warp, which reduces it.
template <int N>
__device__ __forceinline__ void softmax_rows(const float* qT, const float* kT, int hd,
                                             float scale, const float* __restrict__ bias,
                                             float (&p)[4][N / 16]) {
  constexpr int JJ = N / 64;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) p[i][j] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float4 a = ld4(qT + d * kTLd + rg * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const float4 bk = ld4(kT + d * N + jj * 64 + cl * 4);
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][jj * 4 + e] = fmaf(av[i], bv[e], p[i][jj * 4 + e]);
    }
  }
  // per-row max and sum (the JAX kernels take one max per tile; a per-row
  // max is the softmax of the plain reference and guards each row alone)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* brow = bias + (size_t)(rg * 4 + i) * N + cl * 4;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const float4 bb = __ldg(reinterpret_cast<const float4*>(brow + jj * 64));
      p[i][jj * 4 + 0] = p[i][jj * 4 + 0] * scale + bb.x;
      p[i][jj * 4 + 1] = p[i][jj * 4 + 1] * scale + bb.y;
      p[i][jj * 4 + 2] = p[i][jj * 4 + 2] * scale + bb.z;
      p[i][jj * 4 + 3] = p[i][jj * 4 + 3] * scale + bb.w;
    }
    float m = p[i][0];
#pragma unroll
    for (int j = 1; j < N / 16; ++j) m = fmaxf(m, p[i][j]);
    m = half_warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      p[i][j] = expf(p[i][j] - m);
      sum += p[i][j];
    }
    const float inv = 1.f / half_warp_sum(sum);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) p[i][j] *= inv;
  }
}

// The rows p of softmax_rows into the (64, N + 4) tile T.
template <int N>
__device__ __forceinline__ void store_rows(const float (&p)[4][N / 16], float* T) {
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < N / 64; ++jj)
      *reinterpret_cast<float4*>(T + (rg * 4 + i) * (N + 4) + jj * 64 + cl * 4) =
          make_float4(p[i][jj * 4], p[i][jj * 4 + 1], p[i][jj * 4 + 2], p[i][jj * 4 + 3]);
}

// One block per (wr x wc window, head), N = wr * wc a multiple of 64; the
// query rows in blocks of 64.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    window_mhsa_rows_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                                float* __restrict__ out, int H, int W, int C, int nh, int kinds,
                                int wr, int wc, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / wc, nwh = H / wr;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y, h = blockIdx.z;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  float* qT = smem;                 // (hd, 64) this row block's q
  float* kT = qT + hd * kTLd;       // (hd, N)
  float* v = kT + hd * N;           // (N, 32)
  float* P = v + N * kVLd;          // (64, N + 4)
  auto token = [&](int r) { return win_token(b, wi, wj, r, H, W, wr, wc); };
  const int kind = window_kind(kinds, wi, wj, nwh, nww);
  const float* table = bias + ((size_t)kind * nh + h) * N * N;

  for (int e = threadIdx.x; e < N * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const float* src = qkv + token(r) * C3 + h * hd + d;
    kT[d * N + r] = __ldg(src + C);
    v[r * kVLd + d] = __ldg(src + 2 * C);
  }
  for (int r0 = 0; r0 < N; r0 += kTile) {
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      qT[d * kTLd + r] = __ldg(qkv + token(r0 + r) * C3 + h * hd + d);
    }
    __syncthreads();  // q (and, the first time, k and v) staged
    float p[4][N / 16];
    softmax_rows<N>(qT, kT, hd, scale, table + (size_t)r0 * N, p);
    store_rows<N>(p, P);
    __syncthreads();
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    const float* prow = P + rg * 4 * (N + 4);
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(v + j * kVLd + cl * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = prow[i * (N + 4) + j];
        acc[i][0] = fmaf(a, vv.x, acc[i][0]);
        acc[i][1] = fmaf(a, vv.y, acc[i][1]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int d = cl * 2 + jj;
      if (d < hd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[token(r0 + rg * 4 + i) * C + h * hd + d] = acc[i][jj];
      }
    }
    __syncthreads();  // q and P are rewritten by the next row block
  }
}

}  // namespace trr

extern "C" {

size_t trr_rect_mhsa_smem_bytes(int C, int nh, int wr, int wc) {
  const int floats = wr == 8 && wc == 8 ? trr::window_mhsa_smem_floats(C, nh)
                                        : trr::window_mhsa_rows_smem_floats(wr * wc, C / nh);
  return (size_t)floats * sizeof(float);
}

size_t trr_rect_mhsa_bwd_smem_bytes(int C, int nh, int wr, int wc) {
  const int n = wr * wc;
  const trr::AttnPlan plan = trr::attn_plan(n);
  return (size_t)trr::attn_rows_bwd_tc_smem_floats(n, plan.rb, plan.ks, false) * sizeof(float);
}

size_t trr_window_mhsa_smem_bytes(int C, int nh, int ws) {
  return trr_rect_mhsa_smem_bytes(C, nh, ws, ws);
}

size_t trr_window_mhsa_bwd_smem_bytes(int C, int nh, int ws) {
  return trr_rect_mhsa_bwd_smem_bytes(C, nh, ws, ws);
}

// qkv (B, H, W, 3C), out (B, H, W, C), bias (kinds, nh, n, n), windows of
// wr rows and wc columns, n = wr * wc: 8x8, or any wr x wc with n 128 or
// 256. H is a multiple of wr, W of wc; C / nh <= 32.
int trr_rect_mhsa_fwd(const float* qkv, const float* bias, float* out, int B, int H, int W,
                      int C, int nh, int kinds, int wr, int wc, float scale,
                      cudaStream_t stream) {
  const size_t smem = trr_rect_mhsa_smem_bytes(C, nh, wr, wc);
  const dim3 grid((H / wr) * (W / wc), B, nh);
  const int n = wr * wc;
  cudaError_t err;
  if (wr == 8 && wc == 8) {
    err = cudaFuncSetAttribute(trr::window_mhsa_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    trr::window_mhsa_fwd_kernel<<<grid, trr::kThreads, smem, stream>>>(qkv, bias, out, H, W, C,
                                                                        nh, kinds, scale);
  } else if (n == 256) {
    err = cudaFuncSetAttribute(trr::window_mhsa_rows_fwd_kernel<256>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    trr::window_mhsa_rows_fwd_kernel<256><<<grid, trr::kThreads, smem, stream>>>(
        qkv, bias, out, H, W, C, nh, kinds, wr, wc, scale);
  } else if (n == 128) {
    err = cudaFuncSetAttribute(trr::window_mhsa_rows_fwd_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    trr::window_mhsa_rows_fwd_kernel<128><<<grid, trr::kThreads, smem, stream>>>(
        qkv, bias, out, H, W, C, nh, kinds, wr, wc, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Square ws x ws windows: ws 8 or 16.
int trr_window_mhsa_fwd(const float* qkv, const float* bias, float* out, int B, int H, int W,
                        int C, int nh, int kinds, int ws, float scale, cudaStream_t stream) {
  if (ws != 8 && ws != 16) return (int)cudaErrorInvalidValue;
  return trr_rect_mhsa_fwd(qkv, bias, out, B, H, W, C, nh, kinds, ws, ws, scale, stream);
}

// The backward: qkv, bias as in the forward, dout (B, H, W, C); writes
// dqkv (B, H, W, 3C), dS (B, H/wr, W/wc, nh, n, n) scratch and
// dbias (kinds, nh, n, n). n = wr * wc is 64, 128 or 256.
int trr_rect_mhsa_bwd(const float* qkv, const float* bias, const float* dout, float* dqkv,
                      float* dS, float* dbias, int B, int H, int W, int C, int nh, int kinds,
                      int wr, int wc, float scale, cudaStream_t stream) {
  const int n = wr * wc;
  cudaError_t err;
  if (n == 64) {
    err = trr::attn_rows_bwd_tc<64, false>(qkv, bias, dout, dqkv, nullptr, dS, B, H, W, C, nh, wr,
                                           wc, kinds, 0, scale, stream);
  } else if (n == 128) {
    err = trr::attn_rows_bwd_tc<128, false>(qkv, bias, dout, dqkv, nullptr, dS, B, H, W, C, nh,
                                            wr, wc, kinds, 0, scale, stream);
  } else if (n == 256) {
    err = trr::attn_rows_bwd_tc<256, false>(qkv, bias, dout, dqkv, nullptr, dS, B, H, W, C, nh,
                                            wr, wc, kinds, 0, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)trr::launch_dbias(dS, B, H / wr, W / wc, nh, kinds, n * n, dbias, stream);
}

// Square ws x ws windows: ws 8 or 16.
int trr_window_mhsa_bwd(const float* qkv, const float* bias, const float* dout, float* dqkv,
                        float* dS, float* dbias, int B, int H, int W, int C, int nh, int kinds,
                        int ws, float scale, cudaStream_t stream) {
  if (ws != 8 && ws != 16) return (int)cudaErrorInvalidValue;
  return trr_rect_mhsa_bwd(qkv, bias, dout, dqkv, dS, dbias, B, H, W, C, nh, kinds, ws, ws,
                           scale, stream);
}

}  // extern "C"
