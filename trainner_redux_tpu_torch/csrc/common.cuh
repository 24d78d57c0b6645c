// Shared device code of the port's Swin block kernels: warp reductions, the
// exact gelu and its derivative, the window indexing and the bias-kind
// sums. Every kernel here runs 256 threads per block.
//
// Layout contract (that of the JAX package's Pallas kernels): activations
// are NHWC and contiguous, weights are (in, out) row-major, and the bias
// table is (K, nh, 64, 64) fp32. K = 1 (one kind, unshifted) or 4
// (shifted: interior, right edge, bottom edge, corner); the kind of a
// window is 2 * is_bottom_row + is_rightmost_column.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace trr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // tokens of an 8x8 window

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
// head. No atomics: the same sums every run. Two passes over groups of
// kDbiasGroup consecutive windows (the last group takes the rest):
// dbias_groups_kernel, one thread per (group, head, entry), sums its
// group's windows by kind in order and writes the kind sums over the
// entries of the group's first `kinds` windows, in place (dS is scratch);
// dbias_sum_kernel, one thread per (kind, head, entry), adds the groups'
// sums in order. Fewer than two groups, or enough (head, entry) threads to
// fill the card alone (16x16 windows), take one pass, dbias_kernel.
constexpr int kDbiasGroup = 16;
constexpr long long kDbiasWide = 1 << 18;

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

__global__ void __launch_bounds__(kThreads)
    dbias_groups_kernel(float* __restrict__ dS, int nwin, int nwh, int nww, int kinds,
                        long long per_window, int groups) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)groups * per_window) return;
  const int grp = (int)(idx / per_window);
  const long long off = idx % per_window;
  const int w0 = grp * kDbiasGroup, w1 = grp == groups - 1 ? nwin : w0 + kDbiasGroup;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int w = w0; w < w1; ++w) {
    const float v = dS[(size_t)w * per_window + off];
    const int kind = window_kind(kinds, (w / nww) % nwh, w % nww, nwh, nww);
    if (kind == 0) acc[0] += v;
    else if (kind == 1) acc[1] += v;
    else if (kind == 2) acc[2] += v;
    else acc[3] += v;
  }
  for (int kind = 0; kind < kinds; ++kind) dS[(size_t)(w0 + kind) * per_window + off] = acc[kind];
}

__global__ void __launch_bounds__(kThreads)
    dbias_sum_kernel(const float* __restrict__ dS, int kinds, long long per_window, int groups,
                     float* __restrict__ dbias) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)kinds * per_window) return;
  const int kind = (int)(idx / per_window);
  const long long off = idx % per_window;
  float acc = 0.f;
  for (int grp = 0; grp < groups; ++grp)
    acc += __ldg(dS + (size_t)(grp * kDbiasGroup + kind) * per_window + off);
  dbias[idx] = acc;
}

inline cudaError_t launch_dbias(float* dS, int B, int nwh, int nww, int nh, int kinds, int nn,
                                float* dbias, cudaStream_t stream) {
  const int nwin = B * nwh * nww, groups = nwin / kDbiasGroup;
  const long long per_window = (long long)nh * nn;
  if (groups < 2 || per_window >= kDbiasWide) {
    const unsigned blocks = (unsigned)((per_window + kThreads - 1) / kThreads);
    dbias_kernel<<<blocks, kThreads, 0, stream>>>(dS, B, nwh, nww, nh, kinds, nn, dbias);
    return cudaGetLastError();
  }
  dbias_groups_kernel<<<(unsigned)((groups * per_window + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(dS, nwin, nwh, nww, kinds, per_window, groups);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dbias_sum_kernel<<<(unsigned)((kinds * per_window + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(dS, kinds, per_window, groups, dbias);
  return cudaGetLastError();
}

}  // namespace trr
