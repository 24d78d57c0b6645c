// Shifted-window multi-head self-attention from packed qkv, forward, fp32,
// for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel fused_window_mhsa
// (_fwd_kernel) in trainner_redux_tpu/ops/pallas/window_attention.py:
//   out (B, H, W, C) = window-MHSA(qkv (B, H, W, 3C), bias kinds (K, nh, 64, 64))
// with qkv's channels grouped [q | k | v] and heads contiguous in each.
//
// What bounds it on the card: device memory. At SwinIR-M widths the
// attention does 0.76 GFLOP at 16,384 tokens against 47 MB moved (qkv in,
// out back), under the card's fp32 ridge point. The design reads each qkv
// value once and writes each output once: one thread block per (8x8
// window, head) stages that head's q, k (transposed) and v in shared
// memory, builds the 64x64 scores with the bias of the window's kind there,
// takes the row softmax and writes P v straight to the output. Nothing of
// size 64x64 reaches device memory, the (K, nh, 64, 64) kind table stays in
// L2, and a block needs 42 KB of shared memory, so several blocks share an
// SM and hide each other's load latency.
#include "common.cuh"

namespace trr {

__host__ __device__ inline int window_mhsa_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return 2 * hd * kTLd + kTile * kVLd + kTile * kTLd;
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
                 [&](int r0, int d, const float* o) {
#pragma unroll
                   for (int i = 0; i < 4; ++i)
                     out[window_token(b, wi, wj, r0 + i, H, W, 0) * C + h * hd + d] = o[i];
                 });
}

}  // namespace trr

extern "C" {

size_t trr_window_mhsa_smem_bytes(int C, int nh) {
  return (size_t)trr::window_mhsa_smem_floats(C, nh) * sizeof(float);
}

// qkv (B, H, W, 3C), out (B, H, W, C), bias (kinds, nh, 64, 64). Windows
// are 8x8; H and W are multiples of 8; C / nh <= 32.
int trr_window_mhsa_fwd(const float* qkv, const float* bias, float* out, int B, int H, int W,
                        int C, int nh, int kinds, float scale, cudaStream_t stream) {
  const size_t smem = trr_window_mhsa_smem_bytes(C, nh);
  const cudaError_t err = cudaFuncSetAttribute(
      trr::window_mhsa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / 8) * (W / 8), B, nh);
  trr::window_mhsa_fwd_kernel<<<grid, trr::kThreads, smem, stream>>>(qkv, bias, out, H, W, C,
                                                                      nh, kinds, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
