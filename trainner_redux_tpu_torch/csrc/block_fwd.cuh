// The forward kernels of the fused pre-LN Swin block halves, fp32, shared by
// the serving library (fused_block.cu), the training library
// (fused_block_train.cu) and the attention half's training form
// (attn_block_staged.cu).
//
//   attn_block_fwd_kernel: z = x + s[b] * proj(window-MHSA(qkv(LN1 x)) + bias kind)
//                          and, for training, the softmax P of every window
//                          and head and the attention output att;
//   ln_mlp_fwd_kernel:     out = x + s[b] * fc2(gelu_erf(fc1(LN2 x)))
//
// What bounds them on the card: at SwinIR-M widths (C 180, 6 heads of 30,
// hidden 360) both are bound by fp32 arithmetic, 5.0 and 4.25 GFLOP at
// 16,384 tokens against some 24 MB of activations, far above the card's
// fp32 ridge point. The design keeps every intermediate of a block half in
// shared memory, so device memory sees each activation once in and once
// out, as in the TPU kernels' VMEM-resident strips: one thread block per
// 8x8 window (attention half) or per 64 tokens (MLP half). The LayerNorm
// output, the attention output and the MLP hidden state stay on chip as
// transposed (C, 64) tiles; one head's q, k, v and scores at a time.
// Weights stream from the L2 cache (0.5 MB per half, resident there)
// through a double-buffered shared-memory stage, so the FMA loops read only
// shared memory, 16-byte rows of A and 8-byte pairs of B per step.
// The GEMMs run on the fp32 FMA units (4x6 outputs per thread); the tensor
// cores (wgmma in TF32 or bf16) and TMA staging are later work.
#pragma once

#include "common.cuh"

namespace trr {

// Shared memory of the attention half, in floats: the LN tile and the
// attention tile (C, 64) transposed, one head's q and k (hd, 64)
// transposed and v (64, 32), the score tile, the weight stage, LN stats.
__host__ __device__ inline int attn_block_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return 2 * C * kTLd + 2 * hd * kTLd + kTile * kVLd + kTile * kTLd + kStageFloats + 2 * kTile;
}

// Shared memory of the MLP half, in floats: the LN tile (C, 64) and the
// hidden tile (hidden, 64) transposed, the weight stage, LN stats.
__host__ __device__ inline int ln_mlp_smem_floats(int C, int hidden) {
  return C * kTLd + hidden * kTLd + kStageFloats + 2 * kTile;
}

// One block per 8x8 window of x rolled by (-shift, -shift); z comes back in
// x's frame. P (B, H/8, W/8, nh, 64, 64), the row softmax of each window and
// head in the rolled frame, and att (B, H, W, C), the attention output in
// x's frame, are written when not null (training saves them).
// One block per SM (shared memory allows no more): all 255 registers are free.
__global__ void __launch_bounds__(kThreads, 1)
    attn_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ be, const float* __restrict__ wq,
                          const float* __restrict__ bq, const float* __restrict__ wp,
                          const float* __restrict__ bp, const float* __restrict__ bias,
                          const float* __restrict__ s, float* __restrict__ z,
                          float* __restrict__ P, float* __restrict__ att, int H, int W,
                          int C, int nh, int kinds, int shift, float eps, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh;
  const int nww = W / 8, nwh = H / 8;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y;
  float* yT = smem;                 // (C, 64) LN1 output
  float* attT = yT + C * kTLd;      // (C, 64) attention output; LN scratch before
  float* qT = attT + C * kTLd;      // (hd, 64)
  float* kT = qT + hd * kTLd;       // (hd, 64)
  float* v = kT + hd * kTLd;        // (64, 32)
  float* S = v + kTile * kVLd;      // (64, 64) scores, then probabilities
  float* Bs = S + kTile * kTLd;     // weight stage
  float* stats = Bs + kStageFloats;

  auto token = [&](int r) { return window_token(b, wi, wj, r, H, W, shift); };
  layernorm_t([&](int r) { return x + token(r) * C; }, kTile, C, g, be, eps, attT, stats, yT);

  const int kind = window_kind(kinds, wi, wj, nwh, nww);
  const size_t window = (size_t)b * nwh * nww + blockIdx.x;
  for (int h = 0; h < nh; ++h) {
    // this head's columns of qkv: [q_h | k_h | v_h], 3 * hd of the 3C
    gemm_weights(
        yT, C, wq, 3 * C, 3 * hd, [&](int c) { return (c / hd) * C + h * hd + c % hd; }, Bs,
        [&](int r0, int c, const float* o) {
          const int part = c / hd, d = c % hd;
          const float bb = __ldg(bq + part * C + h * hd + d);
          if (part == 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[(r0 + i) * kVLd + d] = o[i] + bb;
          } else {
            float* dst = (part == 0 ? qT : kT) + d * kTLd + r0;
            *reinterpret_cast<float4*>(dst) =
                make_float4(o[0] + bb, o[1] + bb, o[2] + bb, o[3] + bb);
          }
        });
    __syncthreads();
    float* Ph = P == nullptr ? nullptr : P + (window * nh + h) * kTile * kTile;
    attention_head(qT, kT, v, hd, scale, bias + ((size_t)kind * nh + h) * kTile * kTile, S, Ph,
                   [&](int r0, int d, const float* o) {
                     *reinterpret_cast<float4*>(attT + (h * hd + d) * kTLd + r0) =
                         make_float4(o[0], o[1], o[2], o[3]);
                     if (att != nullptr) {
#pragma unroll
                       for (int i = 0; i < 4; ++i) att[token(r0 + i) * C + h * hd + d] = o[i];
                     }
                   });
  }

  const float sb = __ldg(s + b);
  gemm_weights(attT, C, wp, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(bp + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   const long long idx = token(r0 + i) * C + c;
                   z[idx] = __ldg(x + idx) + sb * (o[i] + bb);
                 }
               });
}

// One block per 64 consecutive tokens of the B*H*W.
// One block per SM (shared memory allows no more): all 255 registers are free.
__global__ void __launch_bounds__(kThreads, 1)
    ln_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ be, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ s,
                      float* __restrict__ out, long long tokens, long long hw, int C,
                      int hidden, float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  float* yT = smem;                  // (C, 64) LN2 output
  float* hT = yT + C * kTLd;         // (hidden, 64) gelu(fc1); LN scratch before
  float* Bs = hT + hidden * kTLd;    // weight stage
  float* stats = Bs + kStageFloats;

  layernorm_t([&](int r) { return x + (t0 + r) * C; }, M, C, g, be, eps, hT, stats, yT);
  gemm_weights(yT, C, w1, hidden, hidden, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(b1 + c);
                 *reinterpret_cast<float4*>(hT + c * kTLd + r0) =
                     make_float4(gelu_erf(o[0] + bb), gelu_erf(o[1] + bb),
                                 gelu_erf(o[2] + bb), gelu_erf(o[3] + bb));
               });
  gemm_weights(hT, hidden, w2, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(b2 + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   if (r0 + i >= M) break;
                   const long long t = t0 + r0 + i;
                   const long long idx = t * C + c;
                   out[idx] = __ldg(x + idx) + __ldg(s + t / hw) * (o[i] + bb);
                 }
               });
}

// Each launcher sets its kernel's shared-memory limit and launches it on
// `stream`; it returns the first CUDA error.
inline cudaError_t launch_attn_block_fwd(const float* x, const float* g, const float* be,
                                         const float* wq, const float* bq, const float* wp,
                                         const float* bp, const float* bias, const float* s,
                                         float* z, float* P, float* att, int B, int H, int W,
                                         int C, int nh, int kinds, int shift, float eps,
                                         float scale, cudaStream_t stream) {
  const int smem = attn_block_smem_floats(C, nh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_block_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / 8) * (W / 8), B);
  attn_block_fwd_kernel<<<grid, kThreads, smem, stream>>>(x, g, be, wq, bq, wp, bp, bias, s, z,
                                                         P, att, H, W, C, nh, kinds, shift, eps,
                                                         scale);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_mlp_fwd(const float* x, const float* g, const float* be,
                                     const float* w1, const float* b1, const float* w2,
                                     const float* b2, const float* s, float* out, int B, int H,
                                     int W, int C, int hidden, float eps, cudaStream_t stream) {
  const int smem = ln_mlp_smem_floats(C, hidden) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tokens = (long long)B * H * W;
  const unsigned blocks = (unsigned)((tokens + kTile - 1) / kTile);
  ln_mlp_fwd_kernel<<<blocks, kThreads, smem, stream>>>(x, g, be, w1, b1, w2, b2, s, out, tokens,
                                                       (long long)H * W, C, hidden, eps);
  return cudaGetLastError();
}

}  // namespace trr
