// The forward of the pre-LN Swin block halves, fp32 in 3xTF32 on the tensor
// cores, for sm_90a. Shared by the serving library (fused_block.cu: #1 at
// 8x8 and 12x12 windows and #2 at every width), the training library
// (fused_block_train.cu: #4) and the attention half's training form
// (attn_block_staged.cu: #9 at 8x8 and 12x12).
//
//   attn_half_fwd: z = x + s[b] * proj(window-MHSA(qkv(LN1 x)) + bias kind)
//                  and, for training, the softmax P of every window and
//                  head and the attention output att;
//   mlp_half_fwd:  out = x + s[b] * fc2(gelu_erf(fc1(LN2 x)))
//
// What bounds them on the card: their products. At SwinIR-M's training
// block (B 8, 64x64, C 180, 6 heads of 30, hidden 360: 32,768 tokens) the
// attention half does 10.0 GFLOP and the MLP half 8.5 against some 120 MB
// and 47 MB of activations in and out (P alone 50 MB); 3xTF32 triples the
// products, so on the tensor cores (495 TFLOP/s) the halves' bounds are
// 0.061 and 0.052 ms of operations, above the 0.036 and 0.014 ms their
// bytes take at 3.35 TB/s. At SRFormerV2's (B 8, 72x72, C 240, 8 heads of
// 30, 12x12 windows: 41,472 tokens) the attention half does 24.8 GFLOP,
// 0.151 ms on the tensor cores. Each half runs in stages on the engine's
// kernels, its intermediates in device memory (L2-resident in part: qkv is
// 71 MB at SwinIR-M's block, h 47 MB). The per-token products add each
// 32-deep slice's sum to an fp32 accumulator on the CUDA cores
// (tc_gemm.cuh's promoted products), so the halves keep an fp32 product's
// accuracy:
//   attention half
//   1. ln_rows_kernel (tc_rows.cuh), one warp a token: y = LN1(x).
//   2. linear_kernel, per 128 tokens x 128 columns: qkv = y wq + bq, wq as
//      it lies (N-major, transposed as it is split); 131,136 B.
//   3. attn_rows_fwd_tc_kernel (tc_attn.cuh), per (window, head), heads
//      fastest: S = q k^T and P v on mma.sync in 3xTF32, the softmax in the
//      fragments; P to P (B, H/ws, W/ws, nh, n, n) in the rolled frame when
//      training, att (T, C) in x's frame. At 8x8 <64, 64, 2>: 55,552 B,
//      three blocks a SM; at 12x12 <144, 48, 2>, the backward's plan: rows
//      of 48, two key parts, 85,056 B, two blocks a SM.
//   4. linear_kernel with its residual epilogue, per 128 tokens x 96
//      columns (two tiles span C 180; 128-column tiles at C 240 and above):
//      z = x + s (att wp + bp); 108,608 B.
//   MLP half
//   1. ln_rows_kernel: y = LN2(x).
//   2. linear_kernel with its gelu epilogue: h = gelu(y w1 + b1) (T, hidden).
//   3. linear_kernel with its residual epilogue: out = x + s (h w2 + b2).
// The windows are those of x rolled by (-shift, -shift); only stage 3 of the
// attention half indexes them, every other stage is per token in x's frame,
// so the caller rolls nothing. No atomics: every output is the same bit for
// bit over two runs. Scratch (the wrapper's torch.empty): y (T, C), qkv
// (T, 3C) and att (T, C) where it is not an output; h (T, hidden).
#pragma once

#include <algorithm>

#include "tc_attn.cuh"
#include "tc_rows.cuh"

namespace trr {

// The largest shared memory, in bytes, of the kernels of each half: the
// attention half at ws x ws windows (8 or 12).
inline int attn_half_fwd_smem_bytes(int C, int ws) {
  const int n = ws * ws;
  const AttnPlan plan = attn_plan(n);
  return std::max({linear_smem_bytes(), linear_smem_bytes(linear_cols(C)),
                   attn_rows_fwd_tc_smem_floats(n, plan.rb, plan.ks) * (int)sizeof(float)});
}
inline int mlp_half_fwd_smem_bytes(int C) {
  return std::max(linear_smem_bytes(), linear_smem_bytes(linear_cols(C)));
}

// x, z (B, H, W, C); wq (C, 3C), bq (3C), wp (C, C), bp (C), g / be (C),
// bias (kinds, nh, n, n), s (B); scratch y (T, C), qkv (T, 3C), att (T, C)
// (an output when training). P (B, H/ws, W/ws, nh, n, n) is written when
// not null. Windows of ws x ws, n = ws * ws: 8 or 12; H and W are multiples
// of ws; C / nh <= 32; C <= kLnMaxC.
inline int attn_half_fwd(const float* x, const float* g, const float* be, const float* wq,
                         const float* bq, const float* wp, const float* bp, const float* bias,
                         const float* s, float* y, float* qkv, float* att, float* P, float* z,
                         int B, int H, int W, int C, int nh, int ws, int kinds, int shift,
                         float eps, float scale, cudaStream_t stream) {
  if (ws != 8 && ws != 12) return (int)cudaErrorInvalidValue;
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(ln_rows(x, g, be, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps, stream));
  TRR_TRY(linear(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY(ws == 8 ? attn_rows_fwd_tc<64>(qkv, bias, att, P, B, H, W, C, nh, 8, 8, kinds, shift,
                                          scale, stream)
                  : attn_rows_fwd_tc<144>(qkv, bias, att, P, B, H, W, C, nh, 12, 12, kinds, shift,
                                           scale, stream));
  return (int)linear<kLinearResidual>(att, wp, bp, z, T, C, C, stream, x, s, hw);
}

// x, out (B, H, W, C) as B*H*W tokens; w1 (C, hidden), b1 (hidden), w2
// (hidden, C), b2 (C), g / be (C), s (B); scratch y (T, C), h (T, hidden).
inline int mlp_half_fwd(const float* x, const float* g, const float* be, const float* w1,
                        const float* b1, const float* w2, const float* b2, const float* s,
                        float* y, float* h, float* out, int B, int H, int W, int C, int hidden,
                        float eps, cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(ln_rows(x, g, be, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps, stream));
  TRR_TRY(linear<kLinearGelu>(y, w1, b1, h, T, C, hidden, stream));
  return (int)linear<kLinearResidual>(h, w2, b2, out, T, hidden, C, stream, x, s, hw);
}

}  // namespace trr
