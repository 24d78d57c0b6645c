// Fused pre-LN Swin block halves, forward, fp32, for sm_90a: the serving
// entry points.
//
// Replaces the JAX package's Pallas TPU kernels in
// trainner_redux_tpu/ops/pallas/fused_block.py:
//   fused_attn_block (_attn_block_fwd_kernel, pallas_call at :693) at 8x8
//       and 12x12 windows: z = x + s[b] * proj(window-MHSA(qkv(LN1 x)) +
//       bias kind);
//   fused_ln_mlp (_mlp_fwd_kernel, pallas_call at :388):
//       out = x + s[b] * fc2(gelu_erf(fc1(LN2 x)))
//
// Both run in stages on the tensor-core engine in 3xTF32 (block_fwd.cuh,
// which the training library fused_block_train.cu and attn_block_staged.cu
// share): what bounds them and their design are there.
#include "block_fwd.cuh"

extern "C" {

size_t trr_attn_block_smem_bytes(int C, int ws) {
  return (size_t)trr::attn_half_fwd_smem_bytes(C, ws);
}

size_t trr_ln_mlp_smem_bytes(int C) { return (size_t)trr::mlp_half_fwd_smem_bytes(C); }

// x, z: (B, H, W, C); wq (C, 3C), bq (3C), wp (C, C), bp (C), g/be (C),
// bias (kinds, nh, n, n), s (B); scratch y, att (B*H*W, C) and qkv
// (B*H*W, 3C). Windows are ws x ws, n = ws * ws: 8 or 12; H and W are
// multiples of ws; C / nh <= 32. The windows are those of x rolled by
// (-shift, -shift) and z comes back unrolled, so the caller rolls nothing.
int trr_attn_block_fwd(const float* x, const float* g, const float* be, const float* wq,
                       const float* bq, const float* wp, const float* bp, const float* bias,
                       const float* s, float* y, float* qkv, float* att, float* z, int B, int H,
                       int W, int C, int nh, int ws, int kinds, int shift, float eps, float scale,
                       cudaStream_t stream) {
  return trr::attn_half_fwd(x, g, be, wq, bq, wp, bp, bias, s, y, qkv, att, nullptr, z, B, H, W,
                            C, nh, ws, kinds, shift, eps, scale, stream);
}

// x, out: (B, H, W, C) seen as B*H*W tokens; w1 (C, hidden), b1 (hidden),
// w2 (hidden, C), b2 (C), g/be (C), s (B); scratch y (B*H*W, C) and h
// (B*H*W, hidden).
int trr_ln_mlp_fwd(const float* x, const float* g, const float* be, const float* w1,
                   const float* b1, const float* w2, const float* b2, const float* s, float* y,
                   float* h, float* out, int B, int H, int W, int C, int hidden, float eps,
                   cudaStream_t stream) {
  return trr::mlp_half_fwd(x, g, be, w1, b1, w2, b2, s, y, h, out, B, H, W, C, hidden, eps,
                           stream);
}

}  // extern "C"
