// The pre-LN Swin attention half through stages in device memory, fp32, for
// sm_90a: its recompute backward and its training form that saves P and att.
//
// Replaces the JAX package's Pallas TPU kernels in
// trainner_redux_tpu/ops/pallas/fused_block.py:
//   the backward of fused_attn_block (_attn_bwd, _attn_block_bwd_kernel,
//       pallas_call at :729): dx and the gradients of LN1, qkv, proj and the
//       bias-kind table, recomputing LN1, qkv and the softmax from x
//       (nothing is saved); the forward (:693) is fused_block.cu's;
//   fused_attn_block_train (_attn_block_fwd_train_kernel, pallas_call at
//       :977): z = x + s[b] * proj(window-MHSA(qkv(LN1 x)) + bias kind), and
//       the softmax P of every window and head and the attention output att,
//       saved for its backward;
//   its saved-P backward (_attn_train_bwd, _attn_block_bwd_saved_kernel,
//       pallas_call at :1036): the same gradients from the saved P and att,
//       recomputing LN1 and qkv only, with no bias table.
//
// What bounds them on the card: their products. At SRFormerV2's training
// block (B 8, 72x72, C 240, 8 heads of 30, n 144: 41,472 tokens) the forward
// does some 25 GFLOP and the backward some 70 against a few hundred MB of
// activations (the saved P adds 191 MB, and 64 GFLOP remain for the saved-P
// backward). The half runs in stages, each with a working set that fits
// one thread block, its intermediates in device memory (L2-resident in part
// at these sizes).
//
// The training forward, at 8x8 and 12x12 windows, is block_fwd.cuh's
// attention half on the tensor-core engine, writing P and att: LN1 rows,
// qkv on linear_kernel, attn_rows_fwd_tc_kernel (tc_attn.cuh; <144, 48, 2>
// at 12x12, the backward's plan) storing P, proj + residual on
// linear_kernel's residual epilogue.
// The backwards. Every per-token product runs on the tensor cores in 3xTF32
// through the wgmma engine (tc_gemm.cuh, tc_rows.cuh; bound 3 x operations
// / 495 TFLOP/s), 128 tokens a block:
//   1. ln_rows_kernel, one warp a token: y = LN1(x) and its stats, dzp = s
//      dout (bound: bytes).
//   2. linear_kernel, per 128 tokens x 128 columns: qkv = y wq + bq, wq as
//      it lies (N-major, transposed as it is split); 131,136 B.
//   3. rows_kernel<BN, kRowsStore>: datt = dzp wp^T, wp as it lies (K-major).
//   4. the window attention, per (window, head), dK and dV carried in
//      registers across the row blocks, dS of each (window, head) to a
//      buffer that dbias_kernel (common.cuh) sums per kind in window order,
//      on tc_attn.cuh's attn_rows_bwd_tc_kernel (#8's too) in both forms:
//      recompute: its six
//      products (S = q k^T, att = P v for dwp, dV += P^T dA, dP = dA v^T, dQ = scale dS k,
//      dK += scale dS^T q) on mma.sync m16n8k8 tf32 in 3xTF32 (tc_attn.cuh),
//      the head dimension zero-padded to 32, the softmax and dS = P (dP -
//      rowsum(P dP)) on the accumulator fragments; two warps a 16-row tile,
//      each over half the keys, and two blocks a SM (6 warps and 99,264 B
//      each at n 144). Its products take about a fifth of its time at the
//      tensor cores' mma.sync rate; what bounds it is moving its rows: q,
//      k, v, dA in, att and dq | dk | dv out, a head row (120 bytes) at a
//      time through shared memory, and 191 MB of dS at SRFormerV2's block.
//      saved-P: its SAVED form, on the same plans: each row block's P rows
//      staged from the forward's into the shared tile in place of the bias
//      rows, no S and no softmax, four products (dV, dP, dQ, dK); it reads
//      the 191 MB of P as well and writes no att.
//   5. rows_kernel<BN, kRowsLn>: dy = dqkv wq^T, wq as it lies (K-major), then
//      the LN1 backward dx = dout + LN1'(dy) and the dg / dbe partial sums
//      per 128 tokens, from a shared dy tile (BN 256 at C 240: 221,248 B).
//   6. (the wrapper) the weight gradients dwq, dwp and their biases with
//      fused_block_train.cu's split-K atb_kernel and sum_rows_kernel, then
//      dbias.
// Both backwards take 8x8 windows as well (rows of 64).
// No atomics: two runs give the same gradients bit for bit. The windows are
// those of x rolled by (-shift, -shift); the kernels index them, so the
// caller rolls nothing.
#include <algorithm>

#include "block_fwd.cuh"
#include "tc_attn.cuh"
#include "tc_rows.cuh"

namespace trr {

// The windows the staged backwards take: 8x8 (n 64) and 12x12 (n 144), each
// on attn_plan(n).
inline bool staged_window(int n) { return n == 144 || n == 64; }

// The backwards' per-token stages before the window attention: y = LN1(x)
// and its stats, dzp = s dout, qkv = y wq + bq, datt = dzp wp^T.
inline cudaError_t bwd_head(const float* x, const float* g, const float* be, const float* wq,
                            const float* bq, const float* wp, const float* s, const float* dout,
                            float* qkv, float* y, float* stats, float* dzp, float* datt,
                            long long tokens, long long hw, int C, float eps,
                            cudaStream_t stream) {
  cudaError_t err = ln_rows(x, g, be, y, stats, dout, s, dzp, tokens, hw, C, eps, stream);
  if (err != cudaSuccess) return err;
  if ((err = linear(y, wq, bq, qkv, tokens, C, 3 * C, stream)) != cudaSuccess) return err;
  return rows<kRowsStore>(dzp, wp, tokens, C, C, nullptr, nullptr, nullptr, nullptr, nullptr, hw,
                          datt, nullptr, nullptr, stream);
}

// The backwards' last stages: dy = dqkv wq^T and the LN1 backward -> dx and
// the LN1 partial sums, then dbias from the per-window dS.
inline cudaError_t bwd_tail(const float* dqkv, const float* wq, const float* x,
                            const float* stats, const float* g, const float* dout, float* dx,
                            float* ln_part, float* dS, float* dbias, int B, int H, int W, int C,
                            int nh, int ws, int kinds, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  const cudaError_t err = rows<kRowsLn>(dqkv, wq, tokens, 3 * C, C, x, stats, g, dout, nullptr,
                                        hw, dx, nullptr, ln_part, stream);
  if (err != cudaSuccess) return err;
  return launch_dbias(dS, B, H / ws, W / ws, nh, kinds, ws * ws * ws * ws, dbias, stream);
}

}  // namespace trr

extern "C" {

// The largest shared memory of each backward's stages at windows of ws x ws
// (12: rows of 48; 8: rows of 64), or 0 for another ws.
size_t trr_attn_staged_bwd_smem_bytes(int C, int nh, int ws) {
  const int n = ws * ws;
  if (!trr::staged_window(n)) return 0;
  const trr::AttnPlan plan = trr::attn_plan(n);
  return (size_t)std::max(
      {trr::linear_smem_bytes(), trr::rows_smem_bytes(C),
       trr::attn_rows_bwd_tc_smem_floats(n, plan.rb, plan.ks, true) * (int)sizeof(float)});
}

size_t trr_attn_train_bwd_smem_bytes(int C, int nh, int ws) {
  const int n = ws * ws;
  if (!trr::staged_window(n)) return 0;
  const trr::AttnPlan plan = trr::attn_plan(n);
  return (size_t)std::max(
      {trr::linear_smem_bytes(), trr::rows_smem_bytes(C),
       trr::attn_rows_bwd_tc_smem_floats(n, plan.rb, plan.ks, false, true) * (int)sizeof(float)});
}

// The training forward at ws x ws windows (8 or 12): block_fwd.cuh's
// attention half on the tensor-core engine through the scratch y (B*H*W, C)
// and qkv (B*H*W, 3C). x, z (B, H, W, C); wq (C, 3C), bq (3C), wp (C, C),
// bp (C), g/be (C), bias (kinds, nh, n, n), s (B); z as fused_block.cu's
// trr_attn_block_fwd, and for the backward P (B, H/ws, W/ws, nh, n, n), the
// softmax of each window and head in the rolled frame, and att (B, H, W,
// C), the attention output in x's frame.
int trr_attn_block_train_fwd(const float* x, const float* g, const float* be, const float* wq,
                             const float* bq, const float* wp, const float* bp,
                             const float* bias, const float* s, float* y, float* qkv, float* P,
                             float* att, float* z, int B, int H, int W, int C, int nh, int ws,
                             int kinds, int shift, float eps, float scale, cudaStream_t stream) {
  return trr::attn_half_fwd(x, g, be, wq, bq, wp, bp, bias, s, y, qkv, att, P, z, B, H, W, C, nh,
                            ws, kinds, shift, eps, scale, stream);
}

// The recompute backward at ws x ws windows (12 or 8), from x, the forward's
// operands and dout (B, H, W, C): writes dx, and for the wrapper's weight
// gradients y = LN1(x) and dzp = s dout (T, C), dqkv (T, 3C) and att (T, C);
// ln_part (ceil(T / 128), 2C) the dg / dbe partial sums; dbias (kinds, nh,
// n, n) from the per-window dS (B, H/ws, W/ws, nh, n, n). Scratch: qkv (T,
// 3C), stats (T, 2), datt (T, C). C is at most 256 and a multiple of 4.
int trr_attn_block_staged_bwd(const float* x, const float* g, const float* be, const float* wq,
                              const float* bq, const float* wp, const float* bias,
                              const float* s, const float* dout, float* qkv, float* y,
                              float* stats, float* dzp, float* datt, float* dqkv, float* att,
                              float* dS, float* dx, float* ln_part, float* dbias, int B, int H,
                              int W, int C, int nh, int ws, int kinds, int shift, float eps,
                              float scale, cudaStream_t stream) {
  const int n = ws * ws;
  if (!trr::staged_window(n)) return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  cudaError_t err = trr::bwd_head(x, g, be, wq, bq, wp, s, dout, qkv, y, stats, dzp, datt, tokens,
                                  hw, C, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = n == 144 ? trr::attn_rows_bwd_tc<144, true>(qkv, bias, datt, dqkv, att, dS, B, H, W, C,
                                                    nh, ws, ws, kinds, shift, scale, stream)
                 : trr::attn_rows_bwd_tc<64, true>(qkv, bias, datt, dqkv, att, dS, B, H, W, C, nh,
                                                   ws, ws, kinds, shift, scale, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)trr::bwd_tail(dqkv, wq, x, stats, g, dout, dx, ln_part, dS, dbias, B, H, W, C, nh,
                            ws, kinds, stream);
}

// The saved-P backward at ws x ws windows (12 or 8): as
// trr_attn_block_staged_bwd, but from the forward's P (B, H/ws, W/ws, nh, n,
// n) in place of the bias table, and with no att output: the wrapper takes
// dwp from the forward's saved att.
int trr_attn_block_train_bwd(const float* x, const float* g, const float* be, const float* wq,
                             const float* bq, const float* wp, const float* s, const float* P,
                             const float* dout, float* qkv, float* y, float* stats, float* dzp,
                             float* datt, float* dqkv, float* dS, float* dx, float* ln_part,
                             float* dbias, int B, int H, int W, int C, int nh, int ws, int kinds,
                             int shift, float eps, float scale, cudaStream_t stream) {
  const int n = ws * ws;
  if (!trr::staged_window(n)) return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  cudaError_t err = trr::bwd_head(x, g, be, wq, bq, wp, s, dout, qkv, y, stats, dzp, datt, tokens,
                                  hw, C, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = n == 144 ? trr::attn_rows_bwd_tc<144, false, true>(qkv, P, datt, dqkv, nullptr, dS, B, H,
                                                           W, C, nh, ws, ws, kinds, shift, scale,
                                                           stream)
                 : trr::attn_rows_bwd_tc<64, false, true>(qkv, P, datt, dqkv, nullptr, dS, B, H, W,
                                                          C, nh, ws, ws, kinds, shift, scale,
                                                          stream);
  if (err != cudaSuccess) return (int)err;
  return (int)trr::bwd_tail(dqkv, wq, x, stats, g, dout, dx, ln_part, dS, dbias, B, H, W, C, nh,
                            ws, kinds, stream);
}

}  // extern "C"
