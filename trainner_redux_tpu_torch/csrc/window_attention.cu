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
// (qkv in, out back). At ws 16 the work per token is four times larger: the
// forward does 6 GFLOP at 32,768 tokens against 100 MB, the backward 15
// GFLOP against 180 MB. Both are tc_attn.cuh's window attention, its
// products on mma.sync in 3xTF32 (bound: 3 x operations at 495 TFLOP/s on
// the tensor cores); they read each qkv value once and keep every n x n
// tile on chip, so device memory sees nothing of that size but the
// backward's per-window dS, which the bias-kind reduction needs:
//   - the forward is attn_rows_fwd_tc_kernel, the pre-LN block forwards'
//     window attention with no shift and no P: one block per (window,
//     head), the heads fastest in the grid; k and v of the window's n tokens
//     staged once, the queries in row blocks: S = q k^T with the bias rows
//     of the window's kind and the row softmax in the accumulator fragments,
//     P to a shared (rows, n + 4) tile, att = P v out a head row at a time.
//     Plans (n, rows, warps a 16-row tile): (64, 64, 2), three blocks a SM;
//     (128, 32, 4), two blocks a SM; (256, 64, 4), 16 warps, 161,792 B and
//     one block a SM.
//   - the backward is attn_rows_bwd_tc_kernel, #6's window attention
//     without its att output, on the same plans: recompute P, then dV +=
//     P^T dO, dP = dO v^T, dS = P (dP - rowsum(P dP)), dQ = scale dS k
//     (written per row block) and dK += scale dS^T q, five products a row
//     block. dK and dV of the window sum over every row block, so they stay
//     in registers across the blocks. At n 256 four warps share a 16-row
//     tile, each over a quarter of the keys, so a thread holds 32 floats of
//     S or dP and 32 of dK and dV: 16 warps, 172,032 B and one block a SM.
//     At n 128 four warps share a tile of a 32-row block, at n 64 two warps
//     one of a 64-row block, two blocks a SM. q, k, v and dO arrive a head
//     row at a time through shared memory, the bias rows with 16-byte
//     loads, and dq, dk, dv leave the same way. dS of each (window, head)
//     goes to a buffer shaped as the windows' P, and dbias_kernel
//     (common.cuh) adds it over the windows of each kind in window order:
//     no atomics, two runs are bit-identical.
// The kernels take no shift: the caller rolls qkv and the output, as the
// JAX package's contract has it.
//
// Heads of 33 to 64 channels (ATD's 35) take the same kernels with their
// rows padded to 64 channels (tc_attn.cuh's HD = 64): a 64-wide q, k, v and
// dO row, 68 floats apart in shared memory, zeros past the head. At n 256
// the query rows go in blocks of 32 (at 64 rows the forward would need
// 243,712 B, past a block's 232,448), 8 warps and one block a SM, whose
// threads hold up to 255 registers; the backward takes dV in a pass of its
// own (tc_attn.cuh's attn_rows_bwd_body). A head
// may start at any element of its token's 3C row (C 210: every 35 floats),
// so the rows are read and written an element a lane, as at 32.
//
// The bf16 forms (trr_*_mhsa_fwd_bf16, trr_*_mhsa_bwd_bf16): the JAX kernels
// compute in qkv's dtype, so a bf16 training step (HAT, DAT, SwinIR-L) runs
// #3 and #8 on bf16 qkv, dout and dqkv with the fp32 kind table, dS and
// dbias, on the same plans and fp32 tiles as the fp32 forms: the products on
// mma.sync m16n8k16 bf16 with fp32 sums (no hi/lo split), the softmax and
// its row sums in fp32, P rounded to bf16 for P v and dV, bf16(scale dS)
// for dQ and dK, the outputs rounded to bf16 as they leave
// (ops/pallas/window_attention.py:191-220 and :226-300). Their bound: the
// bf16 tensor cores take HAT-M's ws-16 forward (6.04 GFLOP) in 6.1 us and
// its backward (15.10) in 15.3, below what their bytes take at 3.35 TB/s
// (about 50 and 95 MB: 15 and 28 us): bytes bound both, and the window
// attention's issue rate holds them (the fp32 forms reach 12-13% of their
// 3xTF32 bound).
#include <type_traits>

#include "tc_attn.cuh"

namespace {

// The padded head width of a head of hd channels: 32, 64, or 0 past 64.
int head_width(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 0; }

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<N>, Int<HD>) for a window of n tokens (64, 128 or 256) and heads of
// hd channels (at most 64); cudaErrorInvalidValue for anything else.
template <class F>
cudaError_t dispatch(int n, int hd, F f) {
  const int hw = head_width(hd);
  if (hw == 32) {
    if (n == 64) return f(Int<64>(), Int<32>());
    if (n == 128) return f(Int<128>(), Int<32>());
    if (n == 256) return f(Int<256>(), Int<32>());
  } else if (hw == 64) {
    if (n == 64) return f(Int<64>(), Int<64>());
    if (n == 128) return f(Int<128>(), Int<64>());
    if (n == 256) return f(Int<256>(), Int<64>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of the forward at windows of wr x wc tokens (n 64, 128 or
// 256) and heads of C / nh channels (at most 64), or 0 for another n.
size_t trr_rect_mhsa_smem_bytes(int C, int nh, int wr, int wc) {
  const int n = wr * wc, hw = head_width(C / nh);
  if ((n != 64 && n != 128 && n != 256) || hw == 0) return 0;
  const trr::AttnPlan plan = trr::attn_plan(n, hw);
  return (size_t)trr::attn_rows_fwd_tc_smem_floats(n, plan.rb, plan.ks, hw) * sizeof(float);
}

size_t trr_rect_mhsa_bwd_smem_bytes(int C, int nh, int wr, int wc) {
  const int n = wr * wc, hw = head_width(C / nh);
  if ((n != 64 && n != 128 && n != 256) || hw == 0) return 0;
  const trr::AttnPlan plan = trr::attn_plan(n, hw);
  return (size_t)trr::attn_rows_bwd_tc_smem_floats(n, plan.rb, plan.ks, false, false, hw) *
         sizeof(float);
}

size_t trr_window_mhsa_smem_bytes(int C, int nh, int ws) {
  return trr_rect_mhsa_smem_bytes(C, nh, ws, ws);
}

size_t trr_window_mhsa_bwd_smem_bytes(int C, int nh, int ws) {
  return trr_rect_mhsa_bwd_smem_bytes(C, nh, ws, ws);
}

// qkv (B, H, W, 3C), out (B, H, W, C), bias (kinds, nh, n, n), windows of
// wr rows and wc columns, n = wr * wc: 64, 128 or 256. H is a multiple of
// wr, W of wc; C / nh <= 64.
int trr_rect_mhsa_fwd(const float* qkv, const float* bias, float* out, int B, int H, int W,
                      int C, int nh, int kinds, int wr, int wc, float scale,
                      cudaStream_t stream) {
  return (int)dispatch(wr * wc, C / nh, [&](auto n_, auto hd_) {
    constexpr int N = decltype(n_)::value, HD = decltype(hd_)::value;
    return trr::attn_rows_fwd_tc<N, false, HD>(qkv, bias, out, nullptr, B, H, W, C, nh, wr, wc,
                                               kinds, 0, scale, stream);
  });
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
  const cudaError_t err = dispatch(n, C / nh, [&](auto n_, auto hd_) {
    constexpr int N = decltype(n_)::value, HD = decltype(hd_)::value;
    return trr::attn_rows_bwd_tc<N, false, false, HD>(qkv, bias, dout, dqkv, nullptr, dS, B, H,
                                                      W, C, nh, wr, wc, kinds, 0, scale, stream);
  });
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

// The bf16 forward (#3's bf16 form): qkv (B, H, W, 3C) and out (B, H, W,
// C) bf16, bias (kinds, nh, n, n) fp32; windows as trr_rect_mhsa_fwd's.
int trr_rect_mhsa_fwd_bf16(const trr::bf16* qkv, const float* bias, trr::bf16* out, int B, int H,
                           int W, int C, int nh, int kinds, int wr, int wc, float scale,
                           cudaStream_t stream) {
  return (int)dispatch(wr * wc, C / nh, [&](auto n_, auto hd_) {
    constexpr int N = decltype(n_)::value, HD = decltype(hd_)::value;
    return trr::attn_rows_fwd_bf16<N, false, HD>(qkv, bias, out, nullptr, B, H, W, C, nh, wr, wc,
                                                 kinds, 0, scale, stream);
  });
}

int trr_window_mhsa_fwd_bf16(const trr::bf16* qkv, const float* bias, trr::bf16* out, int B,
                             int H, int W, int C, int nh, int kinds, int ws, float scale,
                             cudaStream_t stream) {
  if (ws != 8 && ws != 16) return (int)cudaErrorInvalidValue;
  return trr_rect_mhsa_fwd_bf16(qkv, bias, out, B, H, W, C, nh, kinds, ws, ws, scale, stream);
}

// The bf16 backward (#8's bf16 form): qkv, dout and dqkv bf16; bias, the dS
// scratch and dbias fp32, shaped as trr_rect_mhsa_bwd's.
int trr_rect_mhsa_bwd_bf16(const trr::bf16* qkv, const float* bias, const trr::bf16* dout,
                           trr::bf16* dqkv, float* dS, float* dbias, int B, int H, int W, int C,
                           int nh, int kinds, int wr, int wc, float scale, cudaStream_t stream) {
  const int n = wr * wc;
  const cudaError_t err = dispatch(n, C / nh, [&](auto n_, auto hd_) {
    constexpr int N = decltype(n_)::value, HD = decltype(hd_)::value;
    return trr::attn_rows_bwd_recompute_bf16<N, false, HD>(qkv, bias, dout, dqkv, nullptr, dS, B,
                                                           H, W, C, nh, wr, wc, kinds, 0, scale,
                                                           stream);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)trr::launch_dbias(dS, B, H / wr, W / wc, nh, kinds, n * n, dbias, stream);
}

int trr_window_mhsa_bwd_bf16(const trr::bf16* qkv, const float* bias, const trr::bf16* dout,
                             trr::bf16* dqkv, float* dS, float* dbias, int B, int H, int W, int C,
                             int nh, int kinds, int ws, float scale, cudaStream_t stream) {
  if (ws != 8 && ws != 16) return (int)cudaErrorInvalidValue;
  return trr_rect_mhsa_bwd_bf16(qkv, bias, dout, dqkv, dS, dbias, B, H, W, C, nh, kinds, ws, ws,
                                scale, stream);
}

}  // extern "C"
