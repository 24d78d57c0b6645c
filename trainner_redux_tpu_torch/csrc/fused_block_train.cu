// The whole pre-LN Swin block for training, forward and saved-P backward,
// in fp32 and in bf16, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels of fused_swin_block_train in
// trainner_redux_tpu/ops/pallas/fused_block.py:
//   forward  (_swin_block_fwd_kernel, pallas_call at :1374):
//       z = x + s1[b] * proj(window-MHSA(qkv(LN1 x)));  out = z + s2[b] * mlp(LN2 z)
//       saving P (the softmax of every window and head), att (the attention
//       output) and z;
//   backward (_swin_block_bwd_kernel, pallas_call at :1441): dx and the
//       gradients of LN1, qkv, proj, the bias-kind table, LN2, fc1 and fc2
//       from the saved P, att and z, recomputing LN1, qkv, LN2 and fc1;
// and the backward of fused_ln_mlp alone (_mlp_bwd_kernel, pallas_call at
// :415): dx and the gradients of LN, fc1 and fc2, recomputing LN and fc1.
//
// The forward is block_fwd.cuh's two halves on the tensor-core engine, the
// attention half writing P and att: seven launches, one call.
//
// The backwards. What bounds them on the card: their products, 47.6 GFLOP
// for #5 at SwinIR-M's training block (B 8, 64x64, C 180, hidden 360: T =
// 32,768 tokens) against some 300 MB of activations and saved tensors, and
// 21.2 GFLOP for #7 at C 180, 47.8 at C 240 / hidden 480. Every per-token
// product runs on the tensor cores in 3xTF32 through the wgmma engine of
// tc_gemm.cuh (bound: 3 x operations / 495 TFLOP/s), the window attention
// on tc_attn.cuh's mma.sync stages;
// what the design does about the rest of the time: operands stream by
// cp.async through a 4-stage mbarrier ring while the previous chunk's
// wgmmas run; each block holds 128 tokens, so a weight chunk read from L2
// serves 128 tokens; the row-wise work reads whole rows with 16-byte loads.
// Every engine kernel runs 8 warps (two warpgroups, 64 rows each) and one
// block a SM. The per-token work is split into launches of the engine, the
// row-wise work in their prologues and epilogues, and the activations pass
// between them through device memory (the weight gradients need them
// there anyway). ln_rows_kernel and rows_kernel are tc_rows.cuh's, shared
// with the attention halves' backwards (#6, #10, #12). Shared memory below:
// ring + split buffers (+ others).
//   1. ln_rows_kernel, one warp a token: y2 = LN2(z) with its stats, dm =
//      s2 dout; y = LN1(x) with its stats (a second launch; #7: one, from x).
//   2. mlp_hidden_kernel (tc_rows.cuh, shared with #14), per 128 tokens x
//      128 hidden units: h = y2 w1 + b1,
//      gelu(h) to hg; then dh = (dm w2^T) gelu'(h), gelu'(h) waiting in
//      shared memory between the two products. A stage: a (128, 16) token
//      chunk and a raw (16, 128) w1 or (128, 16) w2 chunk; 196,672 B.
//   3. rows_kernel<BN, kRowsLn> (tc_rows.cuh), per 128 tokens x all C columns (BN = 192 at
//      C 180, 256 at C 240): dy2 = dh w1^T, then the LN2 backward from a
//      shared dy tile, a warp's 16 rows four at a time: dz = dout +
//      LN2'(dy2), dzp = s1 dz, the block's partial sums of dg2 and dbe2. A
//      stage: a (128, 16) token chunk and a raw (BN, 16) chunk of w1 as it
//      lies (K-major); 176,192 B at C 180, 221,248 B at C 240. #7 at rows
//      of 257-320 channels (DRCT's C 276 and 308) splits this stage
//      (tc_rows_bf16.cuh's ln_bwd_rows_kernel): dy = dh w1^T to device
//      memory on two rows_kernel<192, kRowsStore> launches (columns 0-159,
//      then the rest), then the LN backward over whole rows from there.
//   4. rows_kernel<BN, kRowsStore>: datt = dzp wp^T (#5 only).
//   5. the window attention as #10 runs it at 8x8 (#5 only): linear_kernel
//      recomputes qkv = y wq + bq (the forward's own product, bit for bit),
//      then the saved-P form of tc_attn.cuh's attn_rows_bwd_tc_kernel, per
//      (window, head): dv, dP, dS, dq, dk from the saved P on mma.sync in
//      3xTF32; dq | dk | dv to dqkv (T, 3C), dS per window for the
//      bias-kind reduction.
//   6. rows_kernel<BN, kRowsLn>: dy = dqkv wq^T and the LN1 backward -> dx (#5).
//   7. atb_kernel: the weight gradients A^T B over the tokens (dw2, dw1,
//      and for #5 dwp, dwq) with the column sums of B for the biases, per
//      128 x 128 output tile and token chunk: both operands token-major,
//      two (32, 128) chunks a stage on a 3-stage ring; 202,800 B. The token
//      ranges are as long as it takes to give about 264 blocks, so a
//      gradient writes some 25-45 partial matrices; sum_rows_kernel adds
//      them in a fixed order.
//   8. the LN partials through sum_rows_kernel, dbias through the two-pass
//      window-group reduction of common.cuh.
// No atomics anywhere: two runs give the same gradients bit for bit.
//
// The bf16 forms (trr_swin_block_fwd_bf16, trr_swin_block_bwd_bf16): the JAX
// kernels compute in x.dtype, so a bf16 training step runs the same block
// on bf16 activations, saving P, att and z in bf16, with the weights cast
// to bf16 and the LayerNorm parameters, biases, bias table and DropPath
// scales in fp32. The same launches on bf16 stages: tc_rows_bf16.cuh's
// per-token kernels on the bf16 wgmma engine (tc_gemm_bf16.cuh: m64nNk16,
// fp32 sums, no hi/lo split), the window attention on tc_attn.cuh's bf16
// forms (mma.sync m16n8k16), the weight gradients on wgrad_bf16.cuh's stage
// (both operands MN-major from shared memory into wgmma, 64-token chunks);
// every statistic, softmax, gelu, weight gradient and bias or LayerNorm
// gradient in fp32, the activations rounded to bf16 where the JAX kernel
// rounds them. Their bound: the bf16 tensor cores (989 TFLOP/s) take #5's
// 47.6 GFLOP in 0.048 ms and #4's 18.5 in 0.019, below what their bytes
// take at 3.35 TB/s, so bytes bound both.
//
// The attention half alone in bf16 at 12x12 windows (trr_attn_block_fwd_bf16,
// #1's bf16 form, fused_block.py:693, _attn_block_fwd_kernel :468-511; and
// trr_attn_block_bwd_bf16, #6's, :729, _attn_block_bwd_kernel :513-634:
// SRFormerV2's Swin blocks in a bf16 step) is #4's and #5's attention stages
// on their own at n 144: LN1 rows, qkv, the window attention over groups of
// windows of one kind (attn_group_bf16.cuh's attn_group_fwd_bf16_kernel:
// fp32 P in registers, bf16(P) packed straight into the A fragments of P
// v), proj with the residual (four launches); then LN1 rows
// with dzp = bf16(s dout), datt = bf16(dzp wp^T), qkv, the recompute window
// attention over groups of windows of one kind (attn_group_bf16.cuh), which
// rebuilds P in fp32, writes att = bf16(bf16(P) v) for dwp besides dq | dk |
// dv and sums dS into each group's dbias in the kernel, dy and the LN1
// backward to dx = bf16(dout + LN1'(dy)), the two weight gradients, the LN
// partial sums and the groups' dbias sums by kind. Nothing is saved between
// them, as the JAX kernel saves nothing. Their bound at SRFormerV2's block
// (B 16, 72x72, C 240, 8 heads of 30: T 82,944): 49.7 GFLOP forward and
// 139.5 backward (qkv and the softmax rebuilt, att recomputed for dwp), 50
// and 141 us on the bf16 tensor cores, above what their inputs and outputs
// take at 3.35 TB/s (40 MB a bf16 (T, C) tensor: some 24 and 36 us). The
// stages pass their intermediates through device memory; the window
// attention writes no per-window dS (382 MB in fp32 before), only the
// groups' dbias sums (48 MB).
//
// The MLP half alone in bf16 (trr_ln_mlp_fwd_bf16, #2's bf16 form; and
// trr_ln_mlp_bwd_bf16, #7's, ops/pallas/fused_block.py:196-254: HAT's HABs
// and OCABs in a bf16 step) runs #4's and #5's MLP stages on their own: LN
// rows, fc1 + gelu, fc2 with the residual (three launches); LN rows with dm
// = bf16(s dout), fc1 + dh, dy and the LN backward to dx = bf16(dout + dt),
// the two weight gradients and the LN partial sums. Its bound at HAT-M's
// block (T 32,768, C 180, hidden 360): 8.5 and 21.2 GFLOP, 9 and 21 us on
// the bf16 tensor cores, against some 24 and 36 MB of rows (7 and 11 us).
#include "attn_group_bf16.cuh"
#include "block_fwd.cuh"
#include "linear_tma_bf16.cuh"
#include "tc_rows.cuh"
#include "tc_rows_bf16.cuh"
#include "wgrad_bf16.cuh"

namespace trr {

constexpr int kAtbK = 32;            // tokens of a weight-gradient chunk
constexpr int kAtbStages = 3;        // depth of its ring (its split buffers are twice as deep)
constexpr int kAtbLd = kTcRows + 8;  // row stride of a weight-gradient chunk
constexpr int kAtbBlocks = 264;      // blocks a weight gradient aims at (two waves)

// atb_kernel: the split buffers, then a ring of two (kAtbK, 128)
// token-major chunks a stage.
__host__ __device__ inline int atb_smem_bytes() {
  return split_floats(kTcRows, kAtbK) * (int)sizeof(float) +
         Ring<kAtbStages>::bytes(2 * kAtbK * kAtbLd);
}

// Tokens of one weight-gradient partial sum for A (T, M), B (T, N): about
// kAtbBlocks blocks over the output tiles, at least 256 tokens (8 chunks),
// a multiple of the chunk depth.
inline long long atb_chunk(long long T, int M, int N) {
  const int tiles = ((M + kTcRows - 1) / kTcRows) * ((N + kTcRows - 1) / kTcRows);
  const long long want = (kAtbBlocks + tiles - 1) / tiles;
  long long chunk = (T + want - 1) / want;
  chunk = (chunk + kAtbK - 1) / kAtbK * kAtbK;
  return chunk < 256 ? 256 : chunk;
}

inline long long atb_part_floats(long long T, int M, int N) {
  const long long chunk = atb_chunk(T, M, N);
  return (T + chunk - 1) / chunk * ((long long)M * N + N);
}

// part[z] (M*N + N floats) = A^T B over the tokens [z*chunk, (z+1)*chunk),
// then the column sums of B over the same tokens (blocks of x-index 0 only):
// A (T, M) and B (T, N) row-major. One block per 128 x 128 output tile and
// token chunk, one warpgroup per 64 rows of it. Both operands arrive
// token-major; tf32 wgmma reads B only K-major (token-contiguous), so each
// chunk of B is transposed and split into its TF32 hi / lo core-matrix
// tiles in shared memory (one barrier a chunk), while A goes to registers
// transposed by its fragment loads. Chunks of 32 tokens on a 3-stage ring:
// twice the per-token kernels' depth, for half their barriers a token. VEC: M, N and both
// addresses in multiples of 4 floats (16-byte copies).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    atb_kernel(const float* __restrict__ A, const float* __restrict__ B, long long T, int M,
               int N, long long chunk, float* __restrict__ part) {
  constexpr int BN = kTcRows;
  extern __shared__ __align__(16) float smem[];
  float* split = smem;
  Ring<kAtbStages> ring;
  ring.init(split + split_floats(BN, kAtbK), 2 * kAtbK * kAtbLd);
  const int m0 = blockIdx.x * kTcRows, n0 = blockIdx.y * kTcRows;
  const long long tb = (long long)blockIdx.z * chunk;
  const long long te = min(T, tb + chunk);
  const bool sums = blockIdx.x == 0 && threadIdx.x < kTcRows;
  float colsum = 0.f;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  AFrag<kAtbK> af[2];
  ring.run(
      (int)((te - tb + kAtbK - 1) / kAtbK),
      [&](int j, float* st) {
        load_tile<kAtbK, kTcRows, VEC>(st, kAtbLd, A, M, tb + j * kAtbK, te, m0, M);
        load_tile<kAtbK, kTcRows, VEC>(st + kAtbK * kAtbLd, kAtbLd, B, N, tb + j * kAtbK, te, n0,
                                       N);
      },
      [&](int j, const float* st) {
        if (sums) {
#pragma unroll 8
          for (int k = 0; k < kAtbK; ++k) colsum += st[(kAtbK + k) * kAtbLd + threadIdx.x];
        }
        wgmma_chunk<BN, kAtbK, false, false>(acc, st, kAtbLd, 16 * (threadIdx.x / 32),
                                             st + kAtbK * kAtbLd, kAtbLd, split, j, af);
      });
  wgmma_wait_all();
  const size_t base = (size_t)blockIdx.z * ((size_t)M * N + N);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int m = m0 + acc_row(i), n = n0 + acc_col(i);
    if (m < M && n < N) part[base + (size_t)m * N + n] = acc[i];
  }
  if (sums && n0 + (int)threadIdx.x < N) part[base + (size_t)M * N + n0 + threadIdx.x] = colsum;
}

// out[i] = sum over s < S of part[s * L + i], s in order.
__global__ void __launch_bounds__(kThreads)
    sum_rows_kernel(const float* __restrict__ part, int S, long long L, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += __ldg(part + (size_t)s * L + i);
  out[i] = acc;
}

inline cudaError_t sum_rows(const float* part, int S, long long L, float* out,
                            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
  sum_rows_kernel<<<blocks, kThreads, 0, stream>>>(part, S, L, out);
  return cudaGetLastError();
}

// out (M*N + N) = (A^T B, column sums of B) over T tokens, through `part`
// (atb_part_floats(T, M, N) floats).
inline cudaError_t weight_grad(const float* A, const float* B, long long T, int M, int N,
                               float* part, float* out, cudaStream_t stream) {
  const long long chunk = atb_chunk(T, M, N);
  const dim3 grid((M + kTcRows - 1) / kTcRows, (N + kTcRows - 1) / kTcRows,
                  (unsigned)((T + chunk - 1) / chunk));
  const int smem = atb_smem_bytes();
  const bool vec = M % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(atb_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    atb_kernel<true><<<grid, kThreads, smem, stream>>>(A, B, T, M, N, chunk, part);
  } else {
    err = cudaFuncSetAttribute(atb_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    atb_kernel<false><<<grid, kThreads, smem, stream>>>(A, B, T, M, N, chunk, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_rows(part, (int)grid.z, (long long)M * N + N, out, stream);
}

}  // namespace trr

extern "C" {

size_t trr_rows_smem_bytes(int C) { return (size_t)trr::rows_smem_bytes(C); }
size_t trr_linear_smem_bytes() { return (size_t)trr::linear_smem_bytes(); }
size_t trr_hidden_smem_bytes() { return (size_t)trr::hidden_smem_bytes(); }
size_t trr_atb_smem_bytes() { return (size_t)trr::atb_smem_bytes(); }
size_t trr_weight_grad_part_floats(int T, int M, int N) {
  return (size_t)trr::atb_part_floats(T, M, N);
}

// The forward: x, out, att, z (B, H, W, C); P (B, H/8, W/8, nh, 64, 64);
// weights (in, out) as in trr_attn_block_fwd and trr_ln_mlp_fwd; s1, s2 (B);
// scratch y (T, C), qkv (T, 3C), h (T, hidden).
int trr_swin_block_fwd(const float* x, const float* g1, const float* be1, const float* wq,
                       const float* bq, const float* wp, const float* bp, const float* bias,
                       const float* g2, const float* be2, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* s1, const float* s2,
                       float* y, float* qkv, float* h, float* out, float* P, float* att, float* z,
                       int B, int H, int W, int C, int nh, int hidden, int kinds, int shift,
                       float eps, float scale, cudaStream_t stream) {
  if (const int err = trr::attn_half_fwd(x, g1, be1, wq, bq, wp, bp, bias, s1, y, qkv, att, P, z,
                                         B, H, W, C, nh, 8, kinds, shift, eps, scale, stream))
    return err;
  return trr::mlp_half_fwd(z, g2, be2, w1, b1, w2, b2, s2, y, h, out, B, H, W, C, hidden, eps,
                           stream);
}

// The backward of fused_ln_mlp (#7): x, dout, dx (B, H, W, C); g, be (C);
// w1 (C, hidden), b1 (hidden), w2 (hidden, C) as the forward takes them;
// s (B). Scratch: y, dm (T, C), stats (T, 2), hg, dh (T, hidden), ln_part
// (ceil(T / 128), 2C), part (the largest trr_weight_grad_part_floats of
// the two gradients), dyw (T * C floats; only for C > 256, else null: the
// split rows stage's dy). Writes dx, dln = dg | dbe (2C), d1 = dw1 | db1
// (C * hidden + hidden) and d2 = dw2 | db2 (hidden * C + C). C <= 320.
int trr_ln_mlp_bwd(const float* x, const float* dout, const float* g, const float* be,
                   const float* w1, const float* b1, const float* w2, const float* s, float* y,
                   float* stats, float* dm, float* hg, float* dh, float* ln_part, float* part,
                   float* dyw, float* dx, float* dln, float* d1, float* d2, int B, int H, int W,
                   int C, int hidden, float eps, cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::ln_rows(x, g, be, y, stats, dout, s, dm, T, hw, C, eps, stream));
  TRR_TRY(trr::mlp_hidden(y, dm, w1, b1, w2, hg, dh, T, C, hidden, stream));
  if (C <= trr::kRowsMaxC) {
    TRR_TRY(trr::rows<trr::kRowsLn>(dh, w1, T, hidden, C, x, stats, g, dout, nullptr, hw, dx,
                                    nullptr, ln_part, stream));
  } else {  // the split rows stage (tc_rows_bf16.cuh): dy to dyw in two parts, then the LN rows
    if (C > trr::kRowsWideMaxC || dyw == nullptr) return (int)cudaErrorInvalidValue;
    const int c0 = trr::kRowsHalf;
    TRR_TRY(trr::rows<trr::kRowsStore>(dh, w1, T, hidden, c0, nullptr, nullptr, nullptr, nullptr,
                                       nullptr, hw, dyw, nullptr, nullptr, stream));
    TRR_TRY(trr::rows<trr::kRowsStore>(dh, w1 + (size_t)c0 * hidden, T, hidden, C - c0, nullptr,
                                       nullptr, nullptr, nullptr, nullptr, hw, dyw + T * c0,
                                       nullptr, nullptr, stream));
    TRR_TRY(trr::ln_bwd_rows(dyw, c0, T, C, x, stats, g, dout, (const float*)nullptr, hw, dx,
                             (float*)nullptr, ln_part, stream));
  }
  TRR_TRY(trr::weight_grad(hg, dm, T, hidden, C, part, d2, stream));
  TRR_TRY(trr::weight_grad(y, dh, T, C, hidden, part, d1, stream));
  return (int)trr::sum_rows(ln_part, (int)((T + trr::kTcRows - 1) / trr::kTcRows), 2LL * C, dln,
                            stream);
}

// The saved-P backward of the whole block (#5): operands as the forward
// takes them, and P, att, z from it; dout (B, H, W, C). Scratch: y, y2, dm,
// dz, dzp, datt (T, C), stats1, stats2 (T, 2), hg, dh (T, hidden), qkv,
// dqkv (T, 3C), dS shaped as P, ln_part (ceil(T / 128), 2C), part (the largest
// trr_weight_grad_part_floats of the four gradients). Writes dx; dln1 =
// dg1 | dbe1 and dln2 = dg2 | dbe2 (2C each); dq = dwq | dbq, dp = dwp |
// dbp, d1 = dw1 | db1, d2 = dw2 | db2; dbias (kinds, nh, 64, 64).
int trr_swin_block_bwd(const float* x, const float* z, const float* dout, const float* P,
                       const float* att, const float* g1, const float* be1, const float* wq,
                       const float* bq, const float* wp, const float* g2, const float* be2,
                       const float* w1, const float* b1, const float* w2, const float* s1,
                       const float* s2, float* y, float* stats1, float* y2, float* stats2,
                       float* dm, float* hg, float* dh, float* dz, float* dzp, float* datt,
                       float* qkv, float* dqkv, float* dS, float* ln_part, float* part, float* dx,
                       float* dln1, float* dq, float* dp, float* dbias, float* dln2, float* d1,
                       float* d2, int B, int H, int W, int C, int nh, int hidden, int kinds,
                       int shift, float eps, float scale, cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  const int nblk = (int)((T + trr::kTcRows - 1) / trr::kTcRows);
  // the MLP half: dz, dzp = s1 dz
  TRR_TRY(trr::ln_rows(z, g2, be2, y2, stats2, dout, s2, dm, T, hw, C, eps, stream));
  TRR_TRY(trr::ln_rows(x, g1, be1, y, stats1, nullptr, nullptr, nullptr, T, hw, C, eps, stream));
  TRR_TRY(trr::mlp_hidden(y2, dm, w1, b1, w2, hg, dh, T, C, hidden, stream));
  TRR_TRY(trr::rows<trr::kRowsLn>(dh, w1, T, hidden, C, z, stats2, g2, dout, s1, hw, dz, dzp,
                                  ln_part, stream));
  TRR_TRY(trr::sum_rows(ln_part, nblk, 2LL * C, dln2, stream));
  // the attention half: datt; qkv = y wq + bq, then dqkv and dS per window
  // from the saved P (#10's stage at 8x8); then dx
  TRR_TRY(trr::rows<trr::kRowsStore>(dzp, wp, T, C, C, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, hw, datt, nullptr, nullptr, stream));
  TRR_TRY(trr::linear(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY((trr::attn_rows_bwd_tc<64, false, true>(qkv, P, datt, dqkv, nullptr, dS, B, H, W, C,
                                                  nh, 8, 8, kinds, shift, scale, stream)));
  TRR_TRY(trr::rows<trr::kRowsLn>(dqkv, wq, T, 3 * C, C, x, stats1, g1, dz, nullptr, hw, dx,
                                  nullptr, ln_part, stream));
  TRR_TRY(trr::sum_rows(ln_part, nblk, 2LL * C, dln1, stream));
  TRR_TRY(trr::weight_grad(hg, dm, T, hidden, C, part, d2, stream));
  TRR_TRY(trr::weight_grad(y2, dh, T, C, hidden, part, d1, stream));
  TRR_TRY(trr::weight_grad(att, dzp, T, C, C, part, dp, stream));
  TRR_TRY(trr::weight_grad(y, dqkv, T, C, 3 * C, part, dq, stream));
  return (int)trr::launch_dbias(dS, B, H / 8, W / 8, nh, kinds, trr::kTile * trr::kTile, dbias,
                                stream);
}

// The bf16 forward (#4's bf16 form): x, out, att, z (B, H, W, C) and P (B,
// H/8, W/8, nh, 64, 64) bf16; wq, wp, w1, w2 bf16 (in, out); g1, be1, bq, bp,
// bias, g2, be2, b1, b2, s1, s2 fp32; scratch y (T, C), qkv (T, 3C), h (T,
// hidden) bf16. The seven launches of the fp32 form on the bf16 stages.
int trr_swin_block_fwd_bf16(const trr::bf16* x, const float* g1, const float* be1,
                            const trr::bf16* wq, const float* bq, const trr::bf16* wp,
                            const float* bp, const float* bias, const float* g2, const float* be2,
                            const trr::bf16* w1, const float* b1, const trr::bf16* w2,
                            const float* b2, const float* s1, const float* s2, trr::bf16* y,
                            trr::bf16* qkv, trr::bf16* h, trr::bf16* out, trr::bf16* P,
                            trr::bf16* att, trr::bf16* z, int B, int H, int W, int C, int nh,
                            int hidden, int kinds, int shift, float eps, float scale,
                            cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::ln_rows_bf16(x, g1, be1, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps,
                            stream));
  TRR_TRY(trr::linear_bf16(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY(trr::attn_rows_fwd_bf16<64>(qkv, bias, att, P, B, H, W, C, nh, 8, 8, kinds, shift, scale,
                                      stream));
  TRR_TRY(trr::linear_bf16<trr::kLinearResidual>(att, wp, bp, z, T, C, C, stream, x, s1, hw));
  TRR_TRY(trr::ln_rows_bf16(z, g2, be2, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps,
                            stream));
  TRR_TRY(trr::linear_bf16<trr::kLinearGelu>(y, w1, b1, h, T, C, hidden, stream));
  return (int)trr::linear_bf16<trr::kLinearResidual>(h, w2, b2, out, T, hidden, C, stream, z, s2,
                                                     hw);
}

// The bf16 saved-P backward (#5's bf16 form): x, z, dout, att (B, H, W, C)
// and P bf16 from the forward, the weights and fp32 operands as
// trr_swin_block_fwd_bf16 takes them. Scratch: y, y2, dm, dzp, datt (T, C)
// bf16, dz (T, C) fp32, stats1, stats2 (T, 2), hg, dh (T, hidden) bf16 and
// dh32 (T, hidden) fp32, qkv, dqkv (T, 3C) bf16, dS fp32 shaped as P,
// ln_part as trr_swin_block_bwd's, part the largest
// trr_weight_grad_bf16_part_floats of the four gradients. Writes dx (bf16) and the fp32
// gradients as trr_swin_block_bwd does.
int trr_swin_block_bwd_bf16(const trr::bf16* x, const trr::bf16* z, const trr::bf16* dout,
                            const trr::bf16* P, const trr::bf16* att, const float* g1,
                            const float* be1, const trr::bf16* wq, const float* bq,
                            const trr::bf16* wp, const float* g2, const float* be2,
                            const trr::bf16* w1, const float* b1, const trr::bf16* w2,
                            const float* s1, const float* s2, trr::bf16* y, float* stats1,
                            trr::bf16* y2, float* stats2, trr::bf16* dm, trr::bf16* hg,
                            trr::bf16* dh, float* dh32, float* dz, trr::bf16* dzp,
                            trr::bf16* datt, trr::bf16* qkv, trr::bf16* dqkv, float* dS,
                            float* ln_part, float* part, trr::bf16* dx, float* dln1, float* dq,
                            float* dp, float* dbias, float* dln2, float* d1, float* d2, int B,
                            int H, int W, int C, int nh, int hidden, int kinds, int shift,
                            float eps, float scale, cudaStream_t stream) {
  using trr::bf16;
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  const int nblk = (int)((T + trr::kTcRows - 1) / trr::kTcRows);
  // the MLP half: dz (fp32), dzp = bf16(s1 dz)
  TRR_TRY(trr::ln_rows_bf16(z, g2, be2, y2, stats2, dout, s2, dm, T, hw, C, eps, stream));
  TRR_TRY(trr::ln_rows_bf16(x, g1, be1, y, stats1, nullptr, nullptr, nullptr, T, hw, C, eps,
                            stream));
  TRR_TRY(trr::mlp_hidden_bf16(y2, dm, w1, b1, w2, hg, dh, dh32, T, C, hidden, stream));
  TRR_TRY((trr::rows_bf16<trr::kRowsLn, bf16, float>(dh, w1, T, hidden, C, z, stats2, g2, dout,
                                                    s1, hw, dz, dzp, ln_part, stream)));
  TRR_TRY(trr::sum_rows(ln_part, nblk, 2LL * C, dln2, stream));
  // the attention half: datt, qkv, the saved-P window attention, dx
  TRR_TRY((trr::rows_bf16<trr::kRowsStore, float, bf16>(dzp, wp, T, C, C, nullptr, nullptr,
                                                       nullptr, nullptr, nullptr, hw, datt,
                                                       nullptr, nullptr, stream)));
  TRR_TRY(trr::linear_bf16(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY(trr::attn_rows_bwd_saved_bf16<64>(qkv, P, datt, dqkv, dS, B, H, W, C, nh, 8, 8, kinds,
                                            shift, scale, stream));
  TRR_TRY((trr::rows_bf16<trr::kRowsLn, float, bf16>(dqkv, wq, T, 3 * C, C, x, stats1, g1, dz,
                                                    nullptr, hw, dx, nullptr, ln_part, stream)));
  TRR_TRY(trr::sum_rows(ln_part, nblk, 2LL * C, dln1, stream));
  // the weight gradients; the biases' sums of the fp32 values: s2 dout, dh, s1 dz, dqkv
  TRR_TRY(trr::weight_grad_bf16(hg, dm, T, hidden, C, nullptr, dout, s2, hw, part, d2, stream));
  TRR_TRY(trr::weight_grad_bf16(y2, dh, T, C, hidden, dh32, nullptr, nullptr, hw, part, d1,
                                stream));
  TRR_TRY(trr::weight_grad_bf16(att, dzp, T, C, C, dz, nullptr, s1, hw, part, dp, stream));
  TRR_TRY(trr::weight_grad_bf16(y, dqkv, T, C, 3 * C, nullptr, dqkv, nullptr, hw, part, dq,
                                stream));
  return (int)trr::launch_dbias(dS, B, H / 8, W / 8, nh, kinds, trr::kTile * trr::kTile, dbias,
                                stream);
}

// The bf16 attention half (#1's bf16 form) at 12x12 windows: x, z (B, H, W,
// C) bf16; wq (C, 3C), wp (C, C) bf16 and their transposes wqt (3C, C), wpt
// (C, C); g, be, bq, bp, bias (kinds, nh, 144, 144), s (B) fp32; scratch y,
// att (T, C) and qkv (T, 3C) bf16. The windows are those of x rolled by
// (-shift, -shift), z comes back in x's frame. The products run on
// linear_tma_bf16_kernel where linear_tma_fits (C a multiple of 8, at most
// 256; x, z and the operands 16-byte aligned), else on linear_bf16_kernel.
int trr_attn_block_fwd_bf16(const trr::bf16* x, const float* g, const float* be,
                            const trr::bf16* wq, const trr::bf16* wqt, const float* bq,
                            const trr::bf16* wp, const trr::bf16* wpt, const float* bp,
                            const float* bias, const float* s, trr::bf16* y, trr::bf16* qkv,
                            trr::bf16* att, trr::bf16* z, int B, int H, int W, int C, int nh,
                            int ws, int kinds, int shift, float eps, float scale,
                            cudaStream_t stream) {
  if (ws != 12) return (int)cudaErrorInvalidValue;
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  const bool tma = trr::linear_tma_fits(y, wqt, qkv, nullptr, C, 3 * C) &&
                   trr::linear_tma_fits(att, wpt, z, x, C, C);
  TRR_TRY(trr::ln_rows_bf16(x, g, be, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps,
                            stream));
  if (tma)
    TRR_TRY(trr::linear_tma_bf16(y, wqt, bq, qkv, T, C, 3 * C, stream));
  else
    TRR_TRY(trr::linear_bf16(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY(trr::attn_group_fwd_bf16(qkv, bias, att, B, H, W, C, nh, kinds, shift, scale, stream));
  if (tma)
    return (int)trr::linear_tma_bf16<trr::kLinearResidual>(att, wpt, bp, z, T, C, C, stream, x,
                                                           s, hw);
  return (int)trr::linear_bf16<trr::kLinearResidual>(att, wp, bp, z, T, C, C, stream, x, s, hw);
}

// Whether #1's bf16 form runs its products on linear_tma_bf16_kernel at
// rows of C channels (16-byte aligned operands).
int trr_attn_block_fwd_bf16_tma(int C) {
  return trr::linear_tma_fits(nullptr, nullptr, nullptr, nullptr, C, 3 * C);
}

// The bf16 recompute backward (#6's bf16 form) at 12x12 windows: x, dout
// (B, H, W, C) bf16 and the operands as trr_attn_block_fwd_bf16 takes them.
// Scratch: y, dzp, datt, att (T, C) bf16, stats (T, 2), qkv, dqkv (T, 3C)
// bf16, dS the groups' dbias sums (trr_attn_group_part_floats), ln_part
// (ceil(T / 128), 2C), part (the larger trr_weight_grad_bf16_part_floats of
// dwq and dwp). Writes dx
// (bf16), dln = dg | dbe, dq = dwq | dbq, dp = dwp | dbp and dbias (kinds,
// nh, 144, 144) in fp32; dbp sums the fp32 s dout, dbq the bf16 dqkv.
int trr_attn_block_bwd_bf16(const trr::bf16* x, const float* g, const float* be,
                            const trr::bf16* wq, const float* bq, const trr::bf16* wp,
                            const float* bias, const float* s, const trr::bf16* dout,
                            trr::bf16* y, float* stats, trr::bf16* dzp, trr::bf16* datt,
                            trr::bf16* qkv, trr::bf16* dqkv, trr::bf16* att, float* dS,
                            float* ln_part, float* part, trr::bf16* dx, float* dln, float* dq,
                            float* dp, float* dbias, int B, int H, int W, int C, int nh, int ws,
                            int kinds, int shift, float eps, float scale, cudaStream_t stream) {
  using trr::bf16;
  if (ws != 12) return (int)cudaErrorInvalidValue;
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  const int nblk = (int)((T + trr::kTcRows - 1) / trr::kTcRows);
  TRR_TRY(trr::ln_rows_bf16(x, g, be, y, stats, dout, s, dzp, T, hw, C, eps, stream));
  TRR_TRY((trr::rows_bf16<trr::kRowsStore, float, bf16>(dzp, wp, T, C, C, nullptr, nullptr,
                                                       nullptr, nullptr, nullptr, hw, datt,
                                                       nullptr, nullptr, stream)));
  TRR_TRY(trr::linear_bf16(y, wq, bq, qkv, T, C, 3 * C, stream));
  TRR_TRY(trr::attn_group_bwd_bf16(qkv, bias, datt, dqkv, att, dS, dbias, B, H, W, C, nh, kinds,
                                   shift, scale, stream));
  TRR_TRY((trr::rows_bf16<trr::kRowsLn, bf16, bf16>(dqkv, wq, T, 3 * C, C, x, stats, g, dout,
                                                   nullptr, hw, dx, nullptr, ln_part, stream)));
  TRR_TRY(trr::sum_rows(ln_part, nblk, 2LL * C, dln, stream));
  TRR_TRY(trr::weight_grad_bf16(att, dzp, T, C, C, nullptr, dout, s, hw, part, dp, stream));
  return (int)trr::weight_grad_bf16(y, dqkv, T, C, 3 * C, nullptr, dqkv, nullptr, hw, part, dq,
                                    stream);
}

// The bf16 MLP half (#2's bf16 form): x, out (B, H, W, C) bf16; w1 (C,
// hidden), w2 (hidden, C) bf16; g, be, b1, b2, s fp32; scratch y (T, C) and
// h (T, hidden) bf16. Three launches: #4's MLP stages.
int trr_ln_mlp_fwd_bf16(const trr::bf16* x, const float* g, const float* be, const trr::bf16* w1,
                        const float* b1, const trr::bf16* w2, const float* b2, const float* s,
                        trr::bf16* y, trr::bf16* h, trr::bf16* out, int B, int H, int W, int C,
                        int hidden, float eps, cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::ln_rows_bf16(x, g, be, y, nullptr, nullptr, nullptr, nullptr, T, hw, C, eps,
                            stream));
  TRR_TRY(trr::linear_bf16<trr::kLinearGelu>(y, w1, b1, h, T, C, hidden, stream));
  return (int)trr::linear_bf16<trr::kLinearResidual>(h, w2, b2, out, T, hidden, C, stream, x, s,
                                                     hw);
}

// The bf16 MLP backward (#7's bf16 form): x, dout, dx (B, H, W, C) bf16; w1,
// w2 bf16 and g, be, b1, s fp32 as trr_ln_mlp_fwd_bf16 takes them. Scratch:
// y, dm (T, C) bf16, stats (T, 2), hg, dh (T, hidden) bf16, dh32 (T,
// hidden) fp32, ln_part and dyw as trr_ln_mlp_bwd's, part the larger
// trr_weight_grad_bf16_part_floats of the two gradients. Writes dx and the fp32
// dln = dg | dbe, d1 = dw1 | db1 and d2 = dw2 | db2, whose bias sums add
// the fp32 dm = s dout and dh.
int trr_ln_mlp_bwd_bf16(const trr::bf16* x, const trr::bf16* dout, const float* g,
                        const float* be, const trr::bf16* w1, const float* b1,
                        const trr::bf16* w2, const float* s, trr::bf16* y, float* stats,
                        trr::bf16* dm, trr::bf16* hg, trr::bf16* dh, float* dh32, float* ln_part,
                        float* part, float* dyw, trr::bf16* dx, float* dln, float* d1, float* d2,
                        int B, int H, int W, int C, int hidden, float eps, cudaStream_t stream) {
  using trr::bf16;
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::ln_rows_bf16(x, g, be, y, stats, dout, s, dm, T, hw, C, eps, stream));
  TRR_TRY(trr::mlp_hidden_bf16(y, dm, w1, b1, w2, hg, dh, dh32, T, C, hidden, stream));
  if (C <= trr::kRowsMaxC) {
    TRR_TRY((trr::rows_bf16<trr::kRowsLn, bf16, bf16>(dh, w1, T, hidden, C, x, stats, g, dout,
                                                     nullptr, hw, dx, nullptr, ln_part,
                                                     stream)));
  } else {  // the split rows stage: dy (fp32) to dyw in two parts, then the LN rows
    if (C > trr::kRowsWideMaxC || dyw == nullptr) return (int)cudaErrorInvalidValue;
    const int c0 = trr::kRowsHalf;
    TRR_TRY((trr::rows_bf16<trr::kRowsStore, float, float>(
        dh, w1, T, hidden, c0, nullptr, nullptr, nullptr, nullptr, nullptr, hw, dyw, nullptr,
        nullptr, stream)));
    TRR_TRY((trr::rows_bf16<trr::kRowsStore, float, float>(
        dh, w1 + (size_t)c0 * hidden, T, hidden, C - c0, nullptr, nullptr, nullptr, nullptr,
        nullptr, hw, dyw + T * c0, nullptr, nullptr, stream)));
    TRR_TRY(trr::ln_bwd_rows(dyw, c0, T, C, x, stats, g, dout, (const float*)nullptr, hw, dx,
                             (bf16*)nullptr, ln_part, stream));
  }
  TRR_TRY(trr::weight_grad_bf16(hg, dm, T, hidden, C, nullptr, dout, s, hw, part, d2, stream));
  TRR_TRY(trr::weight_grad_bf16(y, dh, T, C, hidden, dh32, nullptr, nullptr, hw, part, d1,
                                stream));
  return (int)trr::sum_rows(ln_part, (int)((T + trr::kTcRows - 1) / trr::kTcRows), 2LL * C, dln,
                            stream);
}

size_t trr_linear_bf16_smem_bytes(int N) {
  return (size_t)trr::wg_bf16_bytes(trr::linear_cols(N));
}
size_t trr_rows_bf16_smem_bytes(int C) { return (size_t)trr::rows_bf16_smem_bytes(C); }
size_t trr_hidden_bf16_smem_bytes() { return (size_t)trr::hidden_bf16_smem_bytes(); }
size_t trr_weight_grad_bf16_smem_bytes(int N) {
  return (size_t)trr::wg_bf16_smem_bytes(trr::wg_cols(N));
}
size_t trr_weight_grad_bf16_part_floats(int T, int M, int N) {
  return (size_t)trr::wg_part_floats(T, M, N);
}
size_t trr_attn_group_part_floats(int B, int H, int W, int nh, int kinds) {
  return (size_t)trr::attn_group_part_floats(B, H, W, nh, kinds);
}

// The largest shared memory of the bf16 attention half's kernels (#1 and
// #6's bf16 forms) at 12x12 windows and rows of C channels.
size_t trr_attn_block_bf16_smem_bytes(int C) {
  return (size_t)std::max(
      {trr::wg_bf16_bytes(trr::linear_cols(3 * C)), trr::wg_bf16_bytes(trr::linear_cols(C)),
       trr::rows_bf16_smem_bytes(C), trr::wg_bf16_smem_bytes(trr::wg_cols(3 * C)),
       trr::wg_bf16_smem_bytes(trr::wg_cols(C)),
       trr::attn_group_fwd_smem_bytes(), trr::attn_group_smem_bytes(),
       trr::linear_tma_smem_bytes()});
}

// out (M*N + N) = (A^T B, column sums of B) of A (T, M) and B (T, N), through
// part (trr_weight_grad_part_floats(T, M, N) floats).
int trr_weight_grad(const float* A, const float* B, int T, int M, int N, float* part, float* out,
                    cudaStream_t stream) {
  return (int)trr::weight_grad(A, B, T, M, N, part, out, stream);
}

// out (M*N + N) = (A^T B, the column sums of sf or, where sf is null, of sb)
// of A (T, M) and B (T, N) bf16, sf (T, N) fp32 or sb (T, N) bf16, through
// part (trr_weight_grad_bf16_part_floats(T, M, N) floats): the bf16
// post-norm halves' weight gradients (#12 and #14's bf16 forms,
// fused_block_v2.cu), and the stage alone for its tests.
int trr_weight_grad_bf16(const trr::bf16* A, const trr::bf16* B, int T, int M, int N,
                         const float* sf, const trr::bf16* sb, float* part, float* out,
                         cudaStream_t stream) {
  return (int)trr::weight_grad_bf16(A, B, T, M, N, sf, sb, nullptr, 1, part, out, stream);
}

int trr_sum_rows(const float* part, int S, int L, float* out, cudaStream_t stream) {
  return (int)trr::sum_rows(part, S, L, out, stream);
}

// dbias (kinds, nh, 64, 64) from dS (B, H/8, W/8, nh, 64, 64), which the
// reduction overwrites.
int trr_dbias(float* dS, int B, int nwh, int nww, int nh, int kinds, float* dbias,
              cudaStream_t stream) {
  return (int)trr::launch_dbias(dS, B, nwh, nww, nh, kinds, trr::kTile * trr::kTile, dbias,
                                stream);
}

}  // extern "C"
