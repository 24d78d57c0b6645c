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
//      buffer that dbias_kernel (common.cuh) sums per kind in window order:
//      recompute: tc_attn.cuh's attn_rows_bwd_tc_kernel (#8's too), its six
//      products (S = q k^T, att = P v for dwp, dV += P^T dA, dP = dA v^T, dQ = scale dS k,
//      dK += scale dS^T q) on mma.sync m16n8k8 tf32 in 3xTF32 (tc_attn.cuh),
//      the head dimension zero-padded to 32, the softmax and dS = P (dP -
//      rowsum(P dP)) on the accumulator fragments; two warps a 16-row tile,
//      each over half the keys, and two blocks a SM (6 warps and 99,264 B
//      each at n 144). Its products take about a fifth of its time at the
//      tensor cores' mma.sync rate; what bounds it is moving its rows: q,
//      k, v, dA in, att and dq | dk | dv out, a head row (120 bytes) at a
//      time through shared memory, and 191 MB of dS at SRFormerV2's block.
//      saved-P: attn_rows_bwd_saved_kernel<N, RB>, fp32 FMA (not
//      redesigned): each row block's P read from the forward's, 4 products.
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

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of the saved-P backward's window attention, in floats: v
// (hd, N) transposed and k (N, 32), this row block's dA (hd, RB) transposed
// and q and dA (RB, 32), the P / dS rows (RB, N + 4).
__host__ __device__ inline int attn_rows_bwd_saved_smem_floats(int N, int RB, int hd) {
  return hd * N + N * kVLd + hd * RB + 2 * RB * kVLd + RB * (N + 4);
}

// acc[i][e] = sum over j < N of A[(rg*RPT + i) * lda + j] * Bm[j * kVLd + cl*2 + e]: rows of
// an (RB, N) tile in shared memory times an (N, 32) row-major one.
template <int N, int RB>
__device__ __forceinline__ void rows_times_v(const float* A, int lda, const float* Bm,
                                             float (&acc)[RB / kLanes][2]) {
  constexpr int RPT = RB / kLanes;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = 0.f;
  const float* arow = A + rg * RPT * lda;
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(Bm + j * kVLd + cl * 2);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = arow[i * lda + j];
      acc[i][0] = fmaf(a, bv.x, acc[i][0]);
      acc[i][1] = fmaf(a, bv.y, acc[i][1]);
    }
  }
}

// acc[i][e] += sum over r < RB of A[r * lda + kg + 16 i] * Bm[r * kVLd + kl*2 + e]: the
// transposed (RB, N) tile times an (RB, 32) row-major one, for this thread's
// keys kg + 16 i and channels kl*2 + e (kg, kl: the thread's row group and lane).
template <int N, int RB>
__device__ __forceinline__ void cols_times_rows(const float* A, int lda, const float* Bm,
                                                float (&acc)[N / kLanes][2]) {
  constexpr int CPL = N / kLanes;
  const int kg = threadIdx.x / kLanes, kl = threadIdx.x % kLanes;
  for (int r = 0; r < RB; ++r) {
    const float2 bv = *reinterpret_cast<const float2*>(Bm + r * kVLd + kl * 2);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float a = A[r * lda + kg + kLanes * i];
      acc[i][0] = fmaf(a, bv.x, acc[i][0]);
      acc[i][1] = fmaf(a, bv.y, acc[i][1]);
    }
  }
}

// One block per (ws x ws window, head), N = ws * ws; the query rows in blocks
// of RB. From qkv (T, 3C), the forward's softmax P (B, H/ws, W/ws, nh, N, N)
// and datt (T, C): writes this head's dq | dk | dv into dqkv (T, 3C) and dS
// into a buffer shaped as P. Where attn_rows_bwd_tc_kernel rebuilds S, the
// softmax and P v, this one reads P's row block: 4 products per row block,
// not 6, and no bias table.
template <int N, int RB>
__global__ void __launch_bounds__(kThreads, 2)
    attn_rows_bwd_saved_kernel(const float* __restrict__ qkv, const float* __restrict__ P,
                               const float* __restrict__ datt, float* __restrict__ dqkv,
                               float* __restrict__ dS, int H, int W, int C, int nh, int ws,
                               int shift, float scale) {
  constexpr int RPT = RB / kLanes, CPL = N / kLanes, kLd = N + 4;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / ws, nwh = H / ws;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y, h = blockIdx.z;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  float* vT = smem;              // (hd, N)
  float* k = vT + hd * N;        // (N, 32)
  float* dAT = k + N * kVLd;     // (hd, RB) this row block's datt
  float* q = dAT + hd * RB;      // (RB, 32)
  float* dA = q + RB * kVLd;     // (RB, 32)
  float* T = dA + RB * kVLd;     // (RB, N + 4): P, then dS
  auto token = [&](int r) { return roll_token(b, wi, wj, r, H, W, ws, ws, shift); };
  const size_t head = (((size_t)b * nwh * nww + blockIdx.x) * nh + h) * N * N;

  for (int e = threadIdx.x; e < N * kVLd; e += kThreads) {
    const int r = e / kVLd, d = e % kVLd;
    const float* src = qkv + token(r) * C3 + C + h * hd + d;
    k[e] = d < hd ? __ldg(src) : 0.f;
    if (d < hd) vT[d * N + r] = __ldg(src + C);
  }
  float dk[CPL][2], dv[CPL][2];
#pragma unroll
  for (int i = 0; i < CPL; ++i) dk[i][0] = dk[i][1] = dv[i][0] = dv[i][1] = 0.f;

  for (int r0 = 0; r0 < N; r0 += RB) {
    for (int e = threadIdx.x; e < RB * kVLd; e += kThreads) {
      const int r = e / kVLd, d = e % kVLd;
      const long long t = token(r0 + r);
      const float qv = d < hd ? __ldg(qkv + t * C3 + h * hd + d) : 0.f;
      const float av = d < hd ? __ldg(datt + t * C + h * hd + d) : 0.f;
      q[e] = qv;
      dA[e] = av;
      if (d < hd) dAT[d * RB + r] = av;
    }
    const float* prow = P + head + (size_t)r0 * N;
    for (int e = threadIdx.x; e < RB * N; e += kThreads) T[(e / N) * kLd + e % N] = __ldg(prow + e);
    __syncthreads();  // q, dA and P (and, the first time, k and v) staged
    float p[RPT][CPL];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) p[i][j] = T[(rg * RPT + i) * kLd + cl + kLanes * j];
    cols_times_rows<N, RB>(T, kLd, dA, dv);  // dV += P^T dA
    {
      // dP = dA v^T at this thread's places of P, then dS = P (dP - rowsum(P dP))
      float dp[RPT][CPL];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) dp[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float a[RPT], bb[CPL];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = dAT[d * RB + rg * RPT + i];
#pragma unroll
        for (int j = 0; j < CPL; ++j) bb[j] = vT[d * N + cl + kLanes * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPL; ++j) dp[i][j] = fmaf(a[i], bb[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float delta = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) delta = fmaf(p[i][j], dp[i][j], delta);
        delta = half_sum(delta);
#pragma unroll
        for (int j = 0; j < CPL; ++j) p[i][j] *= dp[i][j] - delta;  // now dS
      }
    }
    __syncthreads();  // every thread is done reading P
    float* grow = dS + head + (size_t)r0 * N;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int idx = (rg * RPT + i) * N + cl + kLanes * j;
        T[(rg * RPT + i) * kLd + cl + kLanes * j] = p[i][j];
        grow[idx] = p[i][j];
      }
    __syncthreads();
    {  // dQ = scale dS k
      float acc[RPT][2];
      rows_times_v<N, RB>(T, kLd, k, acc);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = cl * 2 + e;
        if (d < hd) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            dqkv[token(r0 + rg * RPT + i) * C3 + h * hd + d] = scale * acc[i][e];
        }
      }
    }
    cols_times_rows<N, RB>(T, kLd, q, dk);  // dK += dS^T q (scaled once, at the end)
    __syncthreads();  // q, dA and the tile are rewritten by the next row block
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = cl * 2 + e;
    if (d < hd) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const long long t = token(rg + kLanes * i);
        dqkv[t * C3 + C + h * hd + d] = scale * dk[i][e];
        dqkv[t * C3 + 2 * C + h * hd + d] = dv[i][e];
      }
    }
  }
}

// The row-block plan of a window of n tokens: (N, RB) = (144, 48) or (64, 64).
inline int rows_block(int n) { return n == 144 ? 48 : n == 64 ? 64 : 0; }

template <int N, int RB>
cudaError_t attn_rows_bwd_saved(const float* qkv, const float* P, const float* datt, float* dqkv,
                                float* dS, int B, int H, int W, int C, int nh, int ws, int shift,
                                float scale, cudaStream_t stream) {
  const int floats = attn_rows_bwd_saved_smem_floats(N, RB, C / nh);
  const cudaError_t err = set_smem(attn_rows_bwd_saved_kernel<N, RB>, floats);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / ws) * (W / ws), B, nh);
  attn_rows_bwd_saved_kernel<N, RB><<<grid, kThreads, floats * sizeof(float), stream>>>(
      qkv, P, datt, dqkv, dS, H, W, C, nh, ws, shift, scale);
  return cudaGetLastError();
}

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
  const int n = ws * ws, rb = trr::rows_block(n);
  if (rb == 0) return 0;
  const trr::AttnPlan plan = trr::attn_plan(n);
  return (size_t)std::max(
      {trr::linear_smem_bytes(), trr::rows_smem_bytes(C),
       trr::attn_rows_bwd_tc_smem_floats(n, plan.rb, plan.ks, true) * (int)sizeof(float)});
}

size_t trr_attn_train_bwd_smem_bytes(int C, int nh, int ws) {
  const int n = ws * ws, rb = trr::rows_block(n);
  if (rb == 0) return 0;
  return (size_t)std::max(
      {trr::linear_smem_bytes(), trr::rows_smem_bytes(C),
       trr::attn_rows_bwd_saved_smem_floats(n, rb, C / nh) * (int)sizeof(float)});
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
  if (trr::rows_block(n) == 0) return (int)cudaErrorInvalidValue;
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
  if (trr::rows_block(n) == 0) return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  cudaError_t err = trr::bwd_head(x, g, be, wq, bq, wp, s, dout, qkv, y, stats, dzp, datt, tokens,
                                  hw, C, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = n == 144 ? trr::attn_rows_bwd_saved<144, 48>(qkv, P, datt, dqkv, dS, B, H, W, C, nh, ws,
                                                     shift, scale, stream)
                 : trr::attn_rows_bwd_saved<64, 64>(qkv, P, datt, dqkv, dS, B, H, W, C, nh, ws,
                                                    shift, scale, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)trr::bwd_tail(dqkv, wq, x, stats, g, dout, dx, ln_part, dS, dbias, B, H, W, C, nh,
                            ws, kinds, stream);
}

}  // extern "C"
