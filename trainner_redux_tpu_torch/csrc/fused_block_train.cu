// The whole pre-LN Swin block for training, forward and saved-P backward,
// fp32, for sm_90a.
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
// 21.2 GFLOP for #7 at C 180, 47.8 at C 240 / hidden 480. Every product but
// the per-window attention's runs on the tensor cores in 3xTF32 through
// the wgmma engine of tc_gemm.cuh (bound: 3 x operations / 495 TFLOP/s);
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
//      lies (K-major); 176,192 B at C 180, 221,248 B at C 240.
//   4. rows_kernel<BN, kRowsStore>: datt = dzp wp^T (#5 only).
//   5. block_bwd_attn_kernel, per 8x8 window, one head at a time (not
//      redesigned): q, k, v from y, then dv, dP, dS, dq, dk from the saved P;
//      dq/dk/dv to dqkv (T, 3C), dS per window for the bias-kind reduction.
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
#include "block_fwd.cuh"
#include "tc_rows.cuh"

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
__host__ __device__ inline int bwd_attn_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return C * kTLd + 4 * kTile * kVLd + 2 * hd * kTLd + 2 * kTile * kTLd + kStageFloats;
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

// One block per 8x8 window of the map rolled by (-shift, -shift), as in the
// forward; the heads one after another. y is LN1(x) (T, C) in x's frame,
// P the saved softmax (B, H/8, W/8, nh, 64, 64), datt (T, C). Writes every
// token's dq | dk | dv into dqkv (T, 3C) and dS into a buffer shaped as P.
__global__ void __launch_bounds__(kThreads, 1)
    block_bwd_attn_kernel(const float* __restrict__ y, const float* __restrict__ wq,
                          const float* __restrict__ bq, const float* __restrict__ P,
                          const float* __restrict__ datt, float* __restrict__ dqkv,
                          float* __restrict__ dS, int H, int W, int C, int nh, int shift,
                          float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / 8, nwh = H / 8;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* yT = smem;                  // (C, 64) LN1 output of the window
  float* q = yT + C * kTLd;          // (64, 32) row-major, this head
  float* k = q + kTile * kVLd;       // (64, 32)
  float* v = k + kTile * kVLd;       // (64, 32)
  float* dA = v + kTile * kVLd;      // (64, 32) this head's columns of datt
  float* vT = dA + kTile * kVLd;     // (hd, 64)
  float* dAT = vT + hd * kTLd;       // (hd, 64)
  float* Ps = dAT + hd * kTLd;       // (64, 64) P of this head
  float* G = Ps + kTile * kTLd;      // (64, 64) dP, then dS
  float* Bs = G + kTile * kTLd;      // weight stage

  auto token = [&](int r) { return window_token(b, wi, wj, r, H, W, shift); };
  const size_t window = (size_t)b * nwh * nww + blockIdx.x;
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    yT[c * kTLd + r] = __ldg(y + token(r) * C + c);
  }
  for (int h = 0; h < nh; ++h) {
    const size_t head = (window * nh + h) * kTile * kTile;
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads)
      Ps[(e / kTile) * kTLd + e % kTile] = __ldg(P + head + e);
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float val = __ldg(datt + token(r) * C + h * hd + d);
      dA[r * kVLd + d] = val;
      dAT[d * kTLd + r] = val;
    }
    // recompute this head's q, k, v exactly as the forward did
    gemm_weights(
        yT, C, wq, C3, 3 * hd, [&](int c) { return (c / hd) * C + h * hd + c % hd; }, Bs,
        [&](int r0, int c, const float* o) {
          const int part = c / hd, d = c % hd;
          const float bb = __ldg(bq + part * C + h * hd + d);
          float* dst = part == 0 ? q : (part == 1 ? k : v);
#pragma unroll
          for (int i = 0; i < 4; ++i) dst[(r0 + i) * kVLd + d] = o[i] + bb;
          if (part == 2)
            *reinterpret_cast<float4*>(vT + d * kTLd + r0) =
                make_float4(o[0] + bb, o[1] + bb, o[2] + bb, o[3] + bb);
        });
    __syncthreads();
    {  // dv[j][d] = sum_r P[r][j] dA[r][d]
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        const float4 p = ld4(Ps + r * kTLd + rg * 4);
        const float2 a = *reinterpret_cast<const float2*>(dA + r * kVLd + cl * 2);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(pv[i], a.x, acc[i][0]);
          acc[i][1] = fmaf(pv[i], a.y, acc[i][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = cl * 2 + jj;
        if (d < hd) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dqkv[token(rg * 4 + i) * C3 + 2 * C + h * hd + d] = acc[i][jj];
        }
      }
    }
    {  // dP[r][j] = sum_d dA[r][d] v[j][d]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float4 a = ld4(dAT + d * kTLd + rg * 4);
        const float4 bv = ld4(vT + d * kTLd + cl * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(G + (rg * 4 + i) * kTLd + cl * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    // dS = P (dP - rowsum(P dP)), one warp per row
    for (int r = warp; r < kTile; r += kWarps) {
      const float p0 = Ps[r * kTLd + lane], p1 = Ps[r * kTLd + lane + 32];
      const float d0 = G[r * kTLd + lane], d1 = G[r * kTLd + lane + 32];
      const float delta = warp_sum(p0 * d0 + p1 * d1);
      const float s0 = p0 * (d0 - delta), s1 = p1 * (d1 - delta);
      G[r * kTLd + lane] = s0;
      G[r * kTLd + lane + 32] = s1;
      dS[head + r * kTile + lane] = s0;
      dS[head + r * kTile + lane + 32] = s1;
    }
    __syncthreads();
    {  // dq[r][d] = scale sum_j dS[r][j] k[j][d]
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      const float* g = G + rg * 4 * kTLd;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(k + j * kVLd + cl * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = g[i * kTLd + j];
          acc[i][0] = fmaf(a, kv.x, acc[i][0]);
          acc[i][1] = fmaf(a, kv.y, acc[i][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = cl * 2 + jj;
        if (d < hd) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dqkv[token(rg * 4 + i) * C3 + h * hd + d] = scale * acc[i][jj];
        }
      }
    }
    {  // dk[j][d] = scale sum_r dS[r][j] q[r][d]
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        const float4 sv = ld4(G + r * kTLd + rg * 4);
        const float2 qv = *reinterpret_cast<const float2*>(q + r * kVLd + cl * 2);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(s4[i], qv.x, acc[i][0]);
          acc[i][1] = fmaf(s4[i], qv.y, acc[i][1]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = cl * 2 + jj;
        if (d < hd) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dqkv[token(rg * 4 + i) * C3 + C + h * hd + d] = scale * acc[i][jj];
        }
      }
    }
    __syncthreads();  // this head's tiles are free for the next
  }
}

}  // namespace trr

extern "C" {

size_t trr_rows_smem_bytes(int C) { return (size_t)trr::rows_smem_bytes(C); }
size_t trr_linear_smem_bytes() { return (size_t)trr::linear_smem_bytes(); }
size_t trr_hidden_smem_bytes() { return (size_t)trr::hidden_smem_bytes(); }
size_t trr_atb_smem_bytes() { return (size_t)trr::atb_smem_bytes(); }
size_t trr_bwd_attn_smem_bytes(int C, int nh) {
  return (size_t)trr::bwd_attn_smem_floats(C, nh) * sizeof(float);
}
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
// the two gradients). Writes dx, dln = dg | dbe (2C), d1 = dw1 | db1
// (C * hidden + hidden) and d2 = dw2 | db2 (hidden * C + C).
int trr_ln_mlp_bwd(const float* x, const float* dout, const float* g, const float* be,
                   const float* w1, const float* b1, const float* w2, const float* s, float* y,
                   float* stats, float* dm, float* hg, float* dh, float* ln_part, float* part,
                   float* dx, float* dln, float* d1, float* d2, int B, int H, int W, int C,
                   int hidden, float eps, cudaStream_t stream) {
  const long long T = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::ln_rows(x, g, be, y, stats, dout, s, dm, T, hw, C, eps, stream));
  TRR_TRY(trr::mlp_hidden(y, dm, w1, b1, w2, hg, dh, T, C, hidden, stream));
  TRR_TRY(trr::rows<trr::kRowsLn>(dh, w1, T, hidden, C, x, stats, g, dout, nullptr, hw, dx,
                                  nullptr, ln_part, stream));
  TRR_TRY(trr::weight_grad(hg, dm, T, hidden, C, part, d2, stream));
  TRR_TRY(trr::weight_grad(y, dh, T, C, hidden, part, d1, stream));
  return (int)trr::sum_rows(ln_part, (int)((T + trr::kTcRows - 1) / trr::kTcRows), 2LL * C, dln,
                            stream);
}

// The saved-P backward of the whole block (#5): operands as the forward
// takes them, and P, att, z from it; dout (B, H, W, C). Scratch: y, y2, dm,
// dz, dzp, datt (T, C), stats1, stats2 (T, 2), hg, dh (T, hidden), dqkv
// (T, 3C), dS shaped as P, ln_part (ceil(T / 128), 2C), part (the largest
// trr_weight_grad_part_floats of the four gradients). Writes dx; dln1 =
// dg1 | dbe1 and dln2 = dg2 | dbe2 (2C each); dq = dwq | dbq, dp = dwp |
// dbp, d1 = dw1 | db1, d2 = dw2 | db2; dbias (kinds, nh, 64, 64).
int trr_swin_block_bwd(const float* x, const float* z, const float* dout, const float* P,
                       const float* att, const float* g1, const float* be1, const float* wq,
                       const float* bq, const float* wp, const float* g2, const float* be2,
                       const float* w1, const float* b1, const float* w2, const float* s1,
                       const float* s2, float* y, float* stats1, float* y2, float* stats2,
                       float* dm, float* hg, float* dh, float* dz, float* dzp, float* datt,
                       float* dqkv, float* dS, float* ln_part, float* part, float* dx,
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
  // the attention half: datt, then dqkv and dS per window, then dx
  TRR_TRY(trr::rows<trr::kRowsStore>(dzp, wp, T, C, C, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, hw, datt, nullptr, nullptr, stream));
  const int floats = trr::bwd_attn_smem_floats(C, nh);
  TRR_TRY(trr::set_smem(trr::block_bwd_attn_kernel, floats));
  const dim3 grid((H / 8) * (W / 8), B);
  trr::block_bwd_attn_kernel<<<grid, trr::kThreads, floats * sizeof(float), stream>>>(
      y, wq, bq, P, datt, dqkv, dS, H, W, C, nh, shift, scale);
  TRR_TRY(cudaGetLastError());
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

// out (M*N + N) = (A^T B, column sums of B) of A (T, M) and B (T, N), through
// part (trr_weight_grad_part_floats(T, M, N) floats).
int trr_weight_grad(const float* A, const float* B, int T, int M, int N, float* part, float* out,
                    cudaStream_t stream) {
  return (int)trr::weight_grad(A, B, T, M, N, part, out, stream);
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
