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
// The forward is the attention-half kernel of block_fwd.cuh told to write P
// and att, then the MLP-half kernel: two launches, one call.
//
// What bounds the backward on the card: fp32 arithmetic. At SwinIR-M
// training shapes (B 8, 64x64, C 180, hidden 360: 32,768 tokens) it does
// some 47.6 GFLOP against a few hundred MB of activations and saved
// tensors. A TPU core keeps a whole strip of windows in VMEM and carries
// the weight gradients across its sequential grid; here the work splits
// into launches whose working sets fit one thread block's 227 KB:
//   1. block_bwd_tokens_kernel, per 64 tokens: the MLP half's backward
//      (recompute LN2, fc1, GELU; dm, dh, dy2, the LN2 backward -> dz),
//      then datt = s1 dz wp^T and LN1(x) for the attention side. The
//      activations the weight gradients need (y2, gelu(h), dm, dh, dzp, y)
//      go to device memory.
//   2. block_bwd_attn_kernel, per 8x8 window, one head at a time: recompute
//      q, k, v from LN1(x) and the head's wq columns, then dv, dP, dS, dq,
//      dk from the saved P; dq/dk/dv to a (T, 3C) buffer, dS per window to a
//      buffer the bias-kind reduction reads.
//   3. block_bwd_ln1_kernel, per 64 tokens: dy = dqkv wq^T and the LN1
//      backward -> dx.
//   4. weight_grad_kernel, A^T B over all tokens for dw2, dw1, dwp, dwq (and
//      the column sums for the biases), split over token chunks into
//      partial sums that sum_rows_kernel adds in a fixed order; the LN
//      parameter partials of 1 and 3 and the per-window dS reduce the same
//      way. No atomics: two runs give the same gradients bit for bit.
// fused_ln_mlp's backward is step 1's MLP half (mlp_bwd_tile, from x and
// with dx = dout + LN'(dy)) in ln_mlp_bwd_tokens_kernel, then step 4 for
// dw2 and dw1: 21 GFLOP at HAT-M's 32,768 training tokens, bound by fp32
// arithmetic as the whole block's backward is.
// Every product runs on the fp32 FMA units; the tensor cores are later work.
#include "block_fwd.cuh"

namespace trr {

constexpr int kAtbTile = 64;            // output tile (rows and columns) of A^T B
constexpr int kAtbK = 32;               // tokens staged in shared memory per step
constexpr int kAtbLd = kAtbTile + 4;

// Shared memory, in floats, of the three per-tile backward kernels.
__host__ __device__ inline int bwd_tokens_smem_floats(int C, int hidden) {
  return 2 * C * kTLd + hidden * kTLd + kStageFloats + 4 * kTile;
}
__host__ __device__ inline int bwd_attn_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return C * kTLd + 4 * kTile * kVLd + 2 * hd * kTLd + 2 * kTile * kTLd + kStageFloats;
}
__host__ __device__ inline int bwd_ln1_smem_floats(int C) { return 4 * C * kTLd + kStageFloats; }

// The MLP half's backward on the M <= 64 tokens t0.. of one block, from
// the half's input rows xin (T, C): recompute y2 = LN(xin), h = y2 w1 + b1
// and gelu(h); then dm = s2[b] dout, dh = (dm w2^T) gelu'(h), dy2 = dh w1^T
// and the LN backward dx = dout + LN'(dy2). w1t (hidden, C) and w2t
// (C, hidden) are the transposes of w1 and w2. Writes, per token, y2, hg =
// gelu(h), dm, dh and dx; per block the partial sums of dg (first C) and
// dbe (next C) to ln_part. When dxs is not null, s1[b] dx goes to dxs and
// to T1 as well, for the attention half's backward.
// Tiles: T1, T3 (C, 64) and T2 (hidden, 64) transposed, Bs the weight
// stage, st the LN stats (2 * 64).
__device__ __forceinline__ void mlp_bwd_tile(
    const float* __restrict__ xin, const float* __restrict__ dout, const float* __restrict__ g2,
    const float* __restrict__ be2, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w1t, const float* __restrict__ w2t, const float* __restrict__ s2,
    const float* __restrict__ s1, float* __restrict__ y2, float* __restrict__ hg,
    float* __restrict__ dm, float* __restrict__ dh, float* __restrict__ dx,
    float* __restrict__ dxs, float* __restrict__ ln_part, long long t0, int M, long long hw,
    int C, int hidden, float eps, float* T1, float* T2, float* T3, float* Bs, float* st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // y2 = LN(xin)
  layernorm_t([&](int r) { return xin + (t0 + r) * C; }, M, C, g2, be2, eps, T2, st, T1);
  __syncthreads();
  for (int e = threadIdx.x; e < M * C; e += kThreads) {
    const int r = e / C, c = e % C;
    y2[(t0 + r) * C + c] = T1[c * kTLd + r];
  }
  // h = y2 w1 + b1, kept before the GELU; gelu(h) to hg
  gemm_weights(T1, C, w1, hidden, hidden, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(b1 + c);
                 const float h[4] = {o[0] + bb, o[1] + bb, o[2] + bb, o[3] + bb};
                 *reinterpret_cast<float4*>(T2 + c * kTLd + r0) =
                     make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
                 for (int i = 0; i < 4; ++i)
                   if (r0 + i < M) hg[(t0 + r0 + i) * hidden + c] = gelu_erf(h[i]);
               });
  // dm = s2[b] dout
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    float v = 0.f;
    if (r < M) {
      const long long t = t0 + r;
      v = __ldg(s2 + t / hw) * __ldg(dout + t * C + c);
      dm[t * C + c] = v;
    }
    T3[c * kTLd + r] = v;
  }
  // dh = (dm w2^T) * gelu'(h), in place of h
  gemm_weights(T3, C, w2t, hidden, hidden, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 float* p = T2 + c * kTLd + r0;
                 const float4 h = *reinterpret_cast<const float4*>(p);
                 const float d[4] = {o[0] * gelu_erf_grad(h.x), o[1] * gelu_erf_grad(h.y),
                                     o[2] * gelu_erf_grad(h.z), o[3] * gelu_erf_grad(h.w)};
                 *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
#pragma unroll
                 for (int i = 0; i < 4; ++i)
                   if (r0 + i < M) dh[(t0 + r0 + i) * hidden + c] = d[i];
               });
  // dy2 = dh w1^T
  gemm_weights(T2, hidden, w1t, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 *reinterpret_cast<float4*>(T3 + c * kTLd + r0) =
                     make_float4(o[0], o[1], o[2], o[3]);
               });
  __syncthreads();
  // LN backward, one warp per row: dx = dout + inv (dy2 g2 - mean(dy2 g2)
  // - xn2 mean(dy2 g2 xn2)); xn2 kept for the dg partials
  for (int r = warp; r < M; r += kWarps) {
    const long long t = t0 + r;
    const float mean = st[r], inv = st[kTile + r];
    float a = 0.f, bsum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xn = (__ldg(xin + t * C + c) - mean) * inv;
      T2[c * kTLd + r] = xn;
      const float dxh = T3[c * kTLd + r] * __ldg(g2 + c);
      a += dxh;
      bsum += dxh * xn;
    }
    a = warp_sum(a) / C;
    bsum = warp_sum(bsum) / C;
    const float sb = dxs != nullptr ? __ldg(s1 + t / hw) : 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xn = T2[c * kTLd + r];
      const float dxh = T3[c * kTLd + r] * __ldg(g2 + c);
      const float d = __ldg(dout + t * C + c) + inv * (dxh - a - xn * bsum);
      dx[t * C + c] = d;
      if (dxs != nullptr) {
        dxs[t * C + c] = sb * d;
        T1[c * kTLd + r] = sb * d;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < M; ++r) {
      const float d = T3[c * kTLd + r];
      dg = fmaf(d, T2[c * kTLd + r], dg);
      db += d;
    }
    ln_part[(size_t)blockIdx.x * 2 * C + c] = dg;
    ln_part[(size_t)blockIdx.x * 2 * C + C + c] = db;
  }
}

// One block per 64 consecutive tokens. w1 (C, hidden) as in the forward;
// w1t (hidden, C), w2t (C, hidden) and wpt (C, C) are the transposes of w1,
// w2 and wp. Writes, per token: y = LN1(x), its mean and 1/std (stats1),
// y2 = LN2(z), hg = gelu(h), dm = s2 dout, dh, dz, dzp = s1 dz, datt; and
// per block the partial sums of dg2 (first C) and dbe2 (next C).
__global__ void __launch_bounds__(kThreads, 1)
    block_bwd_tokens_kernel(const float* __restrict__ x, const float* __restrict__ z,
                            const float* __restrict__ dout, const float* __restrict__ g1,
                            const float* __restrict__ be1, const float* __restrict__ g2,
                            const float* __restrict__ be2, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w1t,
                            const float* __restrict__ w2t, const float* __restrict__ wpt,
                            const float* __restrict__ s1, const float* __restrict__ s2,
                            float* __restrict__ y, float* __restrict__ stats1,
                            float* __restrict__ y2, float* __restrict__ hg,
                            float* __restrict__ dm, float* __restrict__ dh,
                            float* __restrict__ dz, float* __restrict__ dzp,
                            float* __restrict__ datt, float* __restrict__ ln2_part,
                            long long tokens, long long hw, int C, int hidden, float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  float* T1 = smem;                  // (C, 64): y2, then s1 dz
  float* T2 = T1 + C * kTLd;         // (hidden, 64): h, then dh, then xn2; LN scratch
  float* T3 = T2 + hidden * kTLd;    // (C, 64): dm, then dy2, then y
  float* Bs = T3 + C * kTLd;         // weight stage
  float* st2 = Bs + kStageFloats;    // LN2 mean and 1/std of each row
  float* st1 = st2 + 2 * kTile;      // LN1 mean and 1/std of each row

  mlp_bwd_tile(z, dout, g2, be2, w1, b1, w1t, w2t, s2, s1, y2, hg, dm, dh, dz, dzp, ln2_part,
               t0, M, hw, C, hidden, eps, T1, T2, T3, Bs, st2);
  // datt = dzp wp^T
  gemm_weights(T1, C, wpt, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
#pragma unroll
                 for (int i = 0; i < 4; ++i)
                   if (r0 + i < M) datt[(t0 + r0 + i) * C + c] = o[i];
               });
  // y = LN1(x), the same arithmetic as the forward's, for the attention side
  layernorm_t([&](int r) { return x + (t0 + r) * C; }, M, C, g1, be1, eps, T2, st1, T3);
  __syncthreads();
  for (int e = threadIdx.x; e < M * C; e += kThreads) {
    const int r = e / C, c = e % C;
    y[(t0 + r) * C + c] = T3[c * kTLd + r];
  }
  for (int r = threadIdx.x; r < M; r += kThreads) {
    stats1[(t0 + r) * 2] = st1[r];
    stats1[(t0 + r) * 2 + 1] = st1[kTile + r];
  }
}

// The backward of fused_ln_mlp alone (TPU kernel #7), per 64 consecutive
// tokens: the MLP half of block_bwd_tokens_kernel from x, with dx = dout +
// LN'(dy). Writes y = LN(x), hg, dm, dh and dx per token and the dg / dbe
// partial sums per block; the weight gradients come from weight_grad_kernel.
__global__ void __launch_bounds__(kThreads, 1)
    ln_mlp_bwd_tokens_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                             const float* __restrict__ g, const float* __restrict__ be,
                             const float* __restrict__ w1, const float* __restrict__ b1,
                             const float* __restrict__ w1t, const float* __restrict__ w2t,
                             const float* __restrict__ s, float* __restrict__ y,
                             float* __restrict__ hg, float* __restrict__ dm,
                             float* __restrict__ dh, float* __restrict__ dx,
                             float* __restrict__ ln_part, long long tokens, long long hw, int C,
                             int hidden, float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  float* T1 = smem;
  float* T2 = T1 + C * kTLd;
  float* T3 = T2 + hidden * kTLd;
  float* Bs = T3 + C * kTLd;
  float* st = Bs + kStageFloats;
  mlp_bwd_tile(x, dout, g, be, w1, b1, w1t, w2t, s, nullptr, y, hg, dm, dh, dx, nullptr, ln_part,
               t0, M, hw, C, hidden, eps, T1, T2, T3, Bs, st);
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

// One block per 64 consecutive tokens: dy = dqkv wq^T (wqt is wq's
// transpose, (3C, C)), then the LN1 backward dx = dz + LN1'(dy) with the
// stats the tokens kernel saved; per block the partial sums of dg1 (first
// C) and dbe1 (next C).
__global__ void __launch_bounds__(kThreads, 1)
    block_bwd_ln1_kernel(const float* __restrict__ dqkv, const float* __restrict__ wqt,
                         const float* __restrict__ x, const float* __restrict__ stats1,
                         const float* __restrict__ g1, const float* __restrict__ dz,
                         float* __restrict__ dx, float* __restrict__ ln1_part, long long tokens,
                         int C) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C3 = 3 * C;
  float* DQ = smem;                  // (3C, 64) dqkv; then xn (C, 64)
  float* DY = DQ + C3 * kTLd;        // (C, 64)
  float* Bs = DY + C * kTLd;         // weight stage

  for (int e = threadIdx.x; e < kTile * C3; e += kThreads) {
    const int r = e / C3, c = e % C3;
    DQ[c * kTLd + r] = r < M ? __ldg(dqkv + (t0 + r) * C3 + c) : 0.f;
  }
  gemm_weights(DQ, C3, wqt, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 *reinterpret_cast<float4*>(DY + c * kTLd + r0) =
                     make_float4(o[0], o[1], o[2], o[3]);
               });
  __syncthreads();
  for (int r = warp; r < M; r += kWarps) {
    const long long t = t0 + r;
    const float mean = __ldg(stats1 + 2 * t), inv = __ldg(stats1 + 2 * t + 1);
    float a = 0.f, bsum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xn = (__ldg(x + t * C + c) - mean) * inv;
      DQ[c * kTLd + r] = xn;
      const float dxh = DY[c * kTLd + r] * __ldg(g1 + c);
      a += dxh;
      bsum += dxh * xn;
    }
    a = warp_sum(a) / C;
    bsum = warp_sum(bsum) / C;
    for (int c = lane; c < C; c += 32) {
      const float xn = DQ[c * kTLd + r];
      const float dxh = DY[c * kTLd + r] * __ldg(g1 + c);
      dx[t * C + c] = __ldg(dz + t * C + c) + inv * (dxh - a - xn * bsum);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < M; ++r) {
      const float d = DY[c * kTLd + r];
      dg = fmaf(d, DQ[c * kTLd + r], dg);
      db += d;
    }
    ln1_part[(size_t)blockIdx.x * 2 * C + c] = dg;
    ln1_part[(size_t)blockIdx.x * 2 * C + C + c] = db;
  }
}

// part[z] (M*N + N floats) = A^T B over the tokens [z*chunk, (z+1)*chunk),
// then the column sums of B over the same tokens (blocks of x-index 0 only):
// A (T, M) and B (T, N) row-major. One block per 64x64 output tile and
// token chunk; 4x4 outputs per thread.
__global__ void __launch_bounds__(kThreads)
    weight_grad_kernel(const float* __restrict__ A, const float* __restrict__ B, long long T,
                       int M, int N, int chunk, float* __restrict__ part) {
  __shared__ __align__(16) float As[kAtbK * kAtbLd];
  __shared__ __align__(16) float Bsh[kAtbK * kAtbLd];
  const int m0 = blockIdx.x * kAtbTile, n0 = blockIdx.y * kAtbTile;
  const long long tb = (long long)blockIdx.z * chunk;
  const long long te = min(T, tb + chunk);
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  const bool sums = blockIdx.x == 0 && threadIdx.x < kAtbTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float colsum = 0.f;
  for (long long t = tb; t < te; t += kAtbK) {
    for (int e = threadIdx.x; e < kAtbK * kAtbTile; e += kThreads) {
      const int kk = e / kAtbTile, i = e % kAtbTile;
      const long long tt = t + kk;
      As[kk * kAtbLd + i] = (tt < te && m0 + i < M) ? __ldg(A + tt * M + m0 + i) : 0.f;
      Bsh[kk * kAtbLd + i] = (tt < te && n0 + i < N) ? __ldg(B + tt * N + n0 + i) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kAtbK; ++kk) {
      const float4 a = ld4(As + kk * kAtbLd + rg * 4);
      const float4 bv = ld4(Bsh + kk * kAtbLd + cl * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    if (sums) {
      for (int kk = 0; kk < kAtbK; ++kk) colsum += Bsh[kk * kAtbLd + threadIdx.x];
    }
    __syncthreads();
  }
  const size_t base = (size_t)blockIdx.z * ((size_t)M * N + N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cl * 4 + j;
      if (n < N) part[base + (size_t)m * N + n] = acc[i][j];
    }
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

}  // namespace trr

extern "C" {

size_t trr_bwd_tokens_smem_bytes(int C, int hidden) {
  return (size_t)trr::bwd_tokens_smem_floats(C, hidden) * sizeof(float);
}
size_t trr_bwd_attn_smem_bytes(int C, int nh) {
  return (size_t)trr::bwd_attn_smem_floats(C, nh) * sizeof(float);
}
size_t trr_bwd_ln1_smem_bytes(int C) { return (size_t)trr::bwd_ln1_smem_floats(C) * sizeof(float); }

// The forward: x, out, att, z (B, H, W, C); P (B, H/8, W/8, nh, 64, 64);
// weights (in, out) as in trr_attn_block_fwd and trr_ln_mlp_fwd; s1, s2 (B).
int trr_swin_block_fwd(const float* x, const float* g1, const float* be1, const float* wq,
                       const float* bq, const float* wp, const float* bp, const float* bias,
                       const float* g2, const float* be2, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* s1, const float* s2,
                       float* out, float* P, float* att, float* z, int B, int H, int W, int C,
                       int nh, int hidden, int kinds, int shift, float eps, float scale,
                       cudaStream_t stream) {
  const cudaError_t err = trr::launch_attn_block_fwd(x, g1, be1, wq, bq, wp, bp, bias, s1, z, P,
                                                     att, B, H, W, C, nh, kinds, shift, eps,
                                                     scale, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)trr::launch_ln_mlp_fwd(z, g2, be2, w1, b1, w2, b2, s2, out, B, H, W, C, hidden,
                                     eps, stream);
}

int trr_block_bwd_tokens(const float* x, const float* z, const float* dout, const float* g1,
                         const float* be1, const float* g2, const float* be2, const float* w1,
                         const float* b1, const float* w1t, const float* w2t, const float* wpt,
                         const float* s1, const float* s2, float* y, float* stats1, float* y2,
                         float* hg, float* dm, float* dh, float* dz, float* dzp, float* datt,
                         float* ln2_part, int B, int H, int W, int C, int hidden, float eps,
                         cudaStream_t stream) {
  const int floats = trr::bwd_tokens_smem_floats(C, hidden);
  const cudaError_t err = trr::set_smem(trr::block_bwd_tokens_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTile - 1) / trr::kTile);
  trr::block_bwd_tokens_kernel<<<blocks, trr::kThreads, floats * sizeof(float), stream>>>(
      x, z, dout, g1, be1, g2, be2, w1, b1, w1t, w2t, wpt, s1, s2, y, stats1, y2, hg, dm, dh, dz,
      dzp, datt, ln2_part, tokens, (long long)H * W, C, hidden, eps);
  return (int)cudaGetLastError();
}

// The backward of fused_ln_mlp: x, dout, dx (B, H, W, C); g, be (C);
// w1 (C, hidden), b1 (hidden) and the transposes w1t (hidden, C), w2t
// (C, hidden); s (B). Writes y, dm (T, C), hg, dh (T, hidden), dx and
// ln_part (ceil(T / 64), 2C).
int trr_ln_mlp_bwd_tokens(const float* x, const float* dout, const float* g, const float* be,
                          const float* w1, const float* b1, const float* w1t, const float* w2t,
                          const float* s, float* y, float* hg, float* dm, float* dh, float* dx,
                          float* ln_part, int B, int H, int W, int C, int hidden, float eps,
                          cudaStream_t stream) {
  const int floats = trr::bwd_tokens_smem_floats(C, hidden);
  const cudaError_t err = trr::set_smem(trr::ln_mlp_bwd_tokens_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTile - 1) / trr::kTile);
  trr::ln_mlp_bwd_tokens_kernel<<<blocks, trr::kThreads, floats * sizeof(float), stream>>>(
      x, dout, g, be, w1, b1, w1t, w2t, s, y, hg, dm, dh, dx, ln_part, tokens, (long long)H * W,
      C, hidden, eps);
  return (int)cudaGetLastError();
}

int trr_block_bwd_attn(const float* y, const float* wq, const float* bq, const float* P,
                       const float* datt, float* dqkv, float* dS, int B, int H, int W, int C,
                       int nh, int shift, float scale, cudaStream_t stream) {
  const int floats = trr::bwd_attn_smem_floats(C, nh);
  const cudaError_t err = trr::set_smem(trr::block_bwd_attn_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / 8) * (W / 8), B);
  trr::block_bwd_attn_kernel<<<grid, trr::kThreads, floats * sizeof(float), stream>>>(
      y, wq, bq, P, datt, dqkv, dS, H, W, C, nh, shift, scale);
  return (int)cudaGetLastError();
}

int trr_block_bwd_ln1(const float* dqkv, const float* wqt, const float* x, const float* stats1,
                      const float* g1, const float* dz, float* dx, float* ln1_part, int B, int H,
                      int W, int C, cudaStream_t stream) {
  const int floats = trr::bwd_ln1_smem_floats(C);
  const cudaError_t err = trr::set_smem(trr::block_bwd_ln1_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTile - 1) / trr::kTile);
  trr::block_bwd_ln1_kernel<<<blocks, trr::kThreads, floats * sizeof(float), stream>>>(
      dqkv, wqt, x, stats1, g1, dz, dx, ln1_part, tokens, C);
  return (int)cudaGetLastError();
}

// part: ceil(T / chunk) rows of M*N + N floats (see weight_grad_kernel).
int trr_weight_grad(const float* A, const float* B, int T, int M, int N, int chunk, float* part,
                    cudaStream_t stream) {
  const dim3 grid((M + trr::kAtbTile - 1) / trr::kAtbTile, (N + trr::kAtbTile - 1) / trr::kAtbTile,
                  (T + chunk - 1) / chunk);
  trr::weight_grad_kernel<<<grid, trr::kThreads, 0, stream>>>(A, B, T, M, N, chunk, part);
  return (int)cudaGetLastError();
}

int trr_sum_rows(const float* part, int S, int L, float* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((L + trr::kThreads - 1) / trr::kThreads);
  trr::sum_rows_kernel<<<blocks, trr::kThreads, 0, stream>>>(part, S, L, out);
  return (int)cudaGetLastError();
}

int trr_dbias(const float* dS, int B, int nwh, int nww, int nh, int kinds, float* dbias,
              cudaStream_t stream) {
  return (int)trr::launch_dbias(dS, B, nwh, nww, nh, kinds, trr::kTile * trr::kTile, dbias,
                                stream);
}

}  // extern "C"
