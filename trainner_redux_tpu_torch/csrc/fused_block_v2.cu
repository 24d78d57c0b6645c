// The fused post-norm SwinV2 block halves of Swin2SR, forward and backward,
// fp32, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels in
// trainner_redux_tpu/ops/pallas/fused_block_v2.py:
//   fused_cos_attn_block (_cos_attn_fwd_kernel, pallas_call at :338):
//       z = x + s[b] * LN1(proj(cosMHSA(qkv(x))))
//       q and k L2-normalised per row, S = (q^ k^T) scale[h] + bias[kind, h];
//   its backward (_cos_attn_bwd_kernel, pallas_call at :373): dx and the
//       gradients of wq, bq, scale, wp, bp, g, be and the bias-kind table,
//       recomputing the forward from x;
//   fused_postnorm_mlp (_pn_mlp_fwd_kernel, pallas_call at :529):
//       out = x + s[b] * LN2(fc2(gelu_erf(fc1 x)));
//   its backward (_pn_mlp_bwd_kernel, pallas_call at :556): dx and the
//       gradients of w1, b1, w2, b2, g, be, recomputing fc1 and fc2 from x.
//
// What bounds them on the card: fp32 arithmetic. At the Swin2SR-M training
// block (B 8, 48x48, C 180, 6 heads of 30, hidden 360: 18,432 tokens) the
// attention half does 5.6 GFLOP forward and 17 backward, the MLP half 4.8
// and 14, against some 13 MB for each activation: far above the card's fp32
// ridge point. The forward kernels are the pre-norm ones of block_fwd.cuh
// with the LayerNorm moved after the last product: one thread block per 8x8
// window (attention half) or per 64 tokens (MLP half), every intermediate in
// shared memory as transposed (C, 64) tiles, weights streamed from L2
// through gemm_weights' double-buffered stage. The post-norm needs all C
// channels of a token, which the block holds: the last product writes its
// rows to a (64, C + 1) row-major tile and one warp a row takes the
// LayerNorm, adds the residual and stores.
//
// The backward of the attention half runs in stages whose working sets fit
// one thread block (a TPU core instead keeps a strip of windows in VMEM):
//   1. cos_attn_fwd_kernel again, told to save qkv, the attention output and
//      the pre-LN proj rows (the recompute);
//   2. postnorm_ln_bwd_kernel, per 64 tokens: dy = s do, the LN backward ->
//      dproj, the dg / dbe partial sums, datt = dproj wp^T;
//   3. cos_attn_bwd_kernel, per 8x8 window and head: q^, k^, P from the
//      saved qkv, then dv, dP, dS, the dscale partial sum of dS cos, dq^ and
//      dk^ and the normalisation's backward -> dq, dk;
//   4. qkv_dx_kernel, per 64 tokens: dx = do + dqkv wq^T;
// then the split-K weight gradients and fixed-order sums of
// fused_block_train.cu (dwq = x^T dqkv, dwp = att^T dproj, the biases, dg,
// dbe, dscale) and dbias_kernel for the per-window dS. The MLP half's
// backward is one per-token kernel (pn_mlp_bwd_kernel) and the same weight
// gradients. No atomics: two runs give the same gradients bit for bit.
// Every product runs on the fp32 FMA units; the tensor cores are later work.
#include "common.cuh"

namespace trr {

// Shared memory, in floats, of each kernel.
// cos_attn_fwd: x tile (C, 64) (later the proj rows, (64, C + 1)), the
// attention tile (C, 64), one head's q^ and k^ (hd, 64) and v (64, 32), the
// score tile, the weight stage, the rows' inverse norms.
__host__ __device__ inline int cos_attn_fwd_smem_floats(int C, int nh) {
  const int hd = C / nh;
  return 2 * C * kTLd + 2 * hd * kTLd + kTile * kVLd + kTile * kTLd + kStageFloats + 2 * kTile;
}
// pn_mlp_fwd: x tile (C, 64) (later the fc2 rows), hidden tile (hidden, 64), stage.
__host__ __device__ inline int pn_mlp_fwd_smem_floats(int C, int hidden) {
  return C * kTLd + hidden * kTLd + kStageFloats;
}
// postnorm_ln_bwd: the proj rows (64, C + 1), dproj (C, 64), stage, row stats.
__host__ __device__ inline int postnorm_ln_bwd_smem_floats(int C) {
  return kTile * (C + 1) + C * kTLd + kStageFloats + 3 * kTile;
}
// cos_attn_bwd: q^, k^, v, datt (64, 32) rows; q^, k^, v, datt (hd, 64)
// transposed; cos, P, dS (64, 64); inverse norms; warp partial sums.
__host__ __device__ inline int cos_attn_bwd_smem_floats(int hd) {
  return 4 * kTile * kVLd + 4 * hd * kTLd + 3 * kTile * kTLd + 2 * kTile + kWarps;
}
// qkv_dx: dqkv (3C, 64) transposed, stage.
__host__ __device__ inline int qkv_dx_smem_floats(int C) { return 3 * C * kTLd + kStageFloats; }
// pn_mlp_bwd: x then dm (C, 64), gelu(h) then dh (hidden, 64), the fc2 rows
// then xn (64, C + 1) in a (C, 64) tile's room, stage, row stats.
__host__ __device__ inline int pn_mlp_bwd_smem_floats(int C, int hidden) {
  return 2 * C * kTLd + hidden * kTLd + kStageFloats + 3 * kTile;
}

// out[tok(r)] = x[tok(r)] + sc(r) * LN(rows[r]) for the M <= 64 rows r of
// `rows` (row-major in shared memory, stride ld, C values each), one warp a
// row; two-pass mean and variance, as the JAX package's _ln_f32. When `keep`
// is not null the pre-LN rows go there too; when `out` is null only `keep`
// is written.
template <class Tok, class Scale>
__device__ __forceinline__ void postnorm_residual(const float* rows, int ld, int M, int C,
                                                  const float* __restrict__ g,
                                                  const float* __restrict__ be, float eps, Tok tok,
                                                  Scale sc, const float* __restrict__ x,
                                                  float* __restrict__ out,
                                                  float* __restrict__ keep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < M; r += kWarps) {
    const float* p = rows + r * ld;
    const long long t = tok(r);
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += p[c];
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = p[c] - mean;
      sq += d * d;
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / C + eps);
    const float sb = out != nullptr ? sc(r) : 0.f;
    for (int c = lane; c < C; c += 32) {
      const long long idx = t * C + c;
      if (keep != nullptr) keep[idx] = p[c];
      if (out != nullptr)
        out[idx] = __ldg(x + idx) + sb * ((p[c] - mean) * inv * __ldg(g + c) + __ldg(be + c));
    }
  }
}

// The LayerNorm backward of a post-norm residual out = x + s * LN(m) on the
// M <= 64 rows of a tile of consecutive tokens t0..: R (64, ld) row-major
// holds m on entry and xn = (m - mean) / std on exit; dT (C, 64) transposed
// receives dm = LN'(s do) (rows M..63 zero), also written to dm_out. The
// block's partial sums of dg (first C) and dbe (next C) go to
// ln_part[blockIdx.x]. st: 3 * 64 floats.
__device__ __forceinline__ void postnorm_ln_bwd_tile(
    float* R, int ld, float* dT, const float* __restrict__ dout, const float* __restrict__ g,
    const float* __restrict__ s, long long t0, int M, long long hw, int C, float eps,
    float* __restrict__ dm_out, float* __restrict__ ln_part, float* st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // R written
  for (int r = warp; r < M; r += kWarps) {
    float* p = R + r * ld;
    const long long t = t0 + r;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += p[c];
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = p[c] - mean;
      sq += d * d;
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / C + eps);
    const float sb = __ldg(s + t / hw);
    float a = 0.f, bsum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xn = (p[c] - mean) * inv;
      const float dy = sb * __ldg(dout + t * C + c);
      p[c] = xn;
      dT[c * kTLd + r] = dy;
      const float dxh = dy * __ldg(g + c);
      a += dxh;
      bsum += dxh * xn;
    }
    a = warp_sum(a) / C;
    bsum = warp_sum(bsum) / C;
    if (lane == 0) {
      st[r] = inv;
      st[kTile + r] = a;
      st[2 * kTile + r] = bsum;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < M; ++r) {
      const float dy = dT[c * kTLd + r];
      dg = fmaf(dy, R[r * ld + c], dg);
      db += dy;
    }
    ln_part[(size_t)blockIdx.x * 2 * C + c] = dg;
    ln_part[(size_t)blockIdx.x * 2 * C + C + c] = db;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    float dm = 0.f;
    if (r < M) {
      const float dxh = dT[c * kTLd + r] * __ldg(g + c);
      dm = st[r] * (dxh - st[kTile + r] - R[r * ld + c] * st[2 * kTile + r]);
      dm_out[(t0 + r) * C + c] = dm;
    }
    dT[c * kTLd + r] = dm;
  }
}

// Rows 0..63 of the transposed (hd, 64) tiles qT and kT divided by their L2
// norm over hd, clamped below at 1e-12 (the JAX package's _norm_rows, torch's
// F.normalize); inv[0..63] and inv[64..127] get the inverse norms.
__device__ __forceinline__ void normalize_rows(float* qT, float* kT, int hd, float* inv) {
  if (threadIdx.x < 2 * kTile) {
    float* T = threadIdx.x < kTile ? qT : kT;
    const int r = threadIdx.x % kTile;
    float sq = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float v = T[d * kTLd + r];
      sq = fmaf(v, v, sq);
    }
    const float iv = 1.f / fmaxf(sqrtf(sq), 1e-12f);
    for (int d = 0; d < hd; ++d) T[d * kTLd + r] *= iv;
    inv[threadIdx.x] = iv;
  }
}

// ---------------------------------------------------------------------------
// #11: the cosine-attention half, forward. One block per 8x8 window of x
// rolled by (-shift, -shift); z comes back in x's frame. The backward's
// recompute also asks for qkv (T, 3C, pre-normalisation), att (T, C) and the
// pre-LN proj rows (T, C), all in x's frame, and passes z = nullptr.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    cos_attn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                        const float* __restrict__ bq, const float* __restrict__ scale,
                        const float* __restrict__ wp, const float* __restrict__ bp,
                        const float* __restrict__ g, const float* __restrict__ be,
                        const float* __restrict__ bias, const float* __restrict__ s,
                        float* __restrict__ z, float* __restrict__ qkv_out,
                        float* __restrict__ att_out, float* __restrict__ proj_out, int H, int W,
                        int C, int nh, int kinds, int shift, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / 8, nwh = H / 8;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y;
  float* xT = smem;                 // (C, 64) the window's x; then the proj rows
  float* attT = xT + C * kTLd;      // (C, 64) attention output
  float* qT = attT + C * kTLd;      // (hd, 64) q, then q^
  float* kT = qT + hd * kTLd;       // (hd, 64) k, then k^
  float* v = kT + hd * kTLd;        // (64, 32)
  float* S = v + kTile * kVLd;      // (64, 64) scores, then probabilities
  float* Bs = S + kTile * kTLd;     // weight stage
  float* inv = Bs + kStageFloats;   // (2, 64) inverse norms

  auto token = [&](int r) { return window_token(b, wi, wj, r, H, W, shift); };
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    xT[c * kTLd + r] = __ldg(x + token(r) * C + c);
  }
  const int kind = window_kind(kinds, wi, wj, nwh, nww);
  for (int h = 0; h < nh; ++h) {
    // this head's columns of qkv: [q_h | k_h | v_h], 3 * hd of the 3C
    gemm_weights(
        xT, C, wq, C3, 3 * hd, [&](int c) { return (c / hd) * C + h * hd + c % hd; }, Bs,
        [&](int r0, int c, const float* o) {
          const int part = c / hd, d = c % hd, col = part * C + h * hd + d;
          const float bb = __ldg(bq + col);
          const float val[4] = {o[0] + bb, o[1] + bb, o[2] + bb, o[3] + bb};
          if (qkv_out != nullptr) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qkv_out[token(r0 + i) * C3 + col] = val[i];
          }
          if (part == 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[(r0 + i) * kVLd + d] = val[i];
          } else {
            *reinterpret_cast<float4*>((part == 0 ? qT : kT) + d * kTLd + r0) =
                make_float4(val[0], val[1], val[2], val[3]);
          }
        });
    __syncthreads();
    normalize_rows(qT, kT, hd, inv);
    __syncthreads();
    attention_head(qT, kT, v, hd, __ldg(scale + h),
                   bias + ((size_t)kind * nh + h) * kTile * kTile, S, nullptr,
                   [&](int r0, int d, const float* o) {
                     *reinterpret_cast<float4*>(attT + (h * hd + d) * kTLd + r0) =
                         make_float4(o[0], o[1], o[2], o[3]);
                     if (att_out != nullptr) {
#pragma unroll
                       for (int i = 0; i < 4; ++i) att_out[token(r0 + i) * C + h * hd + d] = o[i];
                     }
                   });
  }

  // proj rows into the x tile's room, then LN1 and the residual
  const int ld = C + 1;
  gemm_weights(attT, C, wp, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(bp + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) xT[(r0 + i) * ld + c] = o[i] + bb;
               });
  __syncthreads();
  const float sb = __ldg(s + b);
  postnorm_residual(xT, ld, kTile, C, g, be, eps, token, [&](int) { return sb; }, x, z, proj_out);
}

// ---------------------------------------------------------------------------
// #12, stage 2: per 64 consecutive tokens, the LN1 backward and datt.
// proj (T, C) are the saved pre-LN rows; wpt (C, C) is wp's transpose.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    postnorm_ln_bwd_kernel(const float* __restrict__ proj, const float* __restrict__ dout,
                           const float* __restrict__ g, const float* __restrict__ s,
                           const float* __restrict__ wpt, float* __restrict__ dproj,
                           float* __restrict__ datt, float* __restrict__ ln_part,
                           long long tokens, long long hw, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  const int ld = C + 1;
  float* R = smem;                   // (64, C + 1) proj rows, then xn
  float* dT = R + kTile * ld;        // (C, 64) dy, then dproj
  float* Bs = dT + C * kTLd;         // weight stage
  float* st = Bs + kStageFloats;     // 1/std, mean(dy g), mean(dy g xn) of each row
  for (int e = threadIdx.x; e < M * C; e += kThreads) {
    const int r = e / C, c = e % C;
    R[r * ld + c] = __ldg(proj + (t0 + r) * C + c);
  }
  postnorm_ln_bwd_tile(R, ld, dT, dout, g, s, t0, M, hw, C, eps, dproj, ln_part, st);
  gemm_weights(dT, C, wpt, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
#pragma unroll
                 for (int i = 0; i < 4; ++i)
                   if (r0 + i < M) datt[(t0 + r0 + i) * C + c] = o[i];
               });
}

// ---------------------------------------------------------------------------
// #12, stage 3: one block per 8x8 window of the rolled map, the heads one
// after another. qkv (T, 3C) is the saved pre-normalisation qkv and datt
// (T, C) the gradient of the attention output, both in x's frame. Writes
// dq | dk | dv into dqkv (T, 3C), dS (B, H/8, W/8, nh, 64, 64) for the
// bias-kind sums, and per window and head the partial sum of dS * cos to
// dscale_part (B * H/8 * W/8, nh).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    cos_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ datt,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        float* __restrict__ dqkv, float* __restrict__ dS,
                        float* __restrict__ dscale_part, int H, int W, int C, int nh, int kinds,
                        int shift) {
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / 8, nwh = H / 8;
  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww, b = blockIdx.y;
  const int rg = threadIdx.x / kLanes, cl = threadIdx.x % kLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = smem;                   // (64, 32) rows: q, then q^
  float* k = q + kTile * kVLd;       // (64, 32) k, then k^
  float* v = k + kTile * kVLd;       // (64, 32)
  float* dA = v + kTile * kVLd;      // (64, 32) this head's columns of datt
  float* qT = dA + kTile * kVLd;     // (hd, 64) q, then q^
  float* kT = qT + hd * kTLd;        // (hd, 64) k, then k^
  float* vT = kT + hd * kTLd;        // (hd, 64)
  float* dAT = vT + hd * kTLd;       // (hd, 64)
  float* Cs = dAT + hd * kTLd;       // (64, 64) cos = q^ k^T
  float* Ps = Cs + kTile * kTLd;     // (64, 64) scores, then P
  float* G = Ps + kTile * kTLd;      // (64, 64) dP, then dS
  float* inv = G + kTile * kTLd;     // (2, 64) inverse norms of q and k rows
  float* red = inv + 2 * kTile;      // (8) warp partial sums

  auto token = [&](int r) { return window_token(b, wi, wj, r, H, W, shift); };
  const int kind = window_kind(kinds, wi, wj, nwh, nww);
  const size_t window = (size_t)b * nwh * nww + blockIdx.x;
  for (int h = 0; h < nh; ++h) {
    const size_t head = (window * nh + h) * kTile * kTile;
    const float sc = __ldg(scale + h);
    const float* bias_h = bias + ((size_t)kind * nh + h) * kTile * kTile;
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const long long t = token(r);
      const float* row = qkv + t * C3 + h * hd + d;
      const float qv = __ldg(row), kv = __ldg(row + C), vv = __ldg(row + 2 * C);
      const float av = __ldg(datt + t * C + h * hd + d);
      q[r * kVLd + d] = qv;
      k[r * kVLd + d] = kv;
      v[r * kVLd + d] = vv;
      dA[r * kVLd + d] = av;
      qT[d * kTLd + r] = qv;
      kT[d * kTLd + r] = kv;
      vT[d * kTLd + r] = vv;
      dAT[d * kTLd + r] = av;
    }
    __syncthreads();
    normalize_rows(qT, kT, hd, inv);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      q[r * kVLd + d] *= inv[r];
      k[r * kVLd + d] *= inv[kTile + r];
    }
    {  // cos[r][j] = q^_r . k^_j; scores cos * scale + bias
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float4 a = ld4(qT + d * kTLd + rg * 4);
        const float4 bv = ld4(kT + d * kTLd + cl * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const float4 bb = __ldg(reinterpret_cast<const float4*>(bias_h + r * kTile + cl * 4));
        *reinterpret_cast<float4*>(Cs + r * kTLd + cl * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(Ps + r * kTLd + cl * 4) =
            make_float4(acc[i][0] * sc + bb.x, acc[i][1] * sc + bb.y, acc[i][2] * sc + bb.z,
                        acc[i][3] * sc + bb.w);
      }
    }
    __syncthreads();
    for (int r = warp; r < kTile; r += kWarps) {  // row softmax, the row max subtracted
      float* p = Ps + r * kTLd;
      const float s0 = p[lane], s1 = p[lane + 32];
      const float m = warp_max(fmaxf(s0, s1));
      const float p0 = expf(s0 - m), p1 = expf(s1 - m);
      const float iv = 1.f / warp_sum(p0 + p1);
      p[lane] = p0 * iv;
      p[lane + 32] = p1 * iv;
    }
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
    {  // dS = P (dP - rowsum(P dP)), one warp per row; the sum of dS * cos
      float part = 0.f;
      for (int r = warp; r < kTile; r += kWarps) {
        const float p0 = Ps[r * kTLd + lane], p1 = Ps[r * kTLd + lane + 32];
        const float d0 = G[r * kTLd + lane], d1 = G[r * kTLd + lane + 32];
        const float delta = warp_sum(p0 * d0 + p1 * d1);
        const float s0 = p0 * (d0 - delta), s1 = p1 * (d1 - delta);
        G[r * kTLd + lane] = s0;
        G[r * kTLd + lane + 32] = s1;
        dS[head + r * kTile + lane] = s0;
        dS[head + r * kTile + lane + 32] = s1;
        part = fmaf(s0, Cs[r * kTLd + lane], part);
        part = fmaf(s1, Cs[r * kTLd + lane + 32], part);
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += red[w];
      dscale_part[window * nh + h] = acc;
    }
    // dq^ = scale dS k^, dk^ = scale dS^T q^; then the normalisation's
    // backward dq = (dq^ - q^ <q^, dq^>) / max(|q|, 1e-12), dk likewise. A
    // row's hd columns lie in the 16 lanes of its row group: the dot product
    // is a shuffle sum over them.
    for (int side = 0; side < 2; ++side) {
      const float* other = side == 0 ? k : q;   // the rows the product runs over
      const float* self = side == 0 ? q : k;    // the normalised rows differentiated
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      if (side == 0) {
        const float* gr = G + rg * 4 * kTLd;
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(other + j * kVLd + cl * 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = gr[i * kTLd + j];
            acc[i][0] = fmaf(a, kv.x, acc[i][0]);
            acc[i][1] = fmaf(a, kv.y, acc[i][1]);
          }
        }
      } else {
#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
          const float4 sv = ld4(G + r * kTLd + rg * 4);
          const float2 qv = *reinterpret_cast<const float2*>(other + r * kVLd + cl * 2);
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(s4[i], qv.x, acc[i][0]);
            acc[i][1] = fmaf(s4[i], qv.y, acc[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        float dot = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int d = cl * 2 + jj;
          acc[i][jj] *= sc;
          if (d < hd) dot = fmaf(self[r * kVLd + d], acc[i][jj], dot);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float iv = inv[side * kTile + r];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int d = cl * 2 + jj;
          if (d < hd)
            dqkv[token(r) * C3 + side * C + h * hd + d] = (acc[i][jj] - self[r * kVLd + d] * dot) * iv;
        }
      }
    }
    __syncthreads();  // this head's tiles are free for the next
  }
}

// ---------------------------------------------------------------------------
// #12, stage 4: per 64 consecutive tokens, dx = dout + dqkv wq^T (wqt is
// wq's transpose, (3C, C)).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    qkv_dx_kernel(const float* __restrict__ dqkv, const float* __restrict__ wqt,
                  const float* __restrict__ dout, float* __restrict__ dx, long long tokens,
                  int C) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  const int C3 = 3 * C;
  float* DQ = smem;                  // (3C, 64) dqkv
  float* Bs = DQ + C3 * kTLd;        // weight stage
  for (int e = threadIdx.x; e < kTile * C3; e += kThreads) {
    const int r = e / C3, c = e % C3;
    DQ[c * kTLd + r] = r < M ? __ldg(dqkv + (t0 + r) * C3 + c) : 0.f;
  }
  gemm_weights(DQ, C3, wqt, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   if (r0 + i >= M) break;
                   const long long idx = (t0 + r0 + i) * C + c;
                   dx[idx] = __ldg(dout + idx) + o[i];
                 }
               });
}

// ---------------------------------------------------------------------------
// #13: the post-norm MLP half, forward, one block per 64 consecutive tokens.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    pn_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ g,
                      const float* __restrict__ be, const float* __restrict__ s,
                      float* __restrict__ out, long long tokens, long long hw, int C, int hidden,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  const int ld = C + 1;
  float* xT = smem;                  // (C, 64) x; then the fc2 rows (64, C + 1)
  float* hT = xT + C * kTLd;         // (hidden, 64) gelu(fc1)
  float* Bs = hT + hidden * kTLd;    // weight stage
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    xT[c * kTLd + r] = r < M ? __ldg(x + (t0 + r) * C + c) : 0.f;
  }
  gemm_weights(xT, C, w1, hidden, hidden, [](int c) { return c; }, Bs,
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
                 for (int i = 0; i < 4; ++i) xT[(r0 + i) * ld + c] = o[i] + bb;
               });
  __syncthreads();
  postnorm_residual(xT, ld, M, C, g, be, eps, [&](int r) { return t0 + r; },
                    [&](int r) { return __ldg(s + (t0 + r) / hw); }, x, out, nullptr);
}

// ---------------------------------------------------------------------------
// #14: the post-norm MLP half's backward, one block per 64 consecutive
// tokens: recompute h = x w1 + b1 and m = gelu(h) w2 + b2, then dm =
// LN2'(s dout), dh = (dm w2^T) gelu'(h), dx = dout + dh w1^T. w1t (hidden,
// C) and w2t (C, hidden) are the transposes of w1 and w2. Writes hg =
// gelu(h), dm and dh per token for the weight gradients (dh holds h until
// the block overwrites it), dx, and the dg / dbe partial sums per block.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    pn_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ w1t, const float* __restrict__ w2t,
                      const float* __restrict__ g, const float* __restrict__ s,
                      float* __restrict__ hg, float* __restrict__ dm, float* dh,
                      float* __restrict__ dx, float* __restrict__ ln_part, long long tokens,
                      long long hw, int C, int hidden, float eps) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int M = (int)min((long long)kTile, tokens - t0);
  const int ld = C + 1;
  float* T1 = smem;                  // (C, 64): x, then dy, then dm
  float* T2 = T1 + C * kTLd;         // (hidden, 64): gelu(h), then dh
  float* R = T2 + hidden * kTLd;     // (64, C + 1) in a (C, 64) room: m, then xn
  float* Bs = R + C * kTLd;          // weight stage
  float* st = Bs + kStageFloats;     // LN row stats
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e % C;
    T1[c * kTLd + r] = r < M ? __ldg(x + (t0 + r) * C + c) : 0.f;
  }
  // h = x w1 + b1: gelu(h) to T2 and hg, h itself to dh
  gemm_weights(T1, C, w1, hidden, hidden, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(b1 + c);
                 float gv[4];
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   const float h = o[i] + bb;
                   gv[i] = gelu_erf(h);
                   if (r0 + i < M) {
                     const long long idx = (t0 + r0 + i) * hidden + c;
                     hg[idx] = gv[i];
                     dh[idx] = h;
                   }
                 }
                 *reinterpret_cast<float4*>(T2 + c * kTLd + r0) =
                     make_float4(gv[0], gv[1], gv[2], gv[3]);
               });
  // m = gelu(h) w2 + b2, as rows
  gemm_weights(T2, hidden, w2, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 const float bb = __ldg(b2 + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) R[(r0 + i) * ld + c] = o[i] + bb;
               });
  postnorm_ln_bwd_tile(R, ld, T1, dout, g, s, t0, M, hw, C, eps, dm, ln_part, st);
  // dh = (dm w2^T) gelu'(h), h read back from dh (written by this block)
  gemm_weights(T1, C, w2t, hidden, hidden, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
                 float d[4];
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   d[i] = 0.f;
                   if (r0 + i < M) {
                     const long long idx = (t0 + r0 + i) * hidden + c;
                     d[i] = o[i] * gelu_erf_grad(dh[idx]);
                     dh[idx] = d[i];
                   }
                 }
                 *reinterpret_cast<float4*>(T2 + c * kTLd + r0) = make_float4(d[0], d[1], d[2], d[3]);
               });
  // dx = dout + dh w1^T
  gemm_weights(T2, hidden, w1t, C, C, [](int c) { return c; }, Bs,
               [&](int r0, int c, const float* o) {
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   if (r0 + i >= M) break;
                   const long long idx = (t0 + r0 + i) * C + c;
                   dx[idx] = __ldg(dout + idx) + o[i];
                 }
               });
}

inline unsigned token_blocks(long long tokens) {
  return (unsigned)((tokens + kTile - 1) / kTile);
}

}  // namespace trr

extern "C" {

size_t trr_cos_attn_fwd_smem_bytes(int C, int nh) {
  return (size_t)trr::cos_attn_fwd_smem_floats(C, nh) * sizeof(float);
}
size_t trr_pn_mlp_fwd_smem_bytes(int C, int hidden) {
  return (size_t)trr::pn_mlp_fwd_smem_floats(C, hidden) * sizeof(float);
}
size_t trr_postnorm_ln_bwd_smem_bytes(int C) {
  return (size_t)trr::postnorm_ln_bwd_smem_floats(C) * sizeof(float);
}
size_t trr_cos_attn_bwd_smem_bytes(int hd) {
  return (size_t)trr::cos_attn_bwd_smem_floats(hd) * sizeof(float);
}
size_t trr_qkv_dx_smem_bytes(int C) { return (size_t)trr::qkv_dx_smem_floats(C) * sizeof(float); }
size_t trr_pn_mlp_bwd_smem_bytes(int C, int hidden) {
  return (size_t)trr::pn_mlp_bwd_smem_floats(C, hidden) * sizeof(float);
}

// x (B, H, W, C); wq (C, 3C), bq (3C), scale (nh) already exponentiated, wp
// (C, C), bp, g, be (C), bias (kinds, nh, 64, 64), s (B). Windows are 8x8 of
// x rolled by (-shift, -shift); z and the saved tensors are in x's frame.
// Any of z, qkv_out, att_out, proj_out may be null.
int trr_cos_attn_fwd(const float* x, const float* wq, const float* bq, const float* scale,
                     const float* wp, const float* bp, const float* g, const float* be,
                     const float* bias, const float* s, float* z, float* qkv_out, float* att_out,
                     float* proj_out, int B, int H, int W, int C, int nh, int kinds, int shift,
                     float eps, cudaStream_t stream) {
  const int floats = trr::cos_attn_fwd_smem_floats(C, nh);
  const cudaError_t err = trr::set_smem(trr::cos_attn_fwd_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / 8) * (W / 8), B);
  trr::cos_attn_fwd_kernel<<<grid, trr::kThreads, floats * sizeof(float), stream>>>(
      x, wq, bq, scale, wp, bp, g, be, bias, s, z, qkv_out, att_out, proj_out, H, W, C, nh, kinds,
      shift, eps);
  return (int)cudaGetLastError();
}

// The attention half's backward after the recompute: proj, dout (T, C) ->
// dproj, datt (T, C), ln_part (ceil(T / 64), 2C); then the per-window
// attention backward -> dqkv (T, 3C), dS (B, H/8, W/8, nh, 64, 64),
// dscale_part (B * H/8 * W/8, nh); then dx (T, C). wpt (C, C) and wqt
// (3C, C) are the transposes of wp and wq.
int trr_cos_attn_bwd(const float* proj, const float* dout, const float* g, const float* s,
                     const float* wpt, const float* qkv, const float* scale, const float* bias,
                     const float* wqt, float* dproj, float* datt, float* ln_part, float* dqkv,
                     float* dS, float* dscale_part, float* dx, int B, int H, int W, int C, int nh,
                     int kinds, int shift, float eps, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W;
  const unsigned blocks = trr::token_blocks(tokens);
  int floats = trr::postnorm_ln_bwd_smem_floats(C);
  cudaError_t err = trr::set_smem(trr::postnorm_ln_bwd_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  trr::postnorm_ln_bwd_kernel<<<blocks, trr::kThreads, floats * sizeof(float), stream>>>(
      proj, dout, g, s, wpt, dproj, datt, ln_part, tokens, (long long)H * W, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  floats = trr::cos_attn_bwd_smem_floats(C / nh);
  if ((err = trr::set_smem(trr::cos_attn_bwd_kernel, floats)) != cudaSuccess) return (int)err;
  const dim3 grid((H / 8) * (W / 8), B);
  trr::cos_attn_bwd_kernel<<<grid, trr::kThreads, floats * sizeof(float), stream>>>(
      qkv, datt, scale, bias, dqkv, dS, dscale_part, H, W, C, nh, kinds, shift);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  floats = trr::qkv_dx_smem_floats(C);
  if ((err = trr::set_smem(trr::qkv_dx_kernel, floats)) != cudaSuccess) return (int)err;
  trr::qkv_dx_kernel<<<blocks, trr::kThreads, floats * sizeof(float), stream>>>(
      dqkv, wqt, dout, dx, tokens, C);
  return (int)cudaGetLastError();
}

// x, out: (B, H, W, C) seen as B*H*W tokens; w1 (C, hidden), b1 (hidden),
// w2 (hidden, C), b2, g, be (C), s (B).
int trr_pn_mlp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* g, const float* be, const float* s, float* out,
                   int B, int H, int W, int C, int hidden, float eps, cudaStream_t stream) {
  const int floats = trr::pn_mlp_fwd_smem_floats(C, hidden);
  const cudaError_t err = trr::set_smem(trr::pn_mlp_fwd_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  trr::pn_mlp_fwd_kernel<<<trr::token_blocks(tokens), trr::kThreads, floats * sizeof(float),
                           stream>>>(x, w1, b1, w2, b2, g, be, s, out, tokens, (long long)H * W,
                                     C, hidden, eps);
  return (int)cudaGetLastError();
}

// The MLP half's backward, per token: hg, dh (T, hidden), dm, dx (T, C),
// ln_part (ceil(T / 64), 2C).
int trr_pn_mlp_bwd(const float* x, const float* dout, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* w1t, const float* w2t,
                   const float* g, const float* s, float* hg, float* dm, float* dh, float* dx,
                   float* ln_part, int B, int H, int W, int C, int hidden, float eps,
                   cudaStream_t stream) {
  const int floats = trr::pn_mlp_bwd_smem_floats(C, hidden);
  const cudaError_t err = trr::set_smem(trr::pn_mlp_bwd_kernel, floats);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  trr::pn_mlp_bwd_kernel<<<trr::token_blocks(tokens), trr::kThreads, floats * sizeof(float),
                           stream>>>(x, dout, w1, b1, w2, b2, w1t, w2t, g, s, hg, dm, dh, dx,
                                     ln_part, tokens, (long long)H * W, C, hidden, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
