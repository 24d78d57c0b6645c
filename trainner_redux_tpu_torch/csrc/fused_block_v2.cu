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
// What bounds them on the card: their products. At the Swin2SR-M training
// block (B 8, 48x48, C 180, 6 heads of 30, hidden 360: 18,432 tokens) the
// attention half does 5.6 GFLOP forward and 17 backward, the MLP half 4.8
// and 14, against some 13 MB for each activation. Every half runs in stages
// through device memory, its per-token products on the tensor cores in
// 3xTF32 through the wgmma engine (tc_gemm.cuh, tc_rows.cuh; bound 3 x
// operations / 495 TFLOP/s), 128 tokens a block, each weight read as it
// lies; the window attention on mma.sync in 3xTF32 (tc_attn.cuh), one block
// per (8x8 window of x rolled by (-shift, -shift), head). The post-norm
// needs all C channels of a token: a row pass after the last product, one
// warp a token, takes the LayerNorm and adds the residual. The forwards' products add each
// 32-deep partial sum to an fp32 accumulator (tc_gemm.cuh's promoted
// products, as block_fwd.cuh's pre-LN forwards).
//
// The forward of the attention half (#11), in x's frame but for stage 2:
//   1. linear_kernel: qkv = x wq + bq (the post-norm block's qkv reads x);
//   2. attn_rows_fwd_tc_kernel<64, 64, 2, true>, the cosine form: q^ and k^
//      (rows divided by max(|row|, 1e-12)), S = (q^ k^T) scale[h] + bias,
//      the row softmax and P v -> att (T, C);
//   3. linear_kernel: proj = att wp + bp;
//   4. ln_rows_kernel<VEC, true>, the post-norm row pass: z = x + s[b]
//      LN1(proj).
// The forward of the MLP half (#13):
//   1. linear_kernel with its gelu epilogue: hg = gelu(x w1 + b1);
//   2. linear_kernel: m = hg w2 + b2;
//   3. the post-norm row pass: out = x + s[b] LN2(m).
// Scratch (the wrappers' torch.empty): qkv (T, 3C), att, proj (T, C); hg
// (T, hidden), m (T, C). Rows of any width the gates take: 16-byte copies
// where C (and hidden) are multiples of 4, else a float at a time.
//
// The backward of the attention half (#12), the forward's stages 1-3 again:
//   1. linear_kernel: qkv = x wq + bq;
//   2. attn_rows_fwd_tc_kernel's cosine form -> att (T, C);
//   3. linear_kernel: proj = att wp + bp;
//   4. postnorm_ln_rows_kernel, one warp a token, 16-byte row loads: dproj =
//      LN1'(s dout) from proj's own row stats, the dg / dbe partial sums per
//      128 tokens (bound: bytes);
//   5. rows_kernel<BN, kRowsStore>: datt = dproj wp^T, wp as it lies (K-major);
//   6. cos_attn_bwd_tc_kernel, per (8x8 window, head): q^, k^, P from qkv,
//      then dv, dP, dS, the dscale partial sum of dS cos, dq^ and dk^ and
//      the normalisation's backward -> dq, dk; its six products on
//      mma.sync in 3xTF32;
//   7. rows_kernel<BN, kRowsResidual>: dx = dout + dqkv wq^T;
// then the split-K weight gradients and fixed-order sums of
// fused_block_train.cu (dwq = x^T dqkv, dwp = att^T dproj, the biases, dg,
// dbe, dscale) and dbias_kernel for the per-window dS.
//
// The backward of the MLP half (#14):
//   1. linear_kernel with its gelu epilogue: hg = gelu(x w1 + b1);
//   2. linear_kernel: m = hg w2 + b2;
//   3. postnorm_ln_rows_kernel: dm = LN2'(s dout) from m's own row stats,
//      the dg / dbe partial sums per 128 tokens;
//   4. mlp_hidden_kernel (tc_rows.cuh, #7's): h = x w1 + b1 again in its
//      first product, then dh = (dm w2^T) gelu'(h), gelu'(h) held in shared
//      memory between the two (h never goes to device memory);
//   5. rows_kernel<BN, kRowsResidual>: dx = dout + dh w1^T;
// then the weight gradients dw2 = hg^T dm, dw1 = x^T dh and the sums. The
// backwards take rows of up to 256 channels, multiples of 4 (Swin2SR-L's C
// 240 / hidden 480 too). No atomics: two runs give the same outputs bit for
// bit.
#include <algorithm>

#include "tc_attn.cuh"
#include "tc_rows.cuh"
#include "tc_rows_bf16.cuh"

namespace trr {

// The largest shared memory, in bytes, of the forwards' kernels: the
// per-token products at a 128-column tile (qkv, hg) and at the tile of a
// row of C (proj, m), the cosine window attention (the attention half);
// the row pass takes none.
inline int pn_mlp_fwd_smem_bytes(int C) {
  return std::max(linear_smem_bytes(), linear_smem_bytes(linear_cols(C)));
}
inline int cos_attn_fwd_smem_bytes(int C) {
  return std::max(pn_mlp_fwd_smem_bytes(C),
                  attn_rows_fwd_tc_smem_floats(kTile, kTile, 2) * (int)sizeof(float));
}
// cos_attn_bwd_tc (tc_attn.cuh): q, k, v, datt (64, 36) rows; the P / dS
// tile (64, 68); three (2, 64) exchanges of the row halves' sums; the
// inverse norms of the q and k rows; the warps' sums of dS cos; the
// window's 64 token indices.
__host__ __device__ constexpr int cos_attn_bwd_smem_floats() {
  return 4 * kTile * kHeadLd + kTile * (kTile + 4) + 6 * kTile + 2 * kTile + kWarps + kTile;
}

// The cosine window attention at 8x8 windows (#11's stage 2, #12's): att
// (T, C) from qkv (T, 3C), the heads' temperatures `scale` (nh) and the kind
// table, on attn_rows_fwd_tc_kernel's cosine form.
inline cudaError_t cos_window_attention(const float* qkv, const float* scale, const float* bias,
                                 float* att, int B, int H, int W, int C, int nh, int kinds,
                                 int shift, cudaStream_t stream) {
  return attn_rows_fwd_tc<kTile, true>(qkv, bias, att, nullptr, B, H, W, C, nh, 8, 8, kinds,
                                       shift, 0.f, stream, scale);
}
inline cudaError_t cos_window_attention(const bf16* qkv, const float* scale, const float* bias,
                                        bf16* att, int B, int H, int W, int C, int nh, int kinds,
                                        int shift, cudaStream_t stream) {
  return cos_attn_rows_fwd_bf16<kTile>(qkv, bias, att, B, H, W, C, nh, 8, 8, kinds, shift, scale,
                                       stream);
}

// The bf16 forms' largest shared memory, in bytes, of their kernels in this
// file and the headers (the weight gradients' stage is
// fused_block_train.cu's, wgrad_bf16.cuh): the products at the tiles of rows of 3C, C and
// hidden, rows_bf16_kernel over a row of C, mlp_hidden_bf16_kernel, the
// cosine window attention forward and its backward stage.
inline int cos_attn_bf16_smem_bytes(int C) {
  return std::max({wg_bf16_bytes(linear_cols(3 * C)), wg_bf16_bytes(linear_cols(C)),
                   rows_bf16_smem_bytes(C),
                   attn_rows_fwd_tc_smem_floats(kTile, kTile, 2) * (int)sizeof(float),
                   cos_attn_bwd_smem_floats() * (int)sizeof(float)});
}
inline int pn_mlp_bf16_smem_bytes(int C, int hidden) {
  return std::max({wg_bf16_bytes(linear_cols(hidden)), wg_bf16_bytes(linear_cols(C)),
                   hidden_bf16_smem_bytes(), rows_bf16_smem_bytes(C)});
}

// ---------------------------------------------------------------------------
// #12, stage 4 (and #14, stage 3): per 128 consecutive tokens, one warp a
// token (16 a warp, in order), rows read with 16-byte loads (C <= 256, a
// multiple of 4): the
// LayerNorm backward of z = x + s LN1(proj) -> dproj = inv (dy g - mean(dy
// g) - xn mean(dy g xn)) with dy = s dout and xn from the proj row's own
// mean and 1/std (two-pass, as the forward); the block's partial sums of dg
// = sum dy xn (first C) and dbe = sum dy (next C) to ln_part[blockIdx.x].
// DT: the type of proj, dout and dproj (float, or bf16 in the bf16 forms,
// whose dproj is rounded as the next products' operand and, where dproj32
// is not null, also written in fp32 for the bias gradient's sum).
// ---------------------------------------------------------------------------
template <typename DT>
__global__ void __launch_bounds__(kThreads)
    postnorm_ln_rows_kernel(const DT* __restrict__ proj, const DT* __restrict__ dout,
                            const float* __restrict__ g, const float* __restrict__ s,
                            DT* __restrict__ dproj, float* __restrict__ dproj32,
                            float* __restrict__ ln_part, long long T, long long hw, int C,
                            float eps) {
  __shared__ __align__(16) float colred[kWarps * 2 * 256];  // [warp][dg | dbe][C]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = C / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 gv[2], cg[2] = {zero4, zero4}, cb[2] = {zero4, zero4};
#pragma unroll
  for (int v = 0; v < 2; ++v)
    gv[v] = lane + 32 * v < n4 ? __ldg(reinterpret_cast<const float4*>(g) + lane + 32 * v) : zero4;
  const long long tb = (long long)blockIdx.x * kTcRows + 16 * warp;
  for (int r = 0; r < 16 && tb + r < T; ++r) {
    const long long t = tb + r;
    float4 p[2], d[2];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c4 = lane + 32 * v;
      p[v] = c4 < n4 ? ldg4(proj + t * C + 4 * c4) : zero4;
      d[v] = c4 < n4 ? ldg4(dout + t * C + 4 * c4) : zero4;
      sum += (p[v].x + p[v].y) + (p[v].z + p[v].w);
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (lane + 32 * v < n4) {
        const float a = p[v].x - mean, b = p[v].y - mean, c = p[v].z - mean, e = p[v].w - mean;
        sq += (a * a + b * b) + (c * c + e * e);
      }
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / C + eps);
    const float sc = __ldg(s + t / hw);
    float4 xn[2], dy[2];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      xn[v] = make_float4((p[v].x - mean) * inv, (p[v].y - mean) * inv, (p[v].z - mean) * inv,
                          (p[v].w - mean) * inv);
      dy[v] = make_float4(sc * d[v].x, sc * d[v].y, sc * d[v].z, sc * d[v].w);
      const float4 e = make_float4(dy[v].x * gv[v].x, dy[v].y * gv[v].y, dy[v].z * gv[v].z,
                                   dy[v].w * gv[v].w);
      sa += (e.x + e.y) + (e.z + e.w);
      sb += (e.x * xn[v].x + e.y * xn[v].y) + (e.z * xn[v].z + e.w * xn[v].w);
      cg[v] = make_float4(fmaf(dy[v].x, xn[v].x, cg[v].x), fmaf(dy[v].y, xn[v].y, cg[v].y),
                          fmaf(dy[v].z, xn[v].z, cg[v].z), fmaf(dy[v].w, xn[v].w, cg[v].w));
      cb[v] = make_float4(cb[v].x + dy[v].x, cb[v].y + dy[v].y, cb[v].z + dy[v].z,
                          cb[v].w + dy[v].w);
    }
    const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c4 = lane + 32 * v;
      if (c4 >= n4) continue;
      const float4 o = make_float4(inv * (dy[v].x * gv[v].x - ma - xn[v].x * mb),
                                   inv * (dy[v].y * gv[v].y - ma - xn[v].y * mb),
                                   inv * (dy[v].z * gv[v].z - ma - xn[v].z * mb),
                                   inv * (dy[v].w * gv[v].w - ma - xn[v].w * mb));
      st4(dproj + t * C + 4 * c4, o);
      if (dproj32 != nullptr) st4(dproj32 + t * C + 4 * c4, o);
    }
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int c4 = lane + 32 * v;
    if (c4 < n4) {
      reinterpret_cast<float4*>(colred + 2 * warp * C)[c4] = cg[v];
      reinterpret_cast<float4*>(colred + (2 * warp + 1) * C)[c4] = cb[v];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      dg += colred[2 * w * C + c];
      db += colred[(2 * w + 1) * C + c];
    }
    ln_part[(size_t)blockIdx.x * 2 * C + c] = dg;
    ln_part[(size_t)blockIdx.x * 2 * C + C + c] = db;
  }
}

// ---------------------------------------------------------------------------
// #12, stage 6: one block per (8x8 window of the rolled map, head), its
// products on mma.sync in 3xTF32 as tc_attn.cuh lays them out, one row
// block of 64. From the qkv buffer (pre-normalisation) and datt (T, C), in
// x's frame: q^ and k^ (rows divided by max(|row|, 1e-12)), cos = q^ k^T
// kept in the fragments, S = cos scale[h] + bias, the row softmax, P to the
// shared tile; dV = P^T dA, dP = dA v^T, dS = P (dP - rowsum(P dP)) in place
// of P and to dS (B, H/8, W/8, nh, 64, 64) for the bias-kind sums, the
// block's sum of dS cos to dscale_part (B * H/8 * W/8, nh); dq^ = scale dS
// k^ and dk^ = scale dS^T q^ through shared memory, then the normalisation's
// backward dq = (dq^ - q^ <q^, dq^>) / max(|q|, 1e-12), dk likewise, one warp
// a row; dq | dk | dv to dqkv (T, 3C).
// T, the bf16 form (#12's bf16 stage): qkv, datt and dqkv in bf16, each
// product on mma.sync m16n8k16 with fp32 sums, its operands rounded to bf16
// as their fragments load, as the JAX kernel rounds them: cos = bf16(q^)
// bf16(k^)^T, dV from bf16(P), the tile holding scale dS so that dq^ and dk^
// take dcos = bf16(scale dS); dS, rowsum(P dP), the dscale sums and the
// normalisation's backward (from the fp32 q^ and k^) stay fp32.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(attn_tc_threads(kTile), 2)
    cos_attn_bwd_tc_kernel(const T* __restrict__ qkv, const T* __restrict__ datt,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           T* __restrict__ dqkv, float* __restrict__ dS,
                           float* __restrict__ dscale_part, int H, int W, int C, int nh,
                           int kinds, int shift) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  using AW = AttnWarps<kTile, kTile, 2, BF>;
  constexpr int NTH = AW::NTH, LD = AW::LD, NT = AW::NT;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / 8, nwh = H / 8;
  // heads fastest in the grid, as #6's: a window's heads run together
  const int wi = blockIdx.y / nww, wj = blockIdx.y % nww, h = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const AW aw;
  float* qs = smem;                  // (64, LD) q^
  float* ks = qs + kTile * LD;       // (64, LD) k^
  float* vs = ks + kTile * LD;       // (64, LD) v, then dk^
  float* das = vs + kTile * LD;      // (64, LD) datt, then dq^
  float* pt = das + kTile * LD;      // (64, 68): P, then dS
  float* red = pt + kTile * AW::LP;  // (3, 2, 64) the halves' row max, row sum, rowsum(P dP)
  float* inv = red + 6 * kTile;      // (2, 64) inverse norms of the q and k rows
  float* wsum = inv + 2 * kTile;     // (8) the warps' sums of dS cos
  int* tok = reinterpret_cast<int*>(wsum + kWarps);  // (64) the window's token indices
  for (int r = threadIdx.x; r < kTile; r += NTH)
    tok[r] = (int)window_token(blockIdx.z, wi, wj, r, H, W, shift);
  const size_t window = (size_t)blockIdx.z * nwh * nww + blockIdx.y;
  const size_t head = (window * nh + h) * kTile * kTile;
  const float sc = __ldg(scale + h);
  const float* table =
      bias + ((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * kTile * kTile;
  __syncthreads();
  const T* base = qkv + h * hd;
  // q^ and k^ (rows divided by max(|row|, 1e-12)) and their inverse norms
  stage_head_rows<kTile, NTH, true>(
      qs, hd, [&](int r) { return base + (long long)tok[r] * C3; }, inv);
  stage_head_rows<kTile, NTH, true>(
      ks, hd, [&](int r) { return base + (long long)tok[r] * C3 + C; }, inv + kTile);
  stage_head_rows<kTile, NTH>(vs, hd,
                              [&](int r) { return base + (long long)tok[r] * C3 + 2 * C; });
  stage_head_rows<kTile, NTH>(das, hd,
                              [&](int r) { return datt + (long long)tok[r] * C + h * hd; });
  stage_table_rows<kTile, kTile, NTH>(pt, table);  // the bias rows, for S
  __syncthreads();
  float cs[NT][4];  // cos = q^ k^T, for dscale
  aw.rows_by_channels(qs, ks, cs);
  {  // S = cos scale + bias, the row softmax, P to the tile
    float p[NT][4];
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 bb = *aw.at(pt, i, j);
        p[j][2 * i] = cs[j][2 * i] * sc + bb.x;
        p[j][2 * i + 1] = cs[j][2 * i + 1] * sc + bb.y;
        m[i] = fmaxf(m[i], fmaxf(p[j][2 * i], p[j][2 * i + 1]));
      }
    aw.row_total(red, m, true);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = expf(p[j][e] - m[e / 2]);
        sum[e / 2] += p[j][e];
      }
    aw.row_total(red + 2 * kTile, sum, false);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float iv = 1.f / sum[i];
        *aw.at(pt, i, j) = make_float2(p[j][2 * i] * iv, p[j][2 * i + 1] * iv);
      }
  }
  __syncthreads();  // P is whole
  float dv[1][2][4] = {};
  aw.keys_by_rows(pt, das, dv);  // dV = P^T dA
  float part = 0.f;              // this thread's sum of dS cos
  {  // dP = dA v^T, then dS = P (dP - rowsum(P dP)) in place of P
    float dp[NT][4];
    aw.rows_by_channels(das, vs, dp);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pv = *aw.at(pt, i, j);
        delta[i] = fmaf(pv.x, dp[j][2 * i], delta[i]);
        delta[i] = fmaf(pv.y, dp[j][2 * i + 1], delta[i]);
      }
    aw.row_total(red + 4 * kTile, delta, false);  // its barrier: P, dA and v are read
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pv = *aw.at(pt, i, j);
        const float2 v = make_float2(pv.x * (dp[j][2 * i] - delta[i]),
                                     pv.y * (dp[j][2 * i + 1] - delta[i]));
        *aw.at(pt, i, j) = BF ? make_float2(sc * v.x, sc * v.y) : v;
        *reinterpret_cast<float2*>(dS + head + aw.s_row(i) * kTile + aw.s_col(j)) = v;
        part = fmaf(v.x, cs[j][2 * i], part);
        part = fmaf(v.y, cs[j][2 * i + 1], part);
      }
  }
  part = warp_sum(part);
  if (lane == 0) wsum[warp] = part;
  __syncthreads();  // dS and the warp sums are whole
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += wsum[w];
    dscale_part[window * nh + h] = acc;
  }
  const float dsc = BF ? 1.f : sc;  // the bf16 tile holds scale dS already
  {  // dq^ = scale dS k^, to the room of dA
    float o[2][4];
    aw.rows_by_keys(pt, ks, o);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) das[aw.o_row(e) * LD + aw.o_chan(j, e)] = dsc * o[j][e];
  }
  {  // dk^ = scale dS^T q^, to the room of v
    float dk[1][2][4] = {};
    aw.keys_by_rows(pt, qs, dk);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) vs[aw.u_key(0, e) * LD + aw.u_chan(0, j, e)] = dsc * dk[0][j][e];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = aw.u_chan(0, j, e);
      if (d < hd)
        st_f(dqkv + (long long)tok[aw.u_key(0, e)] * C3 + 2 * C + h * hd + d, dv[0][j][e]);
    }
  __syncthreads();  // dq^ and dk^ are whole
  // the normalisation's backward, one warp a row: the q rows, then the k rows
  for (int r = warp; r < 2 * kTile; r += kWarps) {
    const int side = r / kTile, rr = r % kTile;
    const float x = lane < hd ? (side == 0 ? qs : ks)[rr * LD + lane] : 0.f;
    const float gx = lane < hd ? (side == 0 ? das : vs)[rr * LD + lane] : 0.f;
    const float dot = warp_sum(x * gx);
    if (lane < hd)
      st_f(dqkv + (long long)tok[rr] * C3 + side * C + h * hd + lane, (gx - x * dot) * inv[r]);
  }
}

}  // namespace trr

extern "C" {

size_t trr_cos_attn_fwd_smem_bytes(int C) { return (size_t)trr::cos_attn_fwd_smem_bytes(C); }
size_t trr_pn_mlp_fwd_smem_bytes(int C) { return (size_t)trr::pn_mlp_fwd_smem_bytes(C); }
size_t trr_cos_attn_bwd_smem_bytes() {
  return (size_t)trr::cos_attn_bwd_smem_floats() * sizeof(float);
}
// The largest shared memory of the MLP half's backward kernels (any hidden).
size_t trr_pn_mlp_bwd_smem_bytes(int C, int hidden) {
  return (size_t)std::max({trr::linear_smem_bytes(), trr::hidden_smem_bytes(),
                           trr::rows_smem_bytes(C)});
}

// The attention half's forward (#11): x, z (B, H, W, C); wq (C, 3C), bq
// (3C), scale (nh) already exponentiated, wp (C, C), bp, g, be (C), bias
// (kinds, nh, 64, 64), s (B); scratch qkv (T, 3C), att, proj (T, C).
// Windows are 8x8 of x rolled by (-shift, -shift); z is in x's frame.
int trr_cos_attn_fwd(const float* x, const float* wq, const float* bq, const float* scale,
                     const float* wp, const float* bp, const float* g, const float* be,
                     const float* bias, const float* s, float* qkv, float* att, float* proj,
                     float* z, int B, int H, int W, int C, int nh, int kinds, int shift,
                     float eps, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::linear(x, wq, bq, qkv, tokens, C, 3 * C, stream));
  TRR_TRY(trr::cos_window_attention(qkv, scale, bias, att, B, H, W, C, nh, kinds, shift, stream));
  TRR_TRY(trr::linear(att, wp, bp, proj, tokens, C, C, stream));
  return (int)trr::postnorm_rows(proj, g, be, x, s, z, tokens, hw, C, eps, stream);
}

// The attention half's backward (#12): x, dout (B, H, W, C) and the
// forward's operands -> dx; for the wrapper's weight gradients and sums
// qkv (T, 3C), att, dproj (T, C), dqkv (T, 3C), ln_part (ceil(T / 128), 2C),
// dS (B, H/8, W/8, nh, 64, 64), dscale_part (B * H/8 * W/8, nh). Scratch:
// proj, datt (T, C). C is at most 256 and a multiple of 4.
int trr_cos_attn_bwd(const float* x, const float* dout, const float* wq, const float* bq,
                     const float* scale, const float* wp, const float* bp, const float* g,
                     const float* s, const float* bias, float* qkv, float* att, float* proj,
                     float* dproj, float* datt, float* ln_part, float* dqkv, float* dS,
                     float* dscale_part, float* dx, int B, int H, int W, int C, int nh, int kinds,
                     int shift, float eps, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTcRows - 1) / trr::kTcRows);
  TRR_TRY(trr::linear(x, wq, bq, qkv, tokens, C, 3 * C, stream));
  TRR_TRY(trr::cos_window_attention(qkv, scale, bias, att, B, H, W, C, nh, kinds, shift, stream));
  TRR_TRY(trr::linear(att, wp, bp, proj, tokens, C, C, stream));
  trr::postnorm_ln_rows_kernel<float><<<blocks, trr::kThreads, 0, stream>>>(
      proj, dout, g, s, dproj, nullptr, ln_part, tokens, hw, C, eps);
  TRR_TRY(cudaGetLastError());
  TRR_TRY(trr::rows<trr::kRowsStore>(dproj, wp, tokens, C, C, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, hw, datt, nullptr, nullptr, stream));
  const int floats = trr::cos_attn_bwd_smem_floats();
  TRR_TRY(trr::set_smem(trr::cos_attn_bwd_tc_kernel<float>, floats));
  trr::cos_attn_bwd_tc_kernel<float><<<dim3(nh, (H / 8) * (W / 8), B),
                                       trr::attn_tc_threads(trr::kTile), floats * sizeof(float),
                                       stream>>>(qkv, datt, scale, bias, dqkv, dS, dscale_part, H,
                                                 W, C, nh, kinds, shift);
  TRR_TRY(cudaGetLastError());
  return (int)trr::rows<trr::kRowsResidual>(dqkv, wq, tokens, 3 * C, C, nullptr, nullptr,
                                             nullptr, dout, nullptr, hw, dx, nullptr, nullptr,
                                             stream);
}

// The MLP half's forward (#13): x, out (B, H, W, C) as B*H*W tokens; w1 (C,
// hidden), b1 (hidden), w2 (hidden, C), b2, g, be (C), s (B); scratch hg
// (T, hidden), m (T, C).
int trr_pn_mlp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* g, const float* be, const float* s, float* hg,
                   float* m, float* out, int B, int H, int W, int C, int hidden, float eps,
                   cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::linear<trr::kLinearGelu>(x, w1, b1, hg, tokens, C, hidden, stream));
  TRR_TRY(trr::linear(hg, w2, b2, m, tokens, hidden, C, stream));
  return (int)trr::postnorm_rows(m, g, be, x, s, out, tokens, hw, C, eps, stream);
}

// The MLP half's backward (#14): x, dout (B, H, W, C) and the forward's
// operands -> dx; for the wrapper's weight gradients and sums hg, dh (T,
// hidden), dm (T, C), ln_part (ceil(T / 128), 2C). Scratch: m (T, C). C is
// at most 256 and a multiple of 4, hidden a multiple of 4.
int trr_pn_mlp_bwd(const float* x, const float* dout, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* g, const float* s, float* hg,
                   float* m, float* dm, float* dh, float* dx, float* ln_part, int B, int H, int W,
                   int C, int hidden, float eps, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTcRows - 1) / trr::kTcRows);
  TRR_TRY(trr::linear<trr::kLinearGelu>(x, w1, b1, hg, tokens, C, hidden, stream));
  TRR_TRY(trr::linear(hg, w2, b2, m, tokens, hidden, C, stream));
  trr::postnorm_ln_rows_kernel<float><<<blocks, trr::kThreads, 0, stream>>>(
      m, dout, g, s, dm, nullptr, ln_part, tokens, hw, C, eps);
  TRR_TRY(cudaGetLastError());
  TRR_TRY(trr::mlp_hidden(x, dm, w1, b1, w2, nullptr, dh, tokens, C, hidden, stream));
  return (int)trr::rows<trr::kRowsResidual>(dh, w1, tokens, hidden, C, nullptr, nullptr, nullptr,
                                             dout, nullptr, hw, dx, nullptr, nullptr, stream);
}


// The bf16 forms (#11-#14's, for a bf16 training step): the fp32 forms'
// stages on bf16 activations and weights, rounding where the JAX kernels
// round in bf16 (ops/pallas/fused_block_v2.py: qkv = bf16(bf16(x wq) +
// bf16(bq)), cos from bf16(q^) and bf16(k^), att = bf16(bf16(P) v), proj and
// m as qkv, h and hg as #2's bf16 form, z = bf16(x + s LN(proj))); the
// statistics, norms, softmax, gelu and every bias or LayerNorm gradient in
// fp32. The products run on tc_rows_bf16.cuh's kernels (bf16 wgmma, fp32
// sums), the window attention on mma.sync m16n8k16; the weight gradients
// are the wrappers' calls of wgrad_bf16.cuh's stage (trr_weight_grad_bf16,
// fused_block_train.cu). Their
// bound at Swin2SR-M's block (T 18,432, C 180): 5.6 and 17 GFLOP (the
// attention half), 4.8 and 14 (the MLP half), 6-17 us on the bf16 tensor
// cores, against 6.6 MB a bf16 (T, C) activation: both halves lie near the
// ridge, their stages' intermediates through device memory.

size_t trr_cos_attn_bf16_smem_bytes(int C) { return (size_t)trr::cos_attn_bf16_smem_bytes(C); }
size_t trr_pn_mlp_bf16_smem_bytes(int C, int hidden) {
  return (size_t)trr::pn_mlp_bf16_smem_bytes(C, hidden);
}

// #11's bf16 form: x, z (B, H, W, C) bf16; wq (C, 3C), wp (C, C) bf16; bq,
// scale (nh), bp, g, be, bias (kinds, nh, 64, 64), s (B) fp32; scratch qkv
// (T, 3C), att, proj (T, C) bf16. Four launches, as trr_cos_attn_fwd.
int trr_cos_attn_fwd_bf16(const trr::bf16* x, const trr::bf16* wq, const float* bq,
                          const float* scale, const trr::bf16* wp, const float* bp,
                          const float* g, const float* be, const float* bias, const float* s,
                          trr::bf16* qkv, trr::bf16* att, trr::bf16* proj, trr::bf16* z, int B,
                          int H, int W, int C, int nh, int kinds, int shift, float eps,
                          cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::linear_bf16(x, wq, bq, qkv, tokens, C, 3 * C, stream));
  TRR_TRY(trr::cos_window_attention(qkv, scale, bias, att, B, H, W, C, nh, kinds, shift, stream));
  TRR_TRY(trr::linear_bf16(att, wp, bp, proj, tokens, C, C, stream));
  return (int)trr::postnorm_rows_bf16(proj, g, be, x, s, z, tokens, hw, C, eps, stream);
}

// #12's bf16 form: x, dout, dx (B, H, W, C) bf16 and the operands as
// trr_cos_attn_fwd_bf16 takes them; for the wrapper's weight gradients and
// sums qkv (T, 3C), att, dproj (T, C) bf16 and dproj32 (T, C) fp32, dqkv (T,
// 3C) bf16, ln_part (ceil(T / 128), 2C), dS (B, H/8, W/8, nh, 64, 64) and
// dscale_part (B * H/8 * W/8, nh) fp32. Scratch: proj, datt (T, C) bf16. C at
// most 256 and a multiple of 4.
int trr_cos_attn_bwd_bf16(const trr::bf16* x, const trr::bf16* dout, const trr::bf16* wq,
                          const float* bq, const float* scale, const trr::bf16* wp,
                          const float* bp, const float* g, const float* s, const float* bias,
                          trr::bf16* qkv, trr::bf16* att, trr::bf16* proj, trr::bf16* dproj,
                          float* dproj32, trr::bf16* datt, float* ln_part, trr::bf16* dqkv,
                          float* dS, float* dscale_part, trr::bf16* dx, int B, int H, int W,
                          int C, int nh, int kinds, int shift, float eps, cudaStream_t stream) {
  using trr::bf16;
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTcRows - 1) / trr::kTcRows);
  TRR_TRY(trr::linear_bf16(x, wq, bq, qkv, tokens, C, 3 * C, stream));
  TRR_TRY(trr::cos_window_attention(qkv, scale, bias, att, B, H, W, C, nh, kinds, shift, stream));
  TRR_TRY(trr::linear_bf16(att, wp, bp, proj, tokens, C, C, stream));
  trr::postnorm_ln_rows_kernel<bf16><<<blocks, trr::kThreads, 0, stream>>>(
      proj, dout, g, s, dproj, dproj32, ln_part, tokens, hw, C, eps);
  TRR_TRY(cudaGetLastError());
  TRR_TRY((trr::rows_bf16<trr::kRowsStore, float, bf16>(dproj, wp, tokens, C, C, nullptr, nullptr,
                                                       nullptr, nullptr, nullptr, hw, datt,
                                                       nullptr, nullptr, stream)));
  const int floats = trr::cos_attn_bwd_smem_floats();
  TRR_TRY(trr::set_smem(trr::cos_attn_bwd_tc_kernel<bf16>, floats));
  trr::cos_attn_bwd_tc_kernel<bf16><<<dim3(nh, (H / 8) * (W / 8), B),
                                      trr::attn_tc_threads(trr::kTile), floats * sizeof(float),
                                      stream>>>(qkv, datt, scale, bias, dqkv, dS, dscale_part, H,
                                                W, C, nh, kinds, shift);
  TRR_TRY(cudaGetLastError());
  return (int)trr::rows_bf16<trr::kRowsResidual, bf16, bf16>(dqkv, wq, tokens, 3 * C, C, nullptr,
                                                              nullptr, nullptr, dout, nullptr, hw,
                                                              dx, nullptr, nullptr, stream);
}

// #13's bf16 form: x, out (B, H, W, C) bf16; w1 (C, hidden), w2 (hidden, C)
// bf16; b1, b2, g, be, s fp32; scratch hg (T, hidden), m (T, C) bf16. Three
// launches, as trr_pn_mlp_fwd.
int trr_pn_mlp_fwd_bf16(const trr::bf16* x, const trr::bf16* w1, const float* b1,
                        const trr::bf16* w2, const float* b2, const float* g, const float* be,
                        const float* s, trr::bf16* hg, trr::bf16* m, trr::bf16* out, int B, int H,
                        int W, int C, int hidden, float eps, cudaStream_t stream) {
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  TRR_TRY(trr::linear_bf16<trr::kLinearGelu>(x, w1, b1, hg, tokens, C, hidden, stream));
  TRR_TRY(trr::linear_bf16(hg, w2, b2, m, tokens, hidden, C, stream));
  return (int)trr::postnorm_rows_bf16(m, g, be, x, s, out, tokens, hw, C, eps, stream);
}

// #14's bf16 form: x, dout, dx (B, H, W, C) bf16 and the operands as
// trr_pn_mlp_fwd_bf16 takes them; for the wrapper's weight gradients and
// sums hg, dh (T, hidden) and dm (T, C) bf16, dh32 (T, hidden) and dm32 (T,
// C) fp32, ln_part (ceil(T / 128), 2C). Scratch: m (T, C) bf16. C at most 256
// and a multiple of 4, hidden a multiple of 4.
int trr_pn_mlp_bwd_bf16(const trr::bf16* x, const trr::bf16* dout, const trr::bf16* w1,
                        const float* b1, const trr::bf16* w2, const float* b2, const float* g,
                        const float* s, trr::bf16* hg, trr::bf16* m, trr::bf16* dm, float* dm32,
                        trr::bf16* dh, float* dh32, trr::bf16* dx, float* ln_part, int B, int H,
                        int W, int C, int hidden, float eps, cudaStream_t stream) {
  using trr::bf16;
  const long long tokens = (long long)B * H * W, hw = (long long)H * W;
  const unsigned blocks = (unsigned)((tokens + trr::kTcRows - 1) / trr::kTcRows);
  TRR_TRY(trr::linear_bf16<trr::kLinearGelu>(x, w1, b1, hg, tokens, C, hidden, stream));
  TRR_TRY(trr::linear_bf16(hg, w2, b2, m, tokens, hidden, C, stream));
  trr::postnorm_ln_rows_kernel<bf16><<<blocks, trr::kThreads, 0, stream>>>(
      m, dout, g, s, dm, dm32, ln_part, tokens, hw, C, eps);
  TRR_TRY(cudaGetLastError());
  TRR_TRY(trr::mlp_hidden_bf16(x, dm, w1, b1, w2, nullptr, dh, dh32, tokens, C, hidden, stream));
  return (int)trr::rows_bf16<trr::kRowsResidual, bf16, bf16>(dh, w1, tokens, hidden, C, nullptr,
                                                              nullptr, nullptr, dout, nullptr, hw,
                                                              dx, nullptr, nullptr, stream);
}

}  // extern "C"
