// The per-token kernels of the bf16 training block (#4 and #5's bf16 forms,
// fused_block_train.cu) on the bf16 engine (tc_gemm_bf16.cuh): tc_rows.cuh's
// kernels with bf16 activations and weights, rounding where the JAX
// package's Pallas kernel rounds (ops/pallas/fused_block.py,
// _swin_block_fwd_kernel and _swin_block_bwd_kernel, which compute in
// x.dtype):
//   ln_rows_bf16_kernel   y = bf16(LN(x)) from fp32 statistics; with dout,
//                         dm = bf16(s dout);
//   linear_bf16_kernel    out = bf16(bf16(A W) + bf16(b)), its gelu
//                         bf16(gelu(.)), or the residual
//                         bf16(x + bf16(bf16(s) bf16(bf16(A W) + bf16(b))));
//   mlp_hidden_bf16_kernel  h = bf16(bf16(y w1) + bf16(b1)), hg =
//                         bf16(gelu(h)), dh = (dm w2^T) gelu'(h) in fp32,
//                         stored as bf16 (the next products' operand) and
//                         fp32 (db1's sum);
//   rows_bf16_kernel      dy = A W^T in fp32, then bf16(dy) (datt), bf16(dres
//                         + dy) (the post-norm halves' dx) or the
//                         LayerNorm backward in fp32: out = dres + LN'(dy)
//                         (dz in fp32, or dx in bf16), outs = bf16(s out);
//   postnorm_rows_bf16_kernel  out = bf16(res + s LN(x)), the post-norm
//                         halves' row pass (#11 and #13's bf16 forms).
// Every LayerNorm statistic, softmax, gelu and sum of a row is fp32. 256
// threads, two warpgroups of 64 rows, one block a SM, as the fp32 forms.
// Rows of C <= 192 channels in the whole block (the training gate's), of
// C <= 256 in the MLP half alone on a 256-column rows tile, and of C <= 320
// there on the split rows stage (ln_bwd_rows_kernel, #7 and its bf16 form),
// every width a multiple of 4: rows move 8 bytes (4 bf16) at a time.
#pragma once

#include "tc_gemm_bf16.cuh"
#include "tc_rows.cuh"

namespace trr {

// A per-token bf16 stage: a (128, kBfK) token chunk [row][k] (row stride
// kBfLd) and a raw (BN, kBfK) weight chunk, [n][k] (stride kBfLd) or [k][n]
// (stride BN + 8), in floats (two bf16 a float) for the ring.
__host__ __device__ constexpr int token_stage_floats_bf16(int bn) {
  return (kTcRows * kBfLd + (bn * kBfLd > kBfK * (bn + 8) ? bn * kBfLd : kBfK * (bn + 8))) / 2;
}

// Shared memory, in bytes, of a bf16 per-token kernel at BN columns: the
// core-tile buffers, then the ring.
__host__ __device__ inline int wg_bf16_bytes(int bn) {
  return core_words(bn) * 4 + Ring<>::bytes(token_stage_floats_bf16(bn));
}
// rows_bf16_kernel also reuses its buffers for the (128, BN + 8) fp32 dy
// tile and the warps' column sums.
__host__ __device__ inline int rows_bf16_smem_bytes(int C) {
  const int bn = rows_cols(C), tile = 4 * (kTcRows * (bn + 8) + 2 * kWarps * C);
  return wg_bf16_bytes(bn) > tile ? wg_bf16_bytes(bn) : tile;
}
__host__ __device__ inline int hidden_bf16_smem_bytes() {
  return kGeluFloats * 4 + wg_bf16_bytes(kHidTile);
}

template <int BN, bool B_KMAJOR>
__device__ __forceinline__ void load_wg_stage_bf16(float* stage, const bf16* __restrict__ A,
                                                   long long t0, long long T,
                                                   const bf16* __restrict__ W, int n0, int N,
                                                   int K, int j) {
  bf16* st = reinterpret_cast<bf16*>(stage);
  load_tile_bf16<kTcRows, kBfK>(st, kBfLd, A, K, t0, T, j * kBfK, K);
  if constexpr (B_KMAJOR)
    load_tile_bf16<BN, kBfK>(st + kTcRows * kBfLd, kBfLd, W, K, n0, N, j * kBfK, K);
  else
    load_tile_bf16<kBfK, BN>(st + kTcRows * kBfLd, BN + 8, W, N, j * kBfK, K, n0, N);
}

template <int BN, bool B_KMAJOR>
__device__ __forceinline__ void use_wg_stage_bf16(float (&acc)[BN / 2], const float* stage,
                                                  uint32_t* core, int j, AFragBf<> (&af)[2]) {
  const bf16* st = reinterpret_cast<const bf16*>(stage);
  wgmma_bf16_chunk<BN, kBfK, B_KMAJOR>(acc, st, kBfLd, 16 * (threadIdx.x / 32),
                                       st + kTcRows * kBfLd, B_KMAJOR ? kBfLd : BN + 8, core, j,
                                       af);
}

// acc (this warpgroup's 64 x BN of the block tile) = A W over K: A (T, K)
// rows t0.., W (K, N) columns n0.. (N-major: transposed as it is copied).
// Chunk j of the product is chunk j0 + j of the block's core buffers.
template <int BN>
__device__ __forceinline__ void xw_product_bf16(float (&acc)[BN / 2], Ring<>& ring,
                                                uint32_t* core, AFragBf<> (&af)[2],
                                                const bf16* __restrict__ A, long long t0,
                                                long long T, const bf16* __restrict__ W, int n0,
                                                int N, int K, int j0) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring.run(
      (K + kBfK - 1) / kBfK,
      [&](int j, float* st) { load_wg_stage_bf16<BN, false>(st, A, t0, T, W, n0, N, K, j); },
      [&](int j, const float* st) { use_wg_stage_bf16<BN, false>(acc, st, core, j0 + j, af); });
  wgmma_wait_all();
  fence_operands(acc);
}

// y = bf16(LN(x)) (T, C) with g and be, two-pass mean and variance in fp32;
// stats (T, 2) the mean and 1/std of each row, when not null; when dm is
// not null, dm = bf16(s[t / hw] dout) as well. One warp a token, C <=
// kLnMaxC, C a multiple of 4.
__global__ void __launch_bounds__(kThreads)
    ln_rows_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ be, bf16* __restrict__ y,
                        float* __restrict__ stats, const bf16* __restrict__ dout,
                        const float* __restrict__ s, bf16* __restrict__ dm, long long T,
                        long long hw, int C, float eps) {
  constexpr int PER = kLnMaxC / (32 * 4);  // loads of 4 a lane
  const long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x % 32, nv = C / 4;
  float4 v[PER];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    v[i] = ldg4(x + t * C + 4 * e);
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(sum) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i >= nv) continue;
    const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
  if (lane == 0 && stats != nullptr) {
    stats[2 * t] = mean;
    stats[2 * t + 1] = inv;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    const float4 gg = ldg4(g + 4 * e), bb = ldg4(be + 4 * e);
    st4(y + t * C + 4 * e,
        make_float4((v[i].x - mean) * inv * gg.x + bb.x, (v[i].y - mean) * inv * gg.y + bb.y,
                    (v[i].z - mean) * inv * gg.z + bb.z, (v[i].w - mean) * inv * gg.w + bb.w));
  }
  if (dm != nullptr) {
    const float sc = __ldg(s + t / hw);
    for (int e = lane; e < nv; e += 32) {
      const float4 d = ldg4(dout + t * C + 4 * e);
      st4(dm + t * C + 4 * e, make_float4(sc * d.x, sc * d.y, sc * d.z, sc * d.w));
    }
  }
}

// out = bf16(res + s[t / hw] LN(x)) (T, C) with g and be: the post-norm
// blocks' last stage in bf16 (#11 and #13's bf16 forms, the JAX kernel's
// (t + s y32).astype(bf16)), x and res bf16, the two-pass statistics, the
// affine and the DropPath scale in fp32, one rounding. One warp a token, C
// <= kLnMaxC, C a multiple of 4.
__global__ void __launch_bounds__(kThreads)
    postnorm_rows_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                              const float* __restrict__ be, const bf16* __restrict__ res,
                              const float* __restrict__ s, bf16* __restrict__ out, long long T,
                              long long hw, int C, float eps) {
  constexpr int PER = kLnMaxC / (32 * 4);  // loads of 4 a lane
  const long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x % 32, nv = C / 4;
  float4 v[PER];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    v[i] = ldg4(x + t * C + 4 * e);
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(sum) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i >= nv) continue;
    const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
  const float sr = __ldg(s + t / hw);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    if (e >= nv) continue;
    const float4 gg = ldg4(g + 4 * e), bb = ldg4(be + 4 * e), r = ldg4(res + t * C + 4 * e);
    st4(out + t * C + 4 * e,
        make_float4(r.x + sr * ((v[i].x - mean) * inv * gg.x + bb.x),
                    r.y + sr * ((v[i].y - mean) * inv * gg.y + bb.y),
                    r.z + sr * ((v[i].z - mean) * inv * gg.z + bb.z),
                    r.w + sr * ((v[i].w - mean) * inv * gg.w + bb.w)));
  }
}

// Per 128 tokens t0.. and BN columns n0..: out (T, N) from A (T, K) W (K, N)
// as EPI says (kLinearBias, kLinearGelu, kLinearResidual with x (T, N) and
// s (T / hw)), rounded to bf16 where the JAX kernel rounds (above); W as it
// lies (N-major); a ragged last column tile is masked. BN is
// linear_cols(N); K and N multiples of 4.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    linear_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                       const float* __restrict__ b, const bf16* __restrict__ x,
                       const float* __restrict__ s, bf16* __restrict__ out, long long T,
                       long long hw, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* core = reinterpret_cast<uint32_t*>(smem);
  Ring<> ring;
  ring.init(smem + core_words(BN), token_stage_floats_bf16(BN));
  const int ncol = (N + BN - 1) / BN;  // column tiles: the grid's fastest index
  const long long t0 = (long long)(blockIdx.x / ncol) * kTcRows;
  const int n0 = (int)(blockIdx.x % ncol) * BN;
  float acc[BN / 2];
  AFragBf<> af[2];
  xw_product_bf16<BN>(acc, ring, core, af, A, t0, T, W, n0, N, K, 0);
  // a thread's elements lie in two rows, acc_row(0) and 8 below it
  long long tr[2];
  float sc[2] = {1.f, 1.f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    tr[k] = t0 + acc_row(2 * k);
    if constexpr (EPI == kLinearResidual) sc[k] = tr[k] < T ? rbf(__ldg(s + tr[k] / hw)) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i), k = (i / 2) % 2;
    const long long t = tr[k];
    if (c >= N || t >= T) continue;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
    float y0 = rbf(rbf(acc[i]) + rbf(bb.x)), y1 = rbf(rbf(acc[i + 1]) + rbf(bb.y));
    if constexpr (EPI == kLinearGelu) y0 = gelu_erf(y0), y1 = gelu_erf(y1);
    if constexpr (EPI == kLinearResidual) {
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + t * N + c));
      y0 = xv.x + rbf(sc[k] * y0);
      y1 = xv.y + rbf(sc[k] * y1);
    }
    *reinterpret_cast<uint32_t*>(out + t * N + c) = pack_f32(y0, y1);
  }
}

// Per 128 tokens t0.. and 128 hidden units n0..: h = bf16(bf16(y w1) +
// bf16(b1)), hg = bf16(gelu(h)) (unless hg is null); dh = (dm w2^T)
// gelu'(h) to dh (bf16) and dh32 (fp32). y, dm (T, C); w1 (C, hidden) read
// N-major, w2 (hidden, C) K-major; gelu'(h) waits in shared memory while
// the second product runs.
__global__ void __launch_bounds__(kThreads, 1)
    mlp_hidden_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dm,
                           const bf16* __restrict__ w1, const float* __restrict__ b1,
                           const bf16* __restrict__ w2, bf16* __restrict__ hg,
                           bf16* __restrict__ dh, float* __restrict__ dh32, long long T, int C,
                           int hidden) {
  constexpr int BN = kHidTile;
  extern __shared__ __align__(16) float smem[];
  float* gp = smem;  // gelu'(h), element e of thread i at gp[e * kThreads + i]
  uint32_t* core = reinterpret_cast<uint32_t*>(gp + kGeluFloats);
  Ring<> ring;
  ring.init(reinterpret_cast<float*>(core + core_words(BN)), token_stage_floats_bf16(BN));
  const long long t0 = (long long)blockIdx.x * kTcRows;
  const int n0 = blockIdx.y * kHidTile;
  const int nk = (C + kBfK - 1) / kBfK;
  float acc[BN / 2];
  AFragBf<> af[2];
  xw_product_bf16<BN>(acc, ring, core, af, y, t0, T, w1, n0, hidden, C, 0);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i);
    const long long t = t0 + acc_row(i);
    if (c < hidden) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
      const float h0 = rbf(rbf(acc[i]) + rbf(bb.x)), h1 = rbf(rbf(acc[i + 1]) + rbf(bb.y));
      if (hg != nullptr && t < T)
        *reinterpret_cast<uint32_t*>(hg + t * hidden + c) = pack_f32(gelu_erf(h0), gelu_erf(h1));
      gp[i * kThreads + threadIdx.x] = gelu_erf_grad(h0);
      gp[(i + 1) * kThreads + threadIdx.x] = gelu_erf_grad(h1);
    }
    acc[i] = 0.f;
    acc[i + 1] = 0.f;
  }
  ring.run(
      nk,
      [&](int j, float* st) { load_wg_stage_bf16<BN, true>(st, dm, t0, T, w2, n0, hidden, C, j); },
      [&](int j, const float* st) { use_wg_stage_bf16<BN, true>(acc, st, core, nk + j, af); });
  wgmma_wait_all();
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int c = n0 + acc_col(i);
    const long long t = t0 + acc_row(i);
    if (c < hidden && t < T) {
      const float d0 = acc[i] * gp[i * kThreads + threadIdx.x];
      const float d1 = acc[i + 1] * gp[(i + 1) * kThreads + threadIdx.x];
      *reinterpret_cast<uint32_t*>(dh + t * hidden + c) = pack_f32(d0, d1);
      *reinterpret_cast<float2*>(dh32 + t * hidden + c) = make_float2(d0, d1);
    }
  }
}

// Per 128 tokens t0.., every column (BN >= C): dy = A W^T in fp32 with A (T,
// K) and W (C, K) as it lies (K-major). EPI kRowsStore: out = bf16(dy);
// kRowsResidual: out = dres + dy, rounded where OT is bf16 (#12 and #14's
// bf16 dx = bf16(dout + dt)); kRowsLn: the LayerNorm backward of the rows
// in fp32, out = dres + inv (dy g - mean(dy g) - xn mean(dy g xn)) with xn
// = (xln - mean) inv from stats
// (T, 2); outs = bf16(s[t / hw] out) when not null; the block's partial
// sums of dg = sum dy xn (first C) and dbe = sum dy (next C) to
// ln_part[blockIdx.x]. RT, OT: the types of dres and out (float or bf16).
template <int BN, int EPI, typename RT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    rows_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, long long T, int K,
                     int C, const bf16* __restrict__ xln, const float* __restrict__ stats,
                     const float* __restrict__ g, const RT* __restrict__ dres,
                     const float* __restrict__ s, long long hw, OT* __restrict__ out,
                     bf16* __restrict__ outs, float* __restrict__ ln_part) {
  constexpr int LDY = BN + 8;
  extern __shared__ __align__(16) float smem[];
  uint32_t* core = reinterpret_cast<uint32_t*>(smem);
  Ring<> ring;
  ring.init(smem + core_words(BN), token_stage_floats_bf16(BN));
  const long long t0 = (long long)blockIdx.x * kTcRows;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  AFragBf<> af[2];
  ring.run(
      (K + kBfK - 1) / kBfK,
      [&](int j, float* st) { load_wg_stage_bf16<BN, true>(st, A, t0, T, W, 0, C, K, j); },
      [&](int j, const float* st) { use_wg_stage_bf16<BN, true>(acc, st, core, j, af); });
  wgmma_wait_all();
  fence_operands(acc);
  __syncthreads();  // every warp is done with the buffers: they become the dy tile
  float* dy = smem;  // (128, LDY)
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    *reinterpret_cast<float2*>(dy + acc_row(i) * LDY + acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
  __syncwarp();  // a warp reads back only its own 16 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = C / 4;
  const float4* dy4 = reinterpret_cast<const float4*>(dy);
  if constexpr (EPI != kRowsLn) {
    for (int r = 16 * warp; r < 16 * warp + 16 && t0 + r < T; ++r)
      for (int c4 = lane; c4 < n4; c4 += 32) {
        float4 v = dy4[r * (LDY / 4) + c4];
        if constexpr (EPI == kRowsResidual) {
          const float4 d = ldg4(dres + (t0 + r) * C + 4 * c4);
          v = make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
        }
        st4(out + (t0 + r) * C + 4 * c4, v);
      }
  } else {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 gv[2], cg[2] = {zero4, zero4}, cb[2] = {zero4, zero4};
#pragma unroll
    for (int v = 0; v < 2; ++v) gv[v] = lane + 32 * v < n4 ? ldg4(g + 4 * (lane + 32 * v)) : zero4;
    for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += 4) {
      float4 xv[4][2], rv[4][2];
      float mean[4], inv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long t = t0 + r0 + u;
        const bool ok = t < T;
        mean[u] = ok ? __ldg(stats + 2 * t) : 0.f;
        inv[u] = ok ? __ldg(stats + 2 * t + 1) : 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          const bool in = ok && c4 < n4;
          xv[u][v] = in ? ldg4(xln + t * C + 4 * c4) : zero4;
          rv[u][v] = in ? ldg4(dres + t * C + 4 * c4) : zero4;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u;
        const long long t = t0 + r;
        float4 d[2], xn[2];
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          d[v] = c4 < n4 ? dy4[r * (LDY / 4) + c4] : zero4;
          xn[v] = make_float4((xv[u][v].x - mean[u]) * inv[u], (xv[u][v].y - mean[u]) * inv[u],
                              (xv[u][v].z - mean[u]) * inv[u], (xv[u][v].w - mean[u]) * inv[u]);
          const float4 e = make_float4(d[v].x * gv[v].x, d[v].y * gv[v].y, d[v].z * gv[v].z,
                                       d[v].w * gv[v].w);
          sa += (e.x + e.y) + (e.z + e.w);
          sb += (e.x * xn[v].x + e.y * xn[v].y) + (e.z * xn[v].z + e.w * xn[v].w);
          cg[v] = make_float4(fmaf(d[v].x, xn[v].x, cg[v].x), fmaf(d[v].y, xn[v].y, cg[v].y),
                              fmaf(d[v].z, xn[v].z, cg[v].z), fmaf(d[v].w, xn[v].w, cg[v].w));
          cb[v] = make_float4(cb[v].x + d[v].x, cb[v].y + d[v].y, cb[v].z + d[v].z,
                              cb[v].w + d[v].w);
        }
        const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
        if (t >= T) continue;
        const float sc = outs != nullptr ? __ldg(s + t / hw) : 0.f;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c4 = lane + 32 * v;
          if (c4 >= n4) continue;
          const float4 dx = make_float4(
              rv[u][v].x + inv[u] * (d[v].x * gv[v].x - ma - xn[v].x * mb),
              rv[u][v].y + inv[u] * (d[v].y * gv[v].y - ma - xn[v].y * mb),
              rv[u][v].z + inv[u] * (d[v].z * gv[v].z - ma - xn[v].z * mb),
              rv[u][v].w + inv[u] * (d[v].w * gv[v].w - ma - xn[v].w * mb));
          st4(out + t * C + 4 * c4, dx);
          if (outs != nullptr)
            st4(outs + t * C + 4 * c4, make_float4(sc * dx.x, sc * dx.y, sc * dx.z, sc * dx.w));
        }
      }
    }
    float* colred = smem + kTcRows * LDY;  // [8 warps][dg | dbe][C]
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
}

// Rows past one rows tile (kRowsMaxC < C <= kRowsWideMaxC: DRCT's MLP
// halves at C 276 and 308, #7 and its bf16 form). A 128-token tile of dy
// that spans such a row would hold C / 2 fp32 accumulators a thread (160
// at C 320, beside 3xTF32's split A fragments: past the 255 registers a
// thread may hold) and its fp32 dy tile (164 KB at C 320) would leave no
// room for the operand ring. So the rows stage splits: dy = A W^T goes to
// device memory in two column parts of at most kRowsHalf (rows_kernel or
// rows_bf16_kernel with kRowsStore, fp32 out, on W's rows 0..c0 and c0..C),
// and ln_bwd_rows_kernel below takes the LayerNorm backward over whole
// rows from there, as rows_kernel's kRowsLn epilogue does from its shared
// tile: the row sums of a row in one warp, the column sums of dg and dbe
// per 128 tokens in the block's partial sums, no atomics.
constexpr int kRowsMaxC = 256;       // channels of a row one rows tile spans
constexpr int kRowsHalf = 160;       // columns of the split stage's first part
constexpr int kRowsWideMaxC = 320;   // channels of a row the split stage takes

// Per 128 tokens t0..: the LayerNorm backward of rows of C <= kRowsWideMaxC
// channels (a multiple of 4) from dy in two parts, dy0 (T, c0) and dy1 (T,
// C - c0), fp32: out = dres + inv (dy g - mean(dy g) - xn mean(dy g xn))
// with xn = (xln - mean) inv from stats (T, 2), rounded where OT is bf16;
// outs = s[t / hw] out when not null; the block's partial sums of dg = sum
// dy xn (first C) and dbe = sum dy (next C) to ln_part[blockIdx.x]. Each
// warp walks its 16 rows two at a time (the loads of two rows, three
// 16-byte pieces a lane of each of dy, xln and dres, in flight together);
// the arithmetic is the kRowsLn epilogues' (rows_kernel, rows_bf16_kernel).
// XT, RT, OT: the types of xln, dres and out (float or bf16).
template <typename XT, typename RT, typename OT>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const float* __restrict__ dy0, const float* __restrict__ dy1, int c0,
                       long long T, int C, const XT* __restrict__ xln,
                       const float* __restrict__ stats, const float* __restrict__ g,
                       const RT* __restrict__ dres, const float* __restrict__ s, long long hw,
                       OT* __restrict__ out, OT* __restrict__ outs, float* __restrict__ ln_part) {
  constexpr int V = (kRowsWideMaxC + 127) / 128;  // 16-byte pieces of a row a lane
  __shared__ __align__(16) float colred[kWarps * 2 * kRowsWideMaxC];  // [warp][dg | dbe][C]
  const long long t0 = (long long)blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = C / 4, q0 = c0 / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 gv[V], cg[V], cb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gv[v] = lane + 32 * v < n4 ? ldg4(g + 4 * (lane + 32 * v)) : zero4;
    cg[v] = cb[v] = zero4;
  }
  constexpr int U = 2;  // rows a warp takes at once
  for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += U) {
    float4 xv[U][V], rv[U][V], dv[U][V];
    float mean[U], inv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + r0 + u;
      const bool ok = t < T;
      mean[u] = ok ? __ldg(stats + 2 * t) : 0.f;
      inv[u] = ok ? __ldg(stats + 2 * t + 1) : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c4 = lane + 32 * v;
        const bool in = ok && c4 < n4;
        xv[u][v] = in ? ldg4(xln + t * C + 4 * c4) : zero4;
        rv[u][v] = in ? ldg4(dres + t * C + 4 * c4) : zero4;
        dv[u][v] = !in        ? zero4
                   : c4 < q0 ? ldg4(dy0 + t * c0 + 4 * c4)
                              : ldg4(dy1 + t * (C - c0) + 4 * (c4 - q0));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + r0 + u;
      float4 xn[V];
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 d = dv[u][v];
        xn[v] = make_float4((xv[u][v].x - mean[u]) * inv[u], (xv[u][v].y - mean[u]) * inv[u],
                            (xv[u][v].z - mean[u]) * inv[u], (xv[u][v].w - mean[u]) * inv[u]);
        const float4 e = make_float4(d.x * gv[v].x, d.y * gv[v].y, d.z * gv[v].z, d.w * gv[v].w);
        sa += (e.x + e.y) + (e.z + e.w);
        sb += (e.x * xn[v].x + e.y * xn[v].y) + (e.z * xn[v].z + e.w * xn[v].w);
        cg[v] = make_float4(fmaf(d.x, xn[v].x, cg[v].x), fmaf(d.y, xn[v].y, cg[v].y),
                            fmaf(d.z, xn[v].z, cg[v].z), fmaf(d.w, xn[v].w, cg[v].w));
        cb[v] = make_float4(cb[v].x + d.x, cb[v].y + d.y, cb[v].z + d.z, cb[v].w + d.w);
      }
      const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
      if (t >= T) continue;
      const float sc = outs != nullptr ? __ldg(s + t / hw) : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c4 = lane + 32 * v;
        if (c4 >= n4) continue;
        const float4 d = dv[u][v];
        const float4 dx = make_float4(
            rv[u][v].x + inv[u] * (d.x * gv[v].x - ma - xn[v].x * mb),
            rv[u][v].y + inv[u] * (d.y * gv[v].y - ma - xn[v].y * mb),
            rv[u][v].z + inv[u] * (d.z * gv[v].z - ma - xn[v].z * mb),
            rv[u][v].w + inv[u] * (d.w * gv[v].w - ma - xn[v].w * mb));
        st4(out + t * C + 4 * c4, dx);
        if (outs != nullptr)
          st4(outs + t * C + 4 * c4, make_float4(sc * dx.x, sc * dx.y, sc * dx.z, sc * dx.w));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
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

// ln_bwd_rows_kernel over the T rows, dy (T * C floats) holding dy0 (T, c0)
// and then dy1 (T, C - c0).
template <typename XT, typename RT, typename OT>
inline cudaError_t ln_bwd_rows(const float* dy, int c0, long long T, int C, const XT* xln,
                               const float* stats, const float* g, const RT* dres,
                               const float* s, long long hw, OT* out, OT* outs, float* ln_part,
                               cudaStream_t stream) {
  if (C > kRowsWideMaxC || C % 4 || c0 % 4 || c0 >= C) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kTcRows - 1) / kTcRows);
  ln_bwd_rows_kernel<XT, RT, OT><<<blocks, kThreads, 0, stream>>>(
      dy, dy + T * c0, c0, T, C, xln, stats, g, dres, s, hw, out, outs, ln_part);
  return cudaGetLastError();
}

inline cudaError_t ln_rows_bf16(const bf16* x, const float* g, const float* be, bf16* y,
                                float* stats, const bf16* dout, const float* s, bf16* dm,
                                long long T, long long hw, int C, float eps,
                                cudaStream_t stream) {
  if (C > kLnMaxC || C % 4) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kWarps - 1) / kWarps);
  ln_rows_bf16_kernel<<<blocks, kThreads, 0, stream>>>(x, g, be, y, stats, dout, s, dm, T, hw, C,
                                                       eps);
  return cudaGetLastError();
}

inline cudaError_t postnorm_rows_bf16(const bf16* x, const float* g, const float* be,
                                      const bf16* res, const float* s, bf16* out, long long T,
                                      long long hw, int C, float eps, cudaStream_t stream) {
  if (C > kLnMaxC || C % 4) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kWarps - 1) / kWarps);
  postnorm_rows_bf16_kernel<<<blocks, kThreads, 0, stream>>>(x, g, be, res, s, out, T, hw, C, eps);
  return cudaGetLastError();
}

template <int BN, int EPI>
inline cudaError_t linear_bf16_launch(const bf16* A, const bf16* W, const float* b, const bf16* x,
                                      const float* s, bf16* out, long long T, long long hw, int K,
                                      int N, cudaStream_t stream) {
  const int smem = wg_bf16_bytes(BN);
  const cudaError_t err = cudaFuncSetAttribute(
      linear_bf16_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((T + kTcRows - 1) / kTcRows) * (unsigned)((N + BN - 1) / BN);
  linear_bf16_kernel<BN, EPI><<<grid, kThreads, smem, stream>>>(A, W, b, x, s, out, T, hw, K, N);
  return cudaGetLastError();
}

// linear_bf16_kernel over the whole of out (T, N), at linear_cols(N).
template <int EPI = kLinearBias>
inline cudaError_t linear_bf16(const bf16* A, const bf16* W, const float* b, bf16* out,
                               long long T, int K, int N, cudaStream_t stream,
                               const bf16* x = nullptr, const float* s = nullptr,
                               long long hw = 1) {
  if (K % 4 || N % 4) return cudaErrorInvalidValue;
  switch (linear_cols(N)) {
    case 64:
      return linear_bf16_launch<64, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
    case 96:
      return linear_bf16_launch<96, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
    default:
      return linear_bf16_launch<kColTile, EPI>(A, W, b, x, s, out, T, hw, K, N, stream);
  }
}

inline cudaError_t mlp_hidden_bf16(const bf16* y, const bf16* dm, const bf16* w1, const float* b1,
                                   const bf16* w2, bf16* hg, bf16* dh, float* dh32, long long T,
                                   int C, int hidden, cudaStream_t stream) {
  if (C % 4 || hidden % 4) return cudaErrorInvalidValue;
  const int smem = hidden_bf16_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_hidden_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + kTcRows - 1) / kTcRows), (hidden + kHidTile - 1) / kHidTile);
  mlp_hidden_bf16_kernel<<<grid, kThreads, smem, stream>>>(y, dm, w1, b1, w2, hg, dh, dh32, T, C,
                                                           hidden);
  return cudaGetLastError();
}

template <int BN, int EPI, typename RT, typename OT>
inline cudaError_t rows_bf16_launch(const bf16* A, const bf16* W, long long T, int K, int C,
                                    const bf16* xln, const float* stats, const float* g,
                                    const RT* dres, const float* s, long long hw, OT* out,
                                    bf16* outs, float* ln_part, cudaStream_t stream) {
  const int smem = rows_bf16_smem_bytes(C);
  const cudaError_t err = cudaFuncSetAttribute(
      rows_bf16_kernel<BN, EPI, RT, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((T + kTcRows - 1) / kTcRows);
  rows_bf16_kernel<BN, EPI, RT, OT><<<blocks, kThreads, smem, stream>>>(
      A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs, ln_part);
  return cudaGetLastError();
}

// rows_bf16_kernel at the column tile of C (<= 256, a multiple of 4); W (C, K).
template <int EPI, typename RT, typename OT>
inline cudaError_t rows_bf16(const bf16* A, const bf16* W, long long T, int K, int C,
                             const bf16* xln, const float* stats, const float* g, const RT* dres,
                             const float* s, long long hw, OT* out, bf16* outs, float* ln_part,
                             cudaStream_t stream) {
  if (C % 4 || K % 4) return cudaErrorInvalidValue;
  switch (rows_cols(C)) {
    case 64:
      return rows_bf16_launch<64, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                       ln_part, stream);
    case 128:
      return rows_bf16_launch<128, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                        ln_part, stream);
    case 192:
      return rows_bf16_launch<192, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                        ln_part, stream);
    case 256:
      return rows_bf16_launch<256, EPI>(A, W, T, K, C, xln, stats, g, dres, s, hw, out, outs,
                                        ln_part, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace trr
