// The window attention's products on the tensor cores: mma.sync m16n8k8
// tf32 in 3xTF32 (tc_gemm.cuh) on the operands a thread block holds in
// shared memory for one (window, head). Shared by attn_rows_fwd_tc_kernel
// below (the pre-LN block forwards #1 and #9 at 8x8 and 12x12 windows and #4,
// through block_fwd.cuh, #3's window MHSA forward, in window_attention.cu,
// and, in its cosine form, #11 and #12's forward stage, in
// fused_block_v2.cu), attn_rows_bwd_tc_kernel (#6's recompute backward and,
// in its saved-P form, #10's, in attn_block_staged.cu, and #8's window MHSA
// backward, in window_attention.cu) and #12's cos_attn_bwd_tc_kernel
// (fused_block_v2.cu).
//
// A block takes the N keys of a window and its query rows in blocks of RB,
// 16 a row tile, KS warps a row tile. In S = q k^T and dP = dA v^T warp w
// takes row tile w / KS and part w % KS of the keys (N / KS of them), the
// scores staying in its accumulator fragments; the KS parts of a row
// exchange their row max and sums through shared memory and add them in
// part order. P, then dS, of the row block lies in a shared (RB, N + 4)
// tile: att = P v and dQ = dS k read it as A, warp w taking (row tile w /
// KS, channels 32 / KS * (w % KS)..); dV += P^T dA and dK += dS^T q read it
// transposed, warp w taking the (key tile, channel half) units w, w +
// warps, ..., whose sums a kernel carries across its row blocks. Rows of q,
// k, v and dA are padded with zeros to 32 channels, kHeadLd floats apart
// (36: the row fragments' loads hit 32 banks). #3 and #8 also take heads of
// 33 to 64 channels (ATD's 35): their kernels' HD template parameter pads
// the rows to 64 channels, head_ld(64) = 68 floats apart (again 4 past a
// multiple of 32 banks), on plans of their own (attn_plan(n, 64)); the
// padded lanes are zeros in q, k, v and dA, so they add nothing to any
// product.
//
// The bf16 forms (attn_rows_fwd_bf16_kernel, with P as the bf16 training
// block's #4 stage and without it as #3's bf16 form and #1's bf16 stage;
// attn_rows_bwd_bf16_kernel, the saved-P backward of #5's stage;
// attn_rows_bwd_recompute_bf16_kernel, #8's bf16 form and, writing att too,
// #6's bf16 stage, which recompute P from the bias table;
// cos_attn_rows_fwd_bf16_kernel, #11's cosine stage in bf16) read and write
// bf16 rows and P and keep the same fp32 tiles in shared memory; each
// product runs on mma.sync m16n8k16 bf16 with fp32 sums (tc_gemm_bf16.cuh),
// its operands rounded to bf16 as their fragments load: the JAX kernel's
// bf16 P (softmax in fp32, then rounded) in att = P v and dV = P^T dA, and
// its bf16(scale dS) in dQ and dK, while rowsum(P dP) and dS take the fp32
// P. Heads of 30 pad to 32 channels: two k-steps.
#pragma once

#include <type_traits>

#include "tc_gemm.cuh"
#include "tc_gemm_bf16.cuh"

namespace trr {

constexpr int kHeadLd = 36;

// Floats between two staged head rows of HD (32 or 64) channels.
__host__ __device__ constexpr int head_ld(int HD) { return HD + 4; }

__host__ __device__ constexpr int attn_tc_threads(int RB, int KS = 2) {
  return 32 * KS * (RB / 16);
}

template <int N, int RB, int KS = 2, bool BF = false, int HD = 32>
struct AttnWarps {
  static constexpr int NTH = attn_tc_threads(RB, KS), NW = NTH / 32;
  static constexpr int LD = head_ld(HD), LP = N + 4, PART = N / KS, NT = PART / 8;
  static constexpr int CW = HD / KS, CT = CW / 8;  // output channels of a warp, in tiles of 8
  static constexpr int CU = HD / 16;               // 16-channel units of a key tile
  static constexpr int UNITS = CU * (N / 16) / NW;
  static_assert(HD == 32 || HD == 64, "rows of 32 or 64 channels");
  static_assert(RB % 16 == 0 && N % RB == 0 && PART % 8 == 0 && CW % 8 == 0,
                "the tiles must split evenly");
  static_assert(CU * (N / 16) == UNITS * NW, "dK and dV units must share out evenly");

  int warp, g, q4, row0, part, col0;

  __device__ AttnWarps()
      : warp(threadIdx.x / 32),
        g(threadIdx.x % 32 / 4),
        q4(threadIdx.x % 4),
        row0(16 * (warp / KS)),
        part(warp % KS),
        col0(part * PART) {}

  // Element (i, two columns from s_col(j)) of this warp's S / dP fragments:
  // p[j][2 i + c] is (row s_row(i), column s_col(j) + c) of the row block.
  __device__ int s_row(int i) const { return row0 + g + 8 * i; }
  __device__ int s_col(int j) const { return col0 + 8 * j + 2 * q4; }
  // Element e of tile j of this warp's (row tile, CW channels) output.
  __device__ int o_row(int e) const { return row0 + g + 8 * (e / 2); }
  __device__ int o_chan(int j, int e) const { return CW * part + 8 * j + 2 * q4 + e % 2; }
  // Element e of tile j of this warp's dV / dK unit u.
  __device__ int u_key(int u, int e) const { return 16 * ((warp + NW * u) / CU) + g + 8 * (e / 2); }
  __device__ int u_chan(int u, int j, int e) const {
    return 16 * ((warp + NW * u) % CU) + 8 * j + 2 * q4 + e % 2;
  }

  // o = Y X^T for this warp's rows and part of the keys, over the HD
  // channels: Y the (RB, LD) rows (q or dA), X the (N, LD) rows (k or v).
  // With four or eight parts (16 warps, 128 registers a thread), and at 64
  // channels, the channel steps stay a loop: unrolled, ptxas spilled at n
  // 256 (and, in bf16, at n 128 with 64 channels).
  __device__ void rows_by_channels(const float* Y, const float* X, float (&o)[NT][4]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    if constexpr (BF) {
#pragma unroll(HD == 64 ? 1 : 2)
      for (int k0 = 0; k0 < HD; k0 += 16) {
        MmaABf a;
        mma_load_a_bf16<false>(a, Y + row0 * LD + k0, LD);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma1_bf16<true>(o[j], a, X + (col0 + 8 * j) * LD + k0, LD);
      }
    } else {
#pragma unroll(KS >= 4 || HD == 64 ? 1 : 4)
      for (int k0 = 0; k0 < HD; k0 += 8) {
        MmaA a;
        mma_load_a<false>(a, Y + row0 * LD + k0, LD);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma3<true>(o[j], a, X + (col0 + 8 * j) * LD + k0, LD);
      }
    }
  }

  // o = pt X for this warp's (row tile, CW channels) over the N keys: pt
  // the (RB, LP) P / dS tile, X the (N, LD) rows (v or k).
  __device__ void rows_by_keys(const float* pt, const float* X, float (&o)[CT][4]) const {
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    if constexpr (BF) {
#pragma unroll 1
      for (int k0 = 0; k0 < N; k0 += 16) {
        MmaABf a;
        mma_load_a_bf16<false>(a, pt + row0 * LP + k0, LP);
#pragma unroll
        for (int j = 0; j < CT; ++j) mma1_bf16<false>(o[j], a, X + k0 * LD + CW * part + 8 * j, LD);
      }
    } else {
#pragma unroll 1
      for (int k0 = 0; k0 < N; k0 += 8) {
        MmaA a;
        mma_load_a<false>(a, pt + row0 * LP + k0, LP);
#pragma unroll
        for (int j = 0; j < CT; ++j) mma3<false>(o[j], a, X + k0 * LD + CW * part + 8 * j, LD);
      }
    }
  }

  // acc[u] += pt^T Y for this warp's (key tile, 16 channels) units over the
  // RB rows of the block: Y the (RB, LD) rows (dA or q).
  __device__ void keys_by_rows(const float* pt, const float* Y, float (&acc)[UNITS][2][4]) const {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int unit = warp + NW * u, kt = unit / CU, ch = unit % CU;
      if constexpr (BF) {
#pragma unroll(HD == 64 ? 1 : 2)
        for (int k0 = 0; k0 < RB; k0 += 16) {
          MmaABf a;
          mma_load_a_bf16<true>(a, pt + k0 * LP + 16 * kt, LP);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma1_bf16<false>(acc[u][j], a, Y + k0 * LD + 16 * ch + 8 * j, LD);
        }
      } else {
#pragma unroll(HD == 64 ? 1 : 2)
        for (int k0 = 0; k0 < RB; k0 += 8) {
          MmaA a;
          mma_load_a<true>(a, pt + k0 * LP + 16 * kt, LP);
#pragma unroll
          for (int j = 0; j < 2; ++j) mma3<false>(acc[u][j], a, Y + k0 * LD + 16 * ch + 8 * j, LD);
        }
      }
    }
  }

  // v[i] (row s_row(i), this thread's share) becomes the row's max (is_max)
  // or sum over all KS parts of the keys, the parts combined in order
  // through buf (KS * RB floats). Holds a block barrier.
  __device__ void row_total(float* buf, float (&v)[2], bool is_max) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v[i], o);
        v[i] = is_max ? fmaxf(v[i], w) : v[i] + w;
      }
      if (q4 == 0) buf[part * RB + s_row(i)] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float a = buf[s_row(i)];
#pragma unroll
      for (int k = 1; k < KS; ++k) {
        const float c = buf[k * RB + s_row(i)];
        a = is_max ? fmaxf(a, c) : a + c;
      }
      v[i] = a;
    }
  }

  // The two floats of pt at this thread's fragment element (i, j).
  __device__ float2* at(float* pt, int i, int j) const {
    return reinterpret_cast<float2*>(pt + s_row(i) * LP + s_col(j));
  }

  // P = softmax(q k^T * scale + bias) of the row block, the bias rows staged
  // in pt: S in this warp's fragments, the key parts' row max and sums
  // combined through red (2 KS RB floats), P written over the bias rows.
  // Holds block barriers; P is whole after the caller's next one.
  __device__ void softmax_rows(const float* qs, const float* ks, float* pt, float* red,
                               float scale) const {
    float p[NT][4];
    rows_by_channels(qs, ks, p);
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 bb = *at(pt, i, j);
        p[j][2 * i] = p[j][2 * i] * scale + bb.x;
        p[j][2 * i + 1] = p[j][2 * i + 1] * scale + bb.y;
        m[i] = fmaxf(m[i], fmaxf(p[j][2 * i], p[j][2 * i + 1]));
      }
    row_total(red, m, true);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = expf(p[j][e] - m[e / 2]);
        sum[e / 2] += p[j][e];
      }
    row_total(red + KS * RB, sum, false);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.f / sum[i];
        *at(pt, i, j) = make_float2(p[j][2 * i] * inv, p[j][2 * i + 1] * inv);
      }
  }
};

// dst[r * head_ld(HD) + d] = row(r)[d] for d < hd, else 0, for the ROWS
// rows of HD (32 or 64) channels (NTH threads; each thread's loads issued
// before its stores; HD / 32 warps hold a row at each step, a channel a
// lane; scalar loads, so a head may start at any element of its token's
// row; at HD 64 in batches of 8 elements a thread, which keeps the loads'
// addresses out of the way of the registers the kernels hold). NORM,
// SwinV2's cosine attention (HD 32): each row divided by
// max(|row|, 1e-12), its L2 norm over hd (the JAX package's _norm_rows,
// torch's F.normalize; the zero padding adds nothing), and, where inv is
// not null, the inverse norm to inv[r].
template <int ROWS, int NTH, bool NORM = false, int HD = 32, class Row>
__device__ __forceinline__ void stage_head_rows(float* dst, int hd, Row row,
                                                float* inv = nullptr) {  // row(r): float or bf16
  static_assert(ROWS * HD % NTH == 0 && NTH % 32 == 0, "the rows must split evenly");
  static_assert(!NORM || HD == 32, "the cosine rows are a warp each");
  constexpr int PER = ROWS * HD / NTH, CH = HD == 64 && PER > 8 ? 8 : PER;
#pragma unroll 1  // a batch's loads are not hoisted above the last batch's stores
  for (int i0 = 0; i0 < PER; i0 += CH) {
    float v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + (i0 + i) * NTH, d = e % HD;
      v[i] = d < hd ? ldg_f(row(e / HD) + d) : 0.f;
    }
    if constexpr (NORM) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float iv = 1.f / fmaxf(sqrtf(warp_sum(v[i] * v[i])), 1e-12f);
        v[i] *= iv;
        if (inv != nullptr && threadIdx.x % 32 == 0) inv[(threadIdx.x + (i0 + i) * NTH) / 32] = iv;
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + (i0 + i) * NTH;
      dst[(e / HD) * head_ld(HD) + e % HD] = v[i];
    }
  }
}

// The ROWS x N rows of the table at src (row stride N; fp32, or a bf16 P)
// into the (ROWS, N + 4) fp32 tile pt, 4 entries a copy (NTH threads).
template <int ROWS, int N, int NTH, typename T>
__device__ __forceinline__ void stage_table_rows(float* pt, const T* __restrict__ src) {
  constexpr int Q = N / 4;
  static_assert(N % 4 == 0, "rows of 4-entry pieces");
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * Q; e += NTH)
    reinterpret_cast<float4*>(pt + (e / Q) * (N + 4))[e % Q] =
        ldg4(src + (size_t)(e / Q) * N + 4 * (e % Q));
}

// The (ROWS, N + 4) tile pt to the ROWS x N rows at dst (row stride N; fp32,
// or bf16, rounded), 4 entries a copy (NTH threads).
template <int ROWS, int N, int NTH, typename T>
__device__ __forceinline__ void store_table_rows(T* __restrict__ dst, const float* pt) {
  constexpr int Q = N / 4;
  static_assert(N % 4 == 0, "rows of 4-entry pieces");
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * Q; e += NTH)
    st4(dst + (size_t)(e / Q) * N + 4 * (e % Q),
        reinterpret_cast<const float4*>(pt + (e / Q) * (N + 4))[e % Q]);
}

// row(r)[d] = src[r * head_ld(HD) + d] for d < hd, for the ROWS rows of HD
// channels (NTH threads; HD / 32 warps write a row's hd entries at once,
// scalar stores at any offset; row(r) float or bf16).
template <int ROWS, int NTH, int HD = 32, class Row>
__device__ __forceinline__ void store_head_rows(const float* src, int hd, Row row) {
  static_assert(ROWS * HD % NTH == 0, "the rows must split evenly");
#pragma unroll 4
  for (int i = 0; i < ROWS * HD / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, d = e % HD;
    if (d < hd) st_f(row(e / HD) + d, src[(e / HD) * head_ld(HD) + d]);
  }
}

// Index (into the B*H*W tokens) of token r, row-major, of the wr x wc window
// (wi, wj) of sample b on the map rolled by (-shift, -shift).
__device__ __forceinline__ long long roll_token(int b, int wi, int wj, int r, int H, int W,
                                                int wr, int wc, int shift) {
  int y = wi * wr + r / wc + shift, x = wj * wc + r % wc + shift;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
  return ((long long)b * H + y) * W + x;
}

// Shared memory of attn_rows_fwd_tc_kernel<N, RB, KS, COS, HD>, in floats:
// k and v (N, head_ld(HD)), this row block's q and att rows (RB,
// head_ld(HD)), the P rows (RB, N + 4), two (KS, RB) exchanges of the key
// parts' row max and row sum, and the window's N token indices.
__host__ __device__ constexpr int attn_rows_fwd_tc_smem_floats(int N, int RB, int KS,
                                                               int HD = 32) {
  return 2 * N * head_ld(HD) + 2 * RB * head_ld(HD) + RB * (N + 4) + 2 * KS * RB + N;
}

// Blocks a SM of the forward: three at n 64 (55,552 B of shared memory
// each; 85 registers a thread), two of at most 8 warps (n 144: 85,056 B;
// n 128: 64,512 B), else one (n 256: 16 warps, 161,792 B; two would cap a
// thread at 64 registers). Rows of 64 channels: two at n 64 (88,320 B),
// else one of 8 warps, whose threads may hold up to 255 registers (n 128:
// 105,472 B; n 256: 192,000 B).
__host__ __device__ constexpr int attn_fwd_blocks(int N, int threads, int HD = 32) {
  return HD == 64 ? (N <= 64 ? 2 : 1) : N <= 64 ? 3 : threads <= 256 ? 2 : 1;
}

// Blocks a SM of the backward: two of at most 8 warps, else one; rows of 64
// channels past n 64 one (their dK units take a thread past 128 registers).
__host__ __device__ constexpr int attn_bwd_blocks(int N, int threads, int HD = 32) {
  return HD == 64 && N > 64 ? 1 : threads <= 256 ? 2 : 1;
}

// One block per (wr x wc window of the map rolled by (-shift, -shift),
// head), N = wr * wc; the query rows in blocks of RB, KS warps a 16-row
// tile. From qkv (T, 3C) and the kind table (kinds, nh, N, N), in x's
// frame: writes this head's attention output softmax(q k^T scale + bias) v
// into att (T, C), in x's frame, and, when P is not null, the softmax into
// P (B, H/wr, W/wc, nh, N, N), in the rolled frame. Two products a row
// block on mma.sync in 3xTF32, laid out as attn_rows_bwd_tc_kernel's first
// two: S = q k^T and the row softmax in the fragments (the row block's bias
// rows staged in the shared tile first), P to the tile and from there to P
// in 16-byte rows, att = P v out through shared memory a head row at a
// time. Heads are the grid's fastest index, as in the backward: each
// token's 3C row is read once while it stays in L2. The grid is one-
// dimensional, (sample, window, head) with the head fastest, so a map of
// any number of windows fits it. COS, SwinV2's cosine attention (#11, #12's
// forward stage): the rows of k and q are divided by their L2 norm as they
// are staged (stage_head_rows' NORM), and the temperature is the head's,
// temps[h] (already exponentiated), in place of `scale`. T: the type of
// qkv, att and P (float, or bf16 in attn_rows_fwd_bf16_kernel). SP false:
// no P is stored whatever `P` holds (#3's bf16 form, a template flag: no
// test of a null pointer in the row loop). HD: the staged rows' channels,
// 32, or 64 for #3's heads of 33 to 64 channels.
template <int N, int RB, int KS, bool COS, typename T, bool SP = true, int HD = 32>
__device__ __forceinline__ void attn_rows_fwd_body(const T* __restrict__ qkv,
                                                   const float* __restrict__ bias,
                                                   T* __restrict__ att, T* __restrict__ P, int H,
                                                   int W, int C, int nh, int wr, int wc, int kinds,
                                                   int shift, float scale,
                                                   const float* __restrict__ temps) {
  using AW = AttnWarps<N, RB, KS, std::is_same<T, bf16>::value, HD>;
  constexpr int NTH = AW::NTH, LD = AW::LD, CT = AW::CT;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / wc, nwh = H / wr;
  const int h = (int)(blockIdx.x % nh), win = (int)(blockIdx.x / nh % (nwh * nww));
  const int b = (int)(blockIdx.x / nh / (nwh * nww));
  const int wi = win / nww, wj = win % nww;
  const AW aw;
  float* ks = smem;              // (N, LD) k, zero past hd
  float* vs = ks + N * LD;       // (N, LD) v
  float* qs = vs + N * LD;       // (RB, LD) this row block's q
  float* oa = qs + RB * LD;      // (RB, LD) its att
  float* pt = oa + RB * LD;      // (RB, LP): the bias rows, then P
  float* red = pt + RB * AW::LP;  // (2, KS, RB): each part's row max and row sum
  int* tok = reinterpret_cast<int*>(red + 2 * KS * RB);  // (N) the window's tokens
  for (int r = threadIdx.x; r < N; r += NTH)
    tok[r] = (int)roll_token(b, wi, wj, r, H, W, wr, wc, shift);
  const float* table = bias + ((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * N * N;
  const size_t head = (size_t)blockIdx.x * N * N;  // (b, win, h) of P, in the grid's order
  if constexpr (COS) scale = __ldg(temps + h);
  __syncthreads();
  stage_head_rows<N, NTH, COS, HD>(
      ks, hd, [&](int r) { return qkv + (long long)tok[r] * C3 + C + h * hd; });
  stage_head_rows<N, NTH, false, HD>(
      vs, hd, [&](int r) { return qkv + (long long)tok[r] * C3 + 2 * C + h * hd; });
  for (int r0 = 0; r0 < N; r0 += RB) {
    const int* rt = tok + r0;  // this row block's tokens
    stage_head_rows<RB, NTH, COS, HD>(
        qs, hd, [&](int r) { return qkv + (long long)rt[r] * C3 + h * hd; });
    stage_table_rows<RB, N, NTH>(pt, table + (size_t)r0 * N);  // the bias rows, for S
    __syncthreads();  // q and the bias rows (and, the first time, k and v) staged
    aw.softmax_rows(qs, ks, pt, red, scale);
    __syncthreads();  // P is whole
    if (SP && P != nullptr) store_table_rows<RB, N, NTH>(P + head + (size_t)r0 * N, pt);
    float o[CT][4];
    aw.rows_by_keys(pt, vs, o);  // att = P v
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[aw.o_row(e) * LD + aw.o_chan(j, e)] = o[j][e];
    __syncthreads();  // att whole; q and the tile are rewritten by the next row block
    store_head_rows<RB, NTH, HD>(oa, hd,
                                 [&](int r) { return att + (long long)rt[r] * C + h * hd; });
  }
}

template <int N, int RB, int KS, bool COS = false, int HD = 32>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  attn_fwd_blocks(N, attn_tc_threads(RB, KS), HD))
    attn_rows_fwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                            float* __restrict__ att, float* __restrict__ P, int H, int W, int C,
                            int nh, int wr, int wc, int kinds, int shift, float scale,
                            const float* __restrict__ temps) {
  attn_rows_fwd_body<N, RB, KS, COS, float, true, HD>(qkv, bias, att, P, H, W, C, nh, wr, wc,
                                                      kinds, shift, scale, temps);
}

// The bf16 form: qkv, att and P in bf16; SP false, #3's: no P.
template <int N, int RB, int KS, bool SP = true, int HD = 32>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  attn_fwd_blocks(N, attn_tc_threads(RB, KS), HD))
    attn_rows_fwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                              bf16* __restrict__ att, bf16* __restrict__ P, int H, int W, int C,
                              int nh, int wr, int wc, int kinds, int shift, float scale) {
  attn_rows_fwd_body<N, RB, KS, false, bf16, SP, HD>(qkv, bias, att, P, H, W, C, nh, wr, wc,
                                                     kinds, shift, scale, nullptr);
}

// The bf16 cosine form (#11's bf16 stage and #12's bf16 forward stage):
// qkv and att in bf16, no P; the rows of q and k normalised in fp32 as they
// are staged and rounded to bf16 as the score product's fragments load (the
// JAX kernel's bf16(q^) bf16(k^)^T), the head's temperature temps[h].
template <int N, int RB, int KS>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  attn_fwd_blocks(N, attn_tc_threads(RB, KS)))
    cos_attn_rows_fwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                  bf16* __restrict__ att, int H, int W, int C, int nh, int wr,
                                  int wc, int kinds, int shift, const float* __restrict__ temps) {
  attn_rows_fwd_body<N, RB, KS, true, bf16, false>(qkv, bias, att, nullptr, H, W, C, nh, wr, wc,
                                                   kinds, shift, 0.f, temps);
}

// Shared memory of attn_rows_bwd_tc_kernel<N, RB, KS, ATT, SAVED, HD>, in
// floats: k and v (N, head_ld(HD)), this row block's q and dA (RB,
// head_ld(HD)), the P / dS rows (RB, N + 4), the (KS, RB) exchanges of the
// key parts' row max and row sum (not SAVED) and rowsum(P dP), its att (ATT)
// and dq rows (RB, head_ld(HD)) on their way out, and the window's N token
// indices.
__host__ __device__ constexpr int attn_rows_bwd_tc_smem_floats(int N, int RB, int KS, bool ATT,
                                                               bool SAVED = false, int HD = 32) {
  return 2 * N * head_ld(HD) + (ATT ? 4 : 3) * RB * head_ld(HD) + RB * (N + 4) +
         (SAVED ? 1 : 3) * KS * RB + N;
}

// One block per (wr x wc window of the map rolled by (-shift, -shift),
// head), N = wr * wc; the query rows in blocks of RB, KS warps a 16-row
// tile. From qkv (T, 3C), the kind table (kinds, nh, N, N) and datt (T, C),
// in x's frame: writes this head's dq | dk | dv into dqkv (T, 3C), with ATT
// its attention output P v into att (T, C) (#6's dwp needs it), and dS into
// a buffer (B, H/wr, W/wc, nh, N, N) for the bias-kind reduction. Five
// products a row block (six with ATT) on mma.sync in 3xTF32, as AttnWarps
// lays them out: S = q k^T and the row softmax in the fragments (the row
// block's bias rows staged in the shared tile first), P to the tile, [att =
// P v,] dV += P^T dA, dP = dA v^T, dS = P (dP - rowsum(P dP)) in place of P,
// dQ = scale dS k, dK += dS^T q; dK and dV in registers across the row
// blocks, scaled at the end. The window's token indices are computed once,
// into shared memory, and every output goes out through shared memory a
// head row (hd floats) at a time: stores from the fragments would write 4
// bytes to each of 8 rows. The heads are the grid's fastest index: a
// window's heads run together, so each token's 3C row is read once and
// written whole while it stays in L2. Plans (N, RB, KS): (256, 64, 4) with
// 16 warps and one block a SM; (144, 48, 2), (128, 32, 4) and (64, 64, 2)
// with two blocks a SM.
//
// SAVED, #10's saved-P backward: `table` is the forward's softmax P (B,
// H/wr, W/wc, nh, N, N) in the rolled frame, which attn_rows_fwd_tc_kernel
// wrote at the (sample, window, head) index that dS takes here. Each row
// block's P rows are staged into the tile in place of the bias rows, and S
// and the softmax go: four products a row block (dV += P^T dA, dP = dA v^T,
// dQ = scale dS k, dK += dS^T q), the key parts exchanging rowsum(P dP)
// only. It writes no att (ATT is false): #10's dwp reads the forward's.
//
// T: the type of qkv, datt, dqkv, att and a saved P (float, or bf16 in
// attn_rows_bwd_bf16_kernel, where the tile holds bf16(scale dS), as the JAX
// kernel rounds it, and dS still goes out unscaled in fp32). HD: the staged
// rows' channels, 32, or 64 for #8's heads of 33 to 64 channels. At 64,
// where a thread would hold more than two 16-channel units each of dK and
// dV (n 128 and 256: eight, 64 floats each beside S and dP), dV takes a
// pass of its own over the row blocks first (S, the softmax, dV += P^T dA,
// dV out from its fragments), and the pass above then leaves dV out: one
// more S = q k^T and softmax a row block.
template <int N, int RB, int KS, bool ATT, bool SAVED, typename T, int HD = 32>
__device__ __forceinline__ void attn_rows_bwd_body(
    const T* __restrict__ qkv, const std::conditional_t<SAVED, T, float>* __restrict__ table,
    const T* __restrict__ datt, T* __restrict__ dqkv, T* __restrict__ att,
    float* __restrict__ dS, int H, int W, int C, int nh, int wr, int wc, int kinds, int shift,
    float scale) {
  static_assert(!(ATT && SAVED), "the saved-P form writes no att");
  constexpr bool BF = std::is_same<T, bf16>::value;
  using AW = AttnWarps<N, RB, KS, BF, HD>;
  constexpr int NTH = AW::NTH, LD = AW::LD, LP = AW::LP, NT = AW::NT, CT = AW::CT;
  constexpr int UNITS = AW::UNITS, X = KS * RB, EX = SAVED ? 1 : 3;
  constexpr bool SPLIT = HD == 64 && UNITS > 2;  // dV in a pass of its own
  static_assert(!SPLIT || !(ATT || SAVED), "the dV pass is #8's alone");
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / wc, nwh = H / wr;
  const int wi = blockIdx.y / nww, wj = blockIdx.y % nww, h = blockIdx.x;
  const AW aw;
  float* ks = smem;              // (N, LD) k, zero past hd
  float* vs = ks + N * LD;       // (N, LD) v
  float* qs = vs + N * LD;       // (RB, LD) this row block's q
  float* das = qs + RB * LD;     // (RB, LD) its datt
  float* pt = das + RB * LD;     // (RB, LP): P, then dS
  float* red = pt + RB * LP;     // (EX, KS, RB): each part's [row max, row sum,] rowsum(P dP)
  float* oq = red + EX * X;      // (RB, LD) this row block's dq
  float* oa = oq + RB * LD;      // (RB, LD) its att (ATT only)
  int* tok = reinterpret_cast<int*>(oa + (ATT ? RB * LD : 0));  // (N) the window's tokens
  for (int r = threadIdx.x; r < N; r += NTH)
    tok[r] = (int)roll_token(blockIdx.z, wi, wj, r, H, W, wr, wc, shift);
  // the (N, N) rows staged a row block at a time: the bias kind's, or P's
  const auto* tile_src =
      table + (SAVED ? 0 : ((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * N * N);
  // (b, win, h) of dS, and of P: the forward's one-dimensional grid order
  const size_t head = (((size_t)blockIdx.z * nwh * nww + blockIdx.y) * nh + h) * N * N;
  if constexpr (SAVED) tile_src += head;
  __syncthreads();
  stage_head_rows<N, NTH, false, HD>(
      ks, hd, [&](int r) { return qkv + (long long)tok[r] * C3 + C + h * hd; });
  stage_head_rows<N, NTH, false, HD>(
      vs, hd, [&](int r) { return qkv + (long long)tok[r] * C3 + 2 * C + h * hd; });
  if constexpr (SPLIT) {  // dV += P^T dA over the row blocks, then out from the fragments
    float dv0[UNITS][2][4];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv0[u][j][e] = 0.f;
    for (int r0 = 0; r0 < N; r0 += RB) {
      const int* rt = tok + r0;
      stage_head_rows<RB, NTH, false, HD>(
          qs, hd, [&](int r) { return qkv + (long long)rt[r] * C3 + h * hd; });
      stage_head_rows<RB, NTH, false, HD>(
          das, hd, [&](int r) { return datt + (long long)rt[r] * C + h * hd; });
      stage_table_rows<RB, N, NTH>(pt, tile_src + (size_t)r0 * N);
      __syncthreads();  // q, dA and the bias rows (and, the first time, k and v) staged
      aw.softmax_rows(qs, ks, pt, red, scale);
      __syncthreads();  // P is whole
      aw.keys_by_rows(pt, das, dv0);
      __syncthreads();  // q, dA and the tile are rewritten by the next row block
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = aw.u_chan(u, j, e);
          if (d < hd)
            st_f(dqkv + (long long)tok[aw.u_key(u, e)] * C3 + 2 * C + h * hd + d, dv0[u][j][e]);
        }
  }
  float dk[UNITS][2][4], dv[SPLIT ? 1 : UNITS][2][4];
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[u][j][e] = 0.f;
  if constexpr (!SPLIT) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[u][j][e] = 0.f;
  }

  for (int r0 = 0; r0 < N; r0 += RB) {
    const int* rt = tok + r0;  // this row block's tokens
    stage_head_rows<RB, NTH, false, HD>(
        qs, hd, [&](int r) { return qkv + (long long)rt[r] * C3 + h * hd; });
    stage_head_rows<RB, NTH, false, HD>(
        das, hd, [&](int r) { return datt + (long long)rt[r] * C + h * hd; });
    stage_table_rows<RB, N, NTH>(pt, tile_src + (size_t)r0 * N);  // the bias rows for S, or P
    __syncthreads();  // q, dA and the tile's rows (and, the first time, k and v) staged
    if constexpr (!SAVED) {
      aw.softmax_rows(qs, ks, pt, red, scale);  // S, the softmax, P to the tile
      __syncthreads();  // P is whole
    }
    if constexpr (ATT) {  // att = P v (the forward's output, for dwp)
      float o[CT][4];
      aw.rows_by_keys(pt, vs, o);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[aw.o_row(e) * LD + aw.o_chan(j, e)] = o[j][e];
    }
    if constexpr (!SPLIT) aw.keys_by_rows(pt, das, dv);  // dV += P^T dA
    {  // dP = dA v^T, then dS = P (dP - rowsum(P dP)) in place of P, read back
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
      aw.row_total(red + (EX - 1) * X, delta, false);  // its barrier: every warp is done reading P
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 pv = *aw.at(pt, i, j);
          const float2 v = make_float2(pv.x * (dp[j][2 * i] - delta[i]),
                                       pv.y * (dp[j][2 * i + 1] - delta[i]));
          *aw.at(pt, i, j) = BF ? make_float2(scale * v.x, scale * v.y) : v;
          *reinterpret_cast<float2*>(dS + head + (size_t)(r0 + aw.s_row(i)) * N + aw.s_col(j)) =
              v;
        }
    }
    __syncthreads();  // dS is whole
    {  // dQ = scale dS k
      float o[CT][4];
      aw.rows_by_keys(pt, ks, o);
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oq[aw.o_row(e) * LD + aw.o_chan(j, e)] = (BF ? 1.f : scale) * o[j][e];
    }
    aw.keys_by_rows(pt, qs, dk);  // dK += dS^T q (scaled once, at the end)
    __syncthreads();  // q, dA and the tile are rewritten by the next row block; dq (att) whole
    if constexpr (ATT)
      store_head_rows<RB, NTH, HD>(oa, hd,
                                   [&](int r) { return att + (long long)rt[r] * C + h * hd; });
    store_head_rows<RB, NTH, HD>(oq, hd,
                                 [&](int r) { return dqkv + (long long)rt[r] * C3 + h * hd; });
  }
  // dK and dV to the rooms of k and v, then out
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = aw.u_key(u, e) * LD + aw.u_chan(u, j, e);
        ks[i] = (BF ? 1.f : scale) * dk[u][j][e];
        if constexpr (!SPLIT) vs[i] = dv[u][j][e];
      }
  __syncthreads();
  store_head_rows<N, NTH, HD>(ks, hd,
                              [&](int r) { return dqkv + (long long)tok[r] * C3 + C + h * hd; });
  if constexpr (!SPLIT)
    store_head_rows<N, NTH, HD>(
        vs, hd, [&](int r) { return dqkv + (long long)tok[r] * C3 + 2 * C + h * hd; });
}

template <int N, int RB, int KS, bool ATT, bool SAVED = false, int HD = 32>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  attn_bwd_blocks(N, attn_tc_threads(RB, KS), HD))
    attn_rows_bwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ table,
                            const float* __restrict__ datt, float* __restrict__ dqkv,
                            float* __restrict__ att, float* __restrict__ dS, int H, int W, int C,
                            int nh, int wr, int wc, int kinds, int shift, float scale) {
  attn_rows_bwd_body<N, RB, KS, ATT, SAVED, float, HD>(qkv, table, datt, dqkv, att, dS, H, W, C,
                                                       nh, wr, wc, kinds, shift, scale);
}

// The bf16 form of the saved-P backward: qkv, P, datt and dqkv in bf16.
template <int N, int RB, int KS>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS), attn_tc_threads(RB, KS) <= 256 ? 2 : 1)
    attn_rows_bwd_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ P,
                              const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                              float* __restrict__ dS, int H, int W, int C, int nh, int wr, int wc,
                              int kinds, int shift, float scale) {
  attn_rows_bwd_body<N, RB, KS, false, true, bf16>(qkv, P, datt, dqkv, nullptr, dS, H, W, C, nh,
                                                   wr, wc, kinds, shift, scale);
}

// The bf16 recompute backward: qkv, datt and dqkv in bf16, the kind table
// and dS in fp32. P is recomputed in fp32 from q, k and the table; dV takes
// bf16(P), dS the fp32 P. ATT false, #8's bf16 form; ATT true, #6's bf16
// stage: att = bf16(bf16(P) v) into att (T, C) as well, for its dwp. With
// ATT one block a SM: the att product's fragments take the (144, 48, 2)
// plan past the 168 registers a thread that two blocks of 192 threads
// leave (ptxas spilled 40 bytes there).
template <int N, int RB, int KS, bool ATT, int HD = 32>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  ATT ? 1 : attn_bwd_blocks(N, attn_tc_threads(RB, KS), HD))
    attn_rows_bwd_recompute_bf16_kernel(const bf16* __restrict__ qkv,
                                        const float* __restrict__ bias,
                                        const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                                        bf16* __restrict__ att, float* __restrict__ dS, int H,
                                        int W, int C, int nh, int wr, int wc, int kinds,
                                        int shift, float scale) {
  attn_rows_bwd_body<N, RB, KS, ATT, false, bf16, HD>(qkv, bias, datt, dqkv, att, dS, H, W, C,
                                                      nh, wr, wc, kinds, shift, scale);
}

// The plan (N, RB, KS) of a window of n tokens, as attn_rows_bwd_tc_kernel
// takes it: four key parts a row tile at n 256 (rows of 64, 16 warps: a
// thread's S fragments stay at 32 floats) and n 128 (rows of 32, 8 warps;
// rows of 64 in two parts spilled at 128 registers), two parts at n 144
// (rows of 48) and 64 (rows of 64); {0, 0} for another n. Rows of 64
// channels (hd 64, #3 and #8 only): at n 256 rows of 32 in four key parts
// (8 warps: rows of 64 need 243,712 B of shared memory in the forward, past
// a block's 232,448), one block a SM whose threads may hold 255 registers
// (a thread of 16 warps, at most 128, spilled); n 128 and 64 keep their
// plans.
struct AttnPlan {
  int rb, ks;
};
__host__ __device__ constexpr AttnPlan attn_plan(int n, int hd = 32) {
  return n == 256   ? (hd == 64 ? AttnPlan{32, 4} : AttnPlan{64, 4})
         : n == 144 ? AttnPlan{48, 2}
         : n == 128 ? AttnPlan{32, 4}
         : n == 64  ? AttnPlan{64, 2}
                    : AttnPlan{0, 0};
}

// attn_rows_fwd_tc_kernel at windows of N tokens and rows of HD channels;
// COS, the cosine form, with the heads' temperatures `temps` (nh).
template <int N, bool COS = false, int HD = 32>
cudaError_t attn_rows_fwd_tc(const float* qkv, const float* bias, float* att, float* P, int B,
                             int H, int W, int C, int nh, int wr, int wc, int kinds, int shift,
                             float scale, cudaStream_t stream, const float* temps = nullptr) {
  constexpr AttnPlan plan = attn_plan(N, HD);
  constexpr int floats = attn_rows_fwd_tc_smem_floats(N, plan.rb, plan.ks, HD);
  const cudaError_t err =
      set_smem(attn_rows_fwd_tc_kernel<N, plan.rb, plan.ks, COS, HD>, floats);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)B * (unsigned)((H / wr) * (W / wc)) * (unsigned)nh;
  attn_rows_fwd_tc_kernel<N, plan.rb, plan.ks, COS, HD>
      <<<blocks, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, bias, att, P, H, W, C, nh, wr, wc, kinds, shift, scale, temps);
  return cudaGetLastError();
}

// attn_rows_bwd_tc_kernel at windows of N tokens and rows of HD channels;
// `table` the kind table, or, SAVED, the forward's P.
template <int N, bool ATT, bool SAVED = false, int HD = 32>
cudaError_t attn_rows_bwd_tc(const float* qkv, const float* table, const float* datt, float* dqkv,
                             float* att, float* dS, int B, int H, int W, int C, int nh, int wr,
                             int wc, int kinds, int shift, float scale, cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N, HD);
  constexpr int floats = attn_rows_bwd_tc_smem_floats(N, plan.rb, plan.ks, ATT, SAVED, HD);
  const cudaError_t err =
      set_smem(attn_rows_bwd_tc_kernel<N, plan.rb, plan.ks, ATT, SAVED, HD>, floats);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, (H / wr) * (W / wc), B);
  attn_rows_bwd_tc_kernel<N, plan.rb, plan.ks, ATT, SAVED, HD>
      <<<grid, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, table, datt, dqkv, att, dS, H, W, C, nh, wr, wc, kinds, shift, scale);
  return cudaGetLastError();
}

// attn_rows_fwd_bf16_kernel at windows of N tokens and rows of HD
// channels; SP false: no P.
template <int N, bool SP = true, int HD = 32>
cudaError_t attn_rows_fwd_bf16(const bf16* qkv, const float* bias, bf16* att, bf16* P, int B,
                               int H, int W, int C, int nh, int wr, int wc, int kinds, int shift,
                               float scale, cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N, HD);
  constexpr int floats = attn_rows_fwd_tc_smem_floats(N, plan.rb, plan.ks, HD);
  const cudaError_t err =
      set_smem(attn_rows_fwd_bf16_kernel<N, plan.rb, plan.ks, SP, HD>, floats);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)B * (unsigned)((H / wr) * (W / wc)) * (unsigned)nh;
  attn_rows_fwd_bf16_kernel<N, plan.rb, plan.ks, SP, HD>
      <<<blocks, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, bias, att, P, H, W, C, nh, wr, wc, kinds, shift, scale);
  return cudaGetLastError();
}

// cos_attn_rows_fwd_bf16_kernel at windows of N tokens, the heads'
// temperatures `temps` (nh).
template <int N>
cudaError_t cos_attn_rows_fwd_bf16(const bf16* qkv, const float* bias, bf16* att, int B, int H,
                                   int W, int C, int nh, int wr, int wc, int kinds, int shift,
                                   const float* temps, cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N);
  constexpr int floats = attn_rows_fwd_tc_smem_floats(N, plan.rb, plan.ks);
  const cudaError_t err = set_smem(cos_attn_rows_fwd_bf16_kernel<N, plan.rb, plan.ks>, floats);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)B * (unsigned)((H / wr) * (W / wc)) * (unsigned)nh;
  cos_attn_rows_fwd_bf16_kernel<N, plan.rb, plan.ks>
      <<<blocks, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, bias, att, H, W, C, nh, wr, wc, kinds, shift, temps);
  return cudaGetLastError();
}

// attn_rows_bwd_recompute_bf16_kernel at windows of N tokens and rows of HD
// channels: ATT false, #8's bf16 form (att unused); ATT true, #6's bf16
// stage, writing att.
template <int N, bool ATT = false, int HD = 32>
cudaError_t attn_rows_bwd_recompute_bf16(const bf16* qkv, const float* bias, const bf16* datt,
                                         bf16* dqkv, bf16* att, float* dS, int B, int H, int W,
                                         int C, int nh, int wr, int wc, int kinds, int shift,
                                         float scale, cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N, HD);
  constexpr int floats = attn_rows_bwd_tc_smem_floats(N, plan.rb, plan.ks, ATT, false, HD);
  const cudaError_t err =
      set_smem(attn_rows_bwd_recompute_bf16_kernel<N, plan.rb, plan.ks, ATT, HD>, floats);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, (H / wr) * (W / wc), B);
  attn_rows_bwd_recompute_bf16_kernel<N, plan.rb, plan.ks, ATT, HD>
      <<<grid, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, bias, datt, dqkv, att, dS, H, W, C, nh, wr, wc, kinds, shift, scale);
  return cudaGetLastError();
}

// attn_rows_bwd_bf16_kernel (the saved-P backward) at windows of N tokens.
template <int N>
cudaError_t attn_rows_bwd_saved_bf16(const bf16* qkv, const bf16* P, const bf16* datt,
                                     bf16* dqkv, float* dS, int B, int H, int W, int C, int nh,
                                     int wr, int wc, int kinds, int shift, float scale,
                                     cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N);
  constexpr int floats = attn_rows_bwd_tc_smem_floats(N, plan.rb, plan.ks, false, true);
  const cudaError_t err = set_smem(attn_rows_bwd_bf16_kernel<N, plan.rb, plan.ks>, floats);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, (H / wr) * (W / wc), B);
  attn_rows_bwd_bf16_kernel<N, plan.rb, plan.ks>
      <<<grid, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, P, datt, dqkv, dS, H, W, C, nh, wr, wc, kinds, shift, scale);
  return cudaGetLastError();
}

}  // namespace trr
