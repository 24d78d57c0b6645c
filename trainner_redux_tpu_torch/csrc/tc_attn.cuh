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
// product. #8's 128-wide key pass stages whole heads of 65 to 128 channels
// the same way, padded to 128, head_ld(128) = 132 floats apart.
//
// The bf16 forms (attn_rows_fwd_bf16_kernel, with P as the bf16 training
// block's #4 stage and without it as #3's bf16 form; attn_rows_bwd_bf16_kernel,
// the saved-P backward of #5's stage; attn_rows_bwd_recompute_bf16_kernel,
// #8's bf16 form at heads of 33-64 channels, which recomputes P from the bias
// table (#1's and #6's bf16 stages and #8's bf16 form at heads of up to 32
// are attn_group_bf16.cuh's);
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

// Floats between two staged head rows of HD (32, 64 or 128) channels.
__host__ __device__ constexpr int head_ld(int HD) { return HD + 4; }

__host__ __device__ constexpr int attn_tc_threads(int RB, int KS = 2) {
  return 32 * KS * (RB / 16);
}

template <int N, int RB, int KS = 2, bool BF = false, int HD = 32>
struct AttnWarps {
  static constexpr int N_ = N, RB_ = RB;
  static constexpr int NTH = attn_tc_threads(RB, KS), NW = NTH / 32;
  static constexpr int LD = head_ld(HD), LP = N + 4, PART = N / KS, NT = PART / 8;
  static constexpr int CW = HD / KS, CT = CW / 8;  // output channels of a warp, in tiles of 8
  static constexpr int CU = HD / 16;               // 16-channel units of a key tile
  static constexpr int UNITS = CU * (N / 16) / NW;
  static_assert(HD == 32 || HD == 64 || HD == 128, "rows of 32, 64 or 128 channels");
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
  // channels: Y the (RB, LD) rows (q or dA), X the (N, LD) rows (k or v);
  // ACC: o += Y X^T (the 128-wide form's second 64-channel half). With four
  // or eight parts (16 warps, 128 registers a thread), and at 64 or 128
  // channels, the channel steps stay a loop: unrolled, ptxas spilled at n
  // 256 (and, in bf16, at n 128 with 64 channels).
  template <bool ACC = false>
  __device__ void rows_by_channels(const float* Y, const float* X, float (&o)[NT][4]) const {
    if constexpr (!ACC) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    }
    if constexpr (BF) {
#pragma unroll(HD >= 64 ? 1 : 2)
      for (int k0 = 0; k0 < HD; k0 += 16) {
        MmaABf a;
        mma_load_a_bf16<false>(a, Y + row0 * LD + k0, LD);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma1_bf16<true>(o[j], a, X + (col0 + 8 * j) * LD + k0, LD);
      }
    } else {
#pragma unroll(KS >= 4 || HD >= 64 ? 1 : 4)
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
#pragma unroll(HD >= 64 ? 1 : 2)
        for (int k0 = 0; k0 < RB; k0 += 16) {
          MmaABf a;
          mma_load_a_bf16<true>(a, pt + k0 * LP + 16 * kt, LP);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma1_bf16<false>(acc[u][j], a, Y + k0 * LD + 16 * ch + 8 * j, LD);
        }
      } else {
#pragma unroll(HD >= 64 ? 1 : 2)
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
    softmax_frags(p, pt, red, scale);
  }

  // softmax_rows from S already in this warp's fragments p (the 128-wide
  // form sums S over its two 64-channel halves first). STATS: each row's
  // max and inverse sum also to stats[row of the block] (the 128-wide #8's
  // row pass, from which its key pass recomputes P).
  template <bool STATS = false>
  __device__ void softmax_frags(float (&p)[NT][4], float* pt, float* red, float scale,
                                float2* stats = nullptr) const {
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
    if constexpr (STATS) {
      if (part == 0 && q4 == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) stats[s_row(i)] = make_float2(m[i], 1.f / sum[i]);
    }
  }
};

// dst[r * head_ld(HD) + d] = row(r)[d] for d < hd, else 0, for the ROWS
// rows of HD (32, 64 or 128) channels (NTH threads; each thread's loads issued
// before its stores; HD / 32 warps hold a row at each step, a channel a
// lane; scalar loads, so a head may start at any element of its token's
// row; at HD 64 and 128 in batches of BATCH (8) elements a thread, which
// keeps the loads' addresses out of the way of the registers the kernels
// hold; the 128-wide forward's and #8's row pass's halves take 16). NORM,
// SwinV2's cosine attention (HD 32): each row divided by
// max(|row|, 1e-12), its L2 norm over hd (the JAX package's _norm_rows,
// torch's F.normalize; the zero padding adds nothing), and, where inv is
// not null, the inverse norm to inv[r].
template <int ROWS, int NTH, bool NORM = false, int HD = 32, int BATCH = 8, class Row>
__device__ __forceinline__ void stage_head_rows(float* dst, int hd, Row row,
                                                float* inv = nullptr) {  // row(r): float or bf16
  static_assert(ROWS * HD % NTH == 0 && NTH % 32 == 0, "the rows must split evenly");
  static_assert(!NORM || HD == 32, "the cosine rows are a warp each");
  constexpr int PER = ROWS * HD / NTH, CH = HD >= 64 && PER > BATCH ? BATCH : PER;
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

// The bf16 recompute backward (#8's bf16 form at heads of 33-64 channels):
// qkv, datt and dqkv in bf16, the kind table and dS in fp32. P is recomputed
// in fp32 from q, k and the table; dV takes bf16(P), dS the fp32 P. (#6's
// bf16 stage and #8's bf16 form at heads of up to 32 are
// attn_group_bf16.cuh's.)
template <int N, int RB, int KS, int HD = 32>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS),
                                  attn_bwd_blocks(N, attn_tc_threads(RB, KS), HD))
    attn_rows_bwd_recompute_bf16_kernel(const bf16* __restrict__ qkv,
                                        const float* __restrict__ bias,
                                        const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                                        float* __restrict__ dS, int H, int W, int C, int nh,
                                        int wr, int wc, int kinds, int shift, float scale) {
  attn_rows_bwd_body<N, RB, KS, false, false, bf16, HD>(qkv, bias, datt, dqkv, nullptr, dS, H, W,
                                                        C, nh, wr, wc, kinds, shift, scale);
}

// The 128-wide form of #3 and #8 (heads of 65 to 128 channels: DRCT's 122
// and 77). k and v of a whole 128-wide head would take 2 N head_ld(128) =
// 270,336 B of fp32 rows at n 256, past a block's 232,448. #8's row pass
// takes the head in two 64-channel halves, each staged in turn into one (N,
// head_ld(64)) room with the 64-wide form's helpers (AttnWarps<.., 64>) on
// a plan of its own (attn_plan(n, 128): rows of 64 in two key parts, 8
// warps, one block a SM with up to 255 registers a thread): S = q k^T and
// dP = dA v^T take both halves in turn into the same fragments
// (rows_by_channels, the second half with ACC), dQ = dS k goes a half at a
// time; the second half holds hd - 64 channels and is zero past them. The
// forward (attn_wide_fwd_kernel, below #8's kernels) streams k and v of the
// whole head in tiles of keys instead.
//
// #8 is two kernels, each doing its products once (five of the function's,
// and S once more):
//   - the row pass (attn_wide_bwd_rows_kernel): one block per (window, head,
//     row block of 64). S over both halves, the softmax (each row's max and
//     inverse sum to a (B, H/wr, W/wc, nh, N) float2 scratch), dP = dA v^T
//     over both halves, dS = P (dP - rowsum(P dP)) to the dS buffer (which
//     the bias-kind reduction sums), dQ = scale dS k a half at a time. The
//     sums over the keys stay inside the block.
//   - the key pass (attn_wide_bwd_keys_kernel): one block per (window, head,
//     block of KB keys), whose k rows stay staged whole (HD 128: the key
//     block's 64 rows take 33,792 B) while it walks the row blocks of R rows:
//     q and dA rows staged whole, S = q k^T of the block's keys recomputed and
//     P = exp(S scale + bias - max) / sum from the row pass's stats (the same
//     products in the same order as the row pass's, so the same P), dS read
//     back from the buffer (L2-resident: 37.7 MB at drct's swin_3 block), dV
//     += P^T dA and dK += dS^T q in registers. The sums over the rows stay
//     inside the block.
// No atomics: every output element is written by one block, its sums in a
// fixed order, so two runs are bit-identical. The grids grow with the row
// and key blocks (at drct's swin_3 block, 144 (window, head) pairs: 576
// blocks a pass), which fills the card's waves where one block a (window,
// head) left a second wave of 12. T: float (3xTF32 on mma.sync m16n8k8) or
// bf16 (m16n8k16, fp32 sums, P and bf16(scale dS) rounded as the fragments
// load, as the 64-wide bf16 forms). Grids and outputs as
// attn_rows_fwd_tc_kernel's (no shift, no P) and attn_rows_bwd_tc_kernel's
// (no att, no saved P): the same bias-kind reduction of dS follows.

// Loads a thread keeps in flight as #8's row pass stages a half (the
// 64-wide form's 8 left it waiting on L2 for most of its staging); the key
// pass, whose dK and dV sums hold 64 floats a thread under a cap of 128
// registers (two blocks a SM), keeps 8.
constexpr int kWideBatch = 16, kWideBwdBatch = 8;

// Shared memory of attn_wide_bwd_rows_kernel, in floats: the room of a k or
// v half, this row block's q, dA and dq halves, the P / dS rows, three (KS,
// RB) exchanges and the N token indices.
__host__ __device__ constexpr int attn_wide_rows_smem_floats(int N, int RB, int KS) {
  return N * head_ld(64) + 3 * RB * head_ld(64) + RB * (N + 4) + 3 * KS * RB + N;
}

// Shared memory of attn_wide_bwd_keys_kernel, in floats: the key block's k
// rows (KB, head_ld(128)), which take its dk on the way out, a row block's q
// and dA rows (R, head_ld(128)) each, which together take its dv, the P and
// dS tiles (R, KB + 4), and the window's N token indices.
__host__ __device__ constexpr int attn_wide_keys_smem_floats(int N, int KB, int R) {
  return KB * head_ld(128) + 2 * R * head_ld(128) + 2 * R * (KB + 4) + N;
}

// The ROWS x COLS block at src (row stride ld) into the (ROWS, COLS + 4)
// tile pt, each entry times mul, 4 entries a copy (NTH threads).
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void stage_block_rows(float* pt, const float* __restrict__ src,
                                                 int ld, float mul) {
  constexpr int Q = COLS / 4;
  static_assert(COLS % 4 == 0, "rows of 4-entry pieces");
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * Q; e += NTH) {
    float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(e / Q) * ld) + e % Q);
    v.x *= mul, v.y *= mul, v.z *= mul, v.w *= mul;
    reinterpret_cast<float4*>(pt + (e / Q) * (COLS + 4))[e % Q] = v;
  }
}

// S = q k^T of the row block of tokens rt over both halves of head h, into
// this warp's fragments s, the bias rows of `table` staged into pt (the
// caller's softmax_frags reads them). xs and qs are rewritten; holds block
// barriers and ends with one.
template <int BATCH, class AW, typename T>
__device__ __forceinline__ void wide_scores(const AW& aw, float (&s)[AW::NT][4],
                                            const T* __restrict__ qkv, const int* tok,
                                            const int* rt, const float* table, float* xs,
                                            float* qs, float* pt, int C, int h, int hd) {
  constexpr int N = AW::N_, RB = AW::RB_, NTH = AW::NTH;
  const long long C3 = 3LL * C;
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const int off = h * hd + 64 * c, n_c = c ? hd - 64 : 64;
    stage_head_rows<N, NTH, false, 64, BATCH>(
        xs, n_c, [&](int r) { return qkv + tok[r] * C3 + C + off; });
    stage_head_rows<RB, NTH, false, 64, BATCH>(
        qs, n_c, [&](int r) { return qkv + rt[r] * C3 + off; });
    if (c == 0) stage_table_rows<RB, N, NTH>(pt, table);
    __syncthreads();  // the halves (and the bias rows) staged
    if (c == 0)
      aw.rows_by_channels(qs, xs, s);
    else
      aw.template rows_by_channels<true>(qs, xs, s);
    __syncthreads();  // every warp is done with the halves
  }
}

// The 128-wide #8's row pass: one block per (window, head, row block of
// RB), the row blocks fastest (grid (nh N / RB, windows, B)): S over both
// halves and the softmax (each row's max and inverse sum to `stats`), dP =
// dA v^T over both halves, dS = P (dP - rowsum(P dP)) in place of P and to
// its buffer (bf16: scale dS in the tile, rounded as it loads), then dQ =
// scale dS k a half at a time, out through shared memory a head row at a
// time.
template <int N, int RB, int KS, typename T>
__global__ void __launch_bounds__(attn_tc_threads(RB, KS), 1)
    attn_wide_bwd_rows_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                              const T* __restrict__ datt, T* __restrict__ dqkv,
                              float* __restrict__ dS, float2* __restrict__ stats, int H, int W,
                              int C, int nh, int wr, int wc, int kinds, float scale) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  using AW = AttnWarps<N, RB, KS, BF, 64>;
  constexpr int NTH = AW::NTH, LD = AW::LD, NT = AW::NT, CT = AW::CT, X = KS * RB;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / wc, nwh = H / wr;
  const int r0 = RB * (blockIdx.x % (N / RB)), h = blockIdx.x / (N / RB);
  const int wi = blockIdx.y / nww, wj = blockIdx.y % nww;
  const AW aw;
  float* xs = smem;              // (N, LD) a half of k or v
  float* qs = xs + N * LD;       // (RB, LD) a half of this row block's q
  float* das = qs + RB * LD;     // (RB, LD) a half of its datt
  float* oq = das + RB * LD;     // (RB, LD) a half of its dq
  float* pt = oq + RB * LD;      // (RB, LP): the bias rows, P, then dS
  float* red = pt + RB * AW::LP;  // (3, KS, RB): each part's row max, row sum, rowsum(P dP)
  int* tok = reinterpret_cast<int*>(red + 3 * X);  // (N) the window's tokens
  for (int r = threadIdx.x; r < N; r += NTH)
    tok[r] = (int)roll_token(blockIdx.z, wi, wj, r, H, W, wr, wc, 0);
  const float* table = bias + ((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * N * N;
  const size_t rows = ((size_t)blockIdx.z * nwh * nww + blockIdx.y) * nh + h;  // (b, win, h)
  const int* rt = tok + r0;  // this row block's tokens
  __syncthreads();
  {
    float s[NT][4];
    wide_scores<kWideBatch>(aw, s, qkv, tok, rt, table + (size_t)r0 * N, xs, qs, pt, C, h, hd);
    aw.template softmax_frags<true>(s, pt, red, scale, stats + rows * N + r0);  // P to the tile
  }
  float dp[NT][4];  // dP = dA v^T over both halves
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const int off = h * hd + 64 * c, n_c = c ? hd - 64 : 64;
    stage_head_rows<N, NTH, false, 64, kWideBatch>(
        xs, n_c, [&](int r) { return qkv + (long long)tok[r] * C3 + 2 * C + off; });
    stage_head_rows<RB, NTH, false, 64, kWideBatch>(
        das, n_c, [&](int r) { return datt + (long long)rt[r] * C + off; });
    __syncthreads();  // v's and dA's halves staged (and, the first time, P whole)
    if (c == 0)
      aw.rows_by_channels(das, xs, dp);
    else
      aw.template rows_by_channels<true>(das, xs, dp);
    __syncthreads();  // every warp is done with the halves
  }
  {  // dS = P (dP - rowsum(P dP)) in place of P and to its buffer
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pv = *aw.at(pt, i, j);
        delta[i] = fmaf(pv.x, dp[j][2 * i], delta[i]);
        delta[i] = fmaf(pv.y, dp[j][2 * i + 1], delta[i]);
      }
    aw.row_total(red + 2 * X, delta, false);  // its barrier: every warp is done reading P
    float* ds = dS + (rows * N + r0) * N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pv = *aw.at(pt, i, j);
        const float2 v = make_float2(pv.x * (dp[j][2 * i] - delta[i]),
                                     pv.y * (dp[j][2 * i + 1] - delta[i]));
        *aw.at(pt, i, j) = BF ? make_float2(scale * v.x, scale * v.y) : v;
        *reinterpret_cast<float2*>(ds + (size_t)aw.s_row(i) * N + aw.s_col(j)) = v;
      }
  }
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {  // dQ = scale dS k, a half at a time
    const int off = h * hd + 64 * c, n_c = c ? hd - 64 : 64;
    stage_head_rows<N, NTH, false, 64, kWideBatch>(
        xs, n_c, [&](int r) { return qkv + (long long)tok[r] * C3 + C + off; });
    __syncthreads();  // k's half staged (and, the first time, dS whole)
    float o[CT][4];
    aw.rows_by_keys(pt, xs, o);
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oq[aw.o_row(e) * LD + aw.o_chan(j, e)] = (BF ? 1.f : scale) * o[j][e];
    __syncthreads();  // dq's half whole; xs free
    store_head_rows<RB, NTH, 64>(oq, n_c,
                                 [&](int r) { return dqkv + (long long)rt[r] * C3 + off; });
  }
}

// The 128-wide #8's key pass: one block per (window, head, block of KB
// keys), the key blocks fastest (grid (nh N / KB, windows, B)), on
// AttnWarps<KB, R, KS, .., 128>: the key block's k rows staged whole once;
// per row block of R rows, q and dA staged whole and dS's (R, KB) block from
// the row pass's buffer (bf16: scale dS), S = q k^T, P from the row pass's
// stats and the bias rows (loaded while the block stages), then dV += P^T dA
// and dK += dS^T q in registers across the row blocks; dK (scaled) and dV
// leave through the rooms of k and of q and dA, a head row at a time.
template <int N, int KB, int R, int KS, typename T>
__global__ void __launch_bounds__(attn_tc_threads(R, KS), 2)
    attn_wide_bwd_keys_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                              const T* __restrict__ datt, T* __restrict__ dqkv,
                              const float* __restrict__ dS, const float2* __restrict__ stats,
                              int H, int W, int C, int nh, int wr, int wc, int kinds,
                              float scale) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  using AW = AttnWarps<KB, R, KS, BF, 128>;
  constexpr int NTH = AW::NTH, LD = AW::LD, LP = AW::LP, NT = AW::NT, UNITS = AW::UNITS;
  static_assert(N % KB == 0 && N % R == 0 && KB <= 2 * R, "the key and row blocks must fit");
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh, C3 = 3 * C;
  const int nww = W / wc, nwh = H / wr;
  const int k0 = KB * (blockIdx.x % (N / KB)), h = blockIdx.x / (N / KB);
  const int wi = blockIdx.y / nww, wj = blockIdx.y % nww;
  const AW aw;
  float* ks = smem;            // (KB, LD) the key block's k, then its dk
  float* qs = ks + KB * LD;    // (R, LD) a row block's q; with das, the key block's dv
  float* das = qs + R * LD;    // (R, LD) its datt
  float* pt = das + R * LD;    // (R, LP) its P at the block's keys
  float* dst = pt + R * LP;    // (R, LP) its dS there (bf16: scale dS)
  int* tok = reinterpret_cast<int*>(dst + R * LP);  // (N) the window's tokens
  for (int r = threadIdx.x; r < N; r += NTH)
    tok[r] = (int)roll_token(blockIdx.z, wi, wj, r, H, W, wr, wc, 0);
  const size_t rows = ((size_t)blockIdx.z * nwh * nww + blockIdx.y) * nh + h;  // (b, win, h)
  const float* table =
      bias + ((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * N * N + k0;
  const float* ds = dS + rows * N * N + k0;
  const float2* st = stats + rows * N;
  __syncthreads();
  stage_head_rows<KB, NTH, false, 128, kWideBwdBatch>(
      ks, hd, [&](int r) { return qkv + (long long)tok[k0 + r] * C3 + C + h * hd; });
  float dv[UNITS][2][4], dk[UNITS][2][4];
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[u][j][e] = dk[u][j][e] = 0.f;
  for (int r0 = 0; r0 < N; r0 += R) {
    const int* rt = tok + r0;  // this row block's tokens
    stage_head_rows<R, NTH, false, 128, kWideBwdBatch>(
        qs, hd, [&](int r) { return qkv + (long long)rt[r] * C3 + h * hd; });
    stage_head_rows<R, NTH, false, 128, kWideBwdBatch>(
        das, hd, [&](int r) { return datt + (long long)rt[r] * C + h * hd; });
    stage_block_rows<R, KB, NTH>(dst, ds + (size_t)r0 * N, N, BF ? scale : 1.f);
    float2 bb[NT][2], ms[2];  // this thread's bias pairs and its rows' max and inverse sum
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + aw.s_row(i);
      ms[i] = __ldg(st + r);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bb[j][i] = __ldg(reinterpret_cast<const float2*>(table + (size_t)r * N + aw.s_col(j)));
    }
    __syncthreads();  // q, dA and dS's block (and, the first time, k) staged
    {  // P = exp(S scale + bias - max) / sum, as the row pass's softmax_frags
      float p[NT][4];
      aw.rows_by_channels(qs, ks, p);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          p[j][2 * i] = p[j][2 * i] * scale + bb[j][i].x;
          p[j][2 * i + 1] = p[j][2 * i + 1] * scale + bb[j][i].y;
          *aw.at(pt, i, j) = make_float2(expf(p[j][2 * i] - ms[i].x) * ms[i].y,
                                         expf(p[j][2 * i + 1] - ms[i].x) * ms[i].y);
        }
    }
    __syncthreads();  // P is whole
    aw.keys_by_rows(pt, das, dv);  // dV += P^T dA
    aw.keys_by_rows(dst, qs, dk);  // dK += dS^T q (scaled once, at the end)
    __syncthreads();  // q, dA and the tiles are rewritten by the next row block
  }
  float* dvs = qs;  // (KB, LD) over the rooms of q and dA
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = aw.u_key(u, e) * LD + aw.u_chan(u, j, e);
        ks[i] = (BF ? 1.f : scale) * dk[u][j][e];
        dvs[i] = dv[u][j][e];
      }
  __syncthreads();
  store_head_rows<KB, NTH, 128>(
      ks, hd, [&](int r) { return dqkv + (long long)tok[k0 + r] * C3 + C + h * hd; });
  store_head_rows<KB, NTH, 128>(
      dvs, hd, [&](int r) { return dqkv + (long long)tok[k0 + r] * C3 + 2 * C + h * hd; });
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
// plans. #8's 128-wide row pass (hd 128: heads of 65 to 128 channels in
// two 64-channel halves) takes rows of 64 in two key parts at every n (8
// warps, one block a SM: its rooms hold one 64-channel half of k or v,
// 190,976 B at n 256); #8's key pass, WideKeyPlan; the 128-wide forward,
// WideFwdPlan.
struct AttnPlan {
  int rb, ks;
};
__host__ __device__ constexpr AttnPlan attn_plan(int n, int hd = 32) {
  return hd == 128  ? AttnPlan{64, 2}
         : n == 256 ? (hd == 64 ? AttnPlan{32, 4} : AttnPlan{64, 4})
         : n == 144 ? AttnPlan{48, 2}
         : n == 128 ? AttnPlan{32, 4}
         : n == 64  ? AttnPlan{64, 2}
                    : AttnPlan{0, 0};
}

// The 128-wide #8's key pass at every n: blocks of 64 keys, rows of 32 in
// four key parts (8 warps; a thread's dK and dV sums 32 floats each, its S
// fragments 8), 86,016 B of shared memory at n 256, two blocks a SM.
struct WideKeyPlan {
  int kb, r, ks;
};
constexpr WideKeyPlan kWideKeyPlan{64, 32, 4};

// ---------------------------------------------------------------------------
// The 128-wide #3 (attn_wide_fwd_kernel): one block per (window, head, row
// block of RB rows), the row blocks fastest (grid (nh N / RB, windows, B)),
// 8 warps, each a (16-row tile, key part) in S and a (16-row tile, every
// other 8-channel tile) in att = P v. The block's q rows are staged once and
// each warp holds its tile's in registers over the head's channels; k, then
// v, stream through two shared buffers in tiles of KT keys whose rows hold
// the whole head (fp32 132 floats apart; bf16 stays bf16, 136 elements
// apart), the next tile's cp.async copies in flight while the warps
// multiply this one (one barrier a tile), so k and v are read once a block
// (the row blocks of a (window, head) read the same rows, from L2). The
// softmax stays exact, as the JAX kernel's: S = q k^T scale + bias of every
// key goes into the (RB, N + 4) fp32 tile over the bias rows staged there
// first, each warp then takes whole rows (max, exp, sum by warp shuffles in
// a fixed order) and writes P (fp32) or bf16(P) (bf16, over the row's first
// half), and att = P v sums tile by tile in registers, out through a buffer
// a head row at a time. Products: 3xTF32 mma.sync m16n8k8 (fp32), or
// m16n8k16 with fp32 sums (bf16: q and k fragments straight from the bf16
// rows, v's through ldmatrix.trans, bf16(P) from the tile), on the k-steps
// and channel tiles that hold the head (77 channels: 80 of 128). A head
// may start at any element of its token's row (DRCT's heads of 122 at C
// 244: every 488 B in fp32, 244 B in bf16), and a copy a channel would
// make most of the block's copies: the copies are of `unit` elements, the
// widest 16-, 8- or 4-byte copy that qkv's base and C allow
// (wide_fwd_unit), each row from the copy boundary at or before the head,
// so channel c lands at c + p, p = h hd mod unit for q, k and v alike, the
// p elements before zeroed (they add nothing to S) and att read back from
// c + p; unit 0, a bf16 qkv at an odd C,
// copies element by element, not overlapped. No atomics, one launch: two
// runs are bit-identical.
// ---------------------------------------------------------------------------

// The 128-wide forward's plan: query rows of a block, keys of a staged tile.
struct WideFwdPlan {
  int rb, kt;
};
constexpr WideFwdPlan kWideFwdPlan{64, 64};
constexpr int kWideFwdThreads = 256;

// Elements between two staged head rows of the 128-wide forward: fp32 132,
// bf16 136 (16-byte rows 4 banks apart: the fragments' loads hit 32 banks).
__host__ __device__ constexpr int wide_fwd_ld(bool bf) { return bf ? 136 : 132; }

// Shared memory of attn_wide_fwd_kernel, in bytes: two buffers of KT head
// rows (q's RB rows in the second at the start, att's on the way out in the
// first), the (RB, N + 4) fp32 S / P tile and the window's N token indices:
// 135,168 B in fp32 at n 256, 102,400 B in bf16.
__host__ __device__ constexpr int attn_wide_fwd_smem_bytes(int N, int RB, int KT, bool bf) {
  return 2 * KT * wide_fwd_ld(bf) * (bf ? 2 : 4) + 4 * RB * (N + 4) + 4 * N;
}

// Blocks a SM of the 128-wide forward: fp32 one (a thread holds its q rows,
// 64 floats, under a cap of 255 registers), bf16 two (32 words of q pairs
// under a cap of 128).
__host__ __device__ constexpr int attn_wide_fwd_blocks(bool bf) { return bf ? 2 : 1; }

// `ub` bytes (4, 8 or 16) from src to dst, of which the first `bytes` are
// read and the rest are zero.
__device__ __forceinline__ void cp_async_unit(void* dst, const void* src, int ub, int bytes) {
  if (ub == 16)
    cp_async16(static_cast<float*>(dst), static_cast<const float*>(src), bytes);
  else if (ub == 8)
    cp_async8(dst, src, bytes);
  else
    cp_async4(static_cast<float*>(dst), static_cast<const float*>(src), bytes);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The B fragment of m16n8k16 for the 16 x 8 block of a row-major bf16
// matrix (16 rows of k, 8 columns of n) whose row k0 + i starts at
// rows[i * ld]: lanes 0-15 name the rows.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t& b0, uint32_t& b1, const bf16* rows,
                                                 int ld) {
  const bf16* row = rows + (threadIdx.x & 15) * ld;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(row))
               : "memory");
}

// How a block of the 128-wide forward stages its head's rows: `unit`
// elements a copy (0: element by element), `units` copies a row from the
// copy boundary p elements before the head, of which the last reads `last`
// bytes; channel c of the head at c + p of a staged row; hd the head's
// channels.
struct WideRows {
  int unit, units, last, p, hd;
};

// ROWS head rows into dst (row stride LD): row r from the token tok[r],
// `off` elements into its 3C row (off counts the p elements before the
// head); warp w takes the rows w, w + 8, .., lane l the copies l, l + 32,
// .. of a row (cp.async, not waited for; unit 0: plain loads and stores).
template <int ROWS, int LD, typename T>
__device__ __forceinline__ void wide_stage(T* dst, const T* __restrict__ qkv, const int* tok,
                                           long long c3, int off, const WideRows& w) {
  constexpr int NW = kWideFwdThreads / 32;
  const int lane = threadIdx.x % 32, ub = w.unit * (int)sizeof(T);
#pragma unroll 1
  for (int r = threadIdx.x / 32; r < ROWS; r += NW) {
    const T* src = qkv + tok[r] * c3 + off;
    T* d = dst + r * LD;
    if (w.unit == 0) {
      for (int c = lane; c < w.hd; c += 32) d[c] = src[c];
    } else {
      for (int u = lane; u < w.units; u += 32)
        cp_async_unit(d + u * w.unit, src + u * w.unit, ub, u == w.units - 1 ? w.last : ub);
    }
  }
}

// The p elements before channel 0 of the rows that this warp staged into
// dst, zero: its lane 0 copied them (the row's first copy), and zeroes them
// after its own copies landed.
template <int ROWS, int LD, typename T>
__device__ __forceinline__ void wide_zero_lead(T* dst, const WideRows& w) {
  if (w.p == 0 || threadIdx.x % 32 != 0) return;
  for (int r = threadIdx.x / 32; r < ROWS; r += kWideFwdThreads / 32)
    for (int c = 0; c < w.p; ++c) st_f(dst + r * LD + c, 0.f);
}

// d[j] += A B_j over one k-step of 8 in 3xTF32 for j < nj, B_j's two
// values of this thread b[j]: mma3's products in mma3's order for each
// d[j] (lo*hi, hi*lo, hi*hi), the J accumulators' chains interleaved.
template <int J>
__device__ __forceinline__ void mma3_tiles(float (&d)[J][4], const MmaA& a,
                                           const float (&b)[J][2], int nj = J) {
  uint32_t h[J][2], l[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) split_tf32_trunc(b[j][e], h[j][e], l[j][e]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < nj) mma_tf32(d[j], a.l, h[j][0], h[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < nj) mma_tf32(d[j], a.h, l[j][0], l[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < nj) mma_tf32(d[j], a.h, h[j][0], h[j][1]);
}

// The softmax of the RB rows of pt (N + 4 floats apart) in place, a warp a
// row: P in fp32, or (BF) bf16(P) over the first half of the row's bytes.
template <int N, int RB, bool BF>
__device__ __forceinline__ void wide_softmax(float* pt) {
  constexpr int LP = N + 4, PER = N / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = threadIdx.x / 32; r < RB; r += kWideFwdThreads / 32) {
    float* row = pt + r * LP;
    float v[PER], m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = row[lane + 32 * i];
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = expf(v[i] - m);
      sum += v[i];
    }
    const float inv = 1.f / warp_sum(sum);
    if constexpr (BF) {
      __syncwarp();  // the row read whole before its first half takes bf16(P)
      bf16* pb = reinterpret_cast<bf16*>(row);
#pragma unroll
      for (int i = 0; i < PER; ++i) pb[lane + 32 * i] = f2bf(v[i] * inv);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) row[lane + 32 * i] = v[i] * inv;
    }
  }
}

// From qkv (T, 3C) and the kind table (kinds, nh, N, N), in x's frame:
// this head's softmax(q k^T scale + bias) v into att (T, C), for windows of
// N tokens, wr x wc, no shift; `unit` as wide_fwd_unit gives it.
template <int N, int RB, int KT, typename T>
__global__ void __launch_bounds__(kWideFwdThreads,
                                  attn_wide_fwd_blocks(std::is_same<T, bf16>::value))
    attn_wide_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                         T* __restrict__ att, int H, int W, int C, int nh, int wr, int wc,
                         int kinds, float scale, int unit) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int NW = kWideFwdThreads / 32, LD = wide_fwd_ld(BF), LP = N + 4;
  constexpr int KSTEP = BF ? 16 : 8, QS = 128 / KSTEP;  // k-steps of a whole head
  constexpr int NKT = N / KT, TILES = 2 * NKT;           // k's tiles, then v's
  constexpr int NT = KT / 16;  // a warp's 8-key tiles of S in a key tile (two key parts)
  constexpr int CT = 8;        // a warp's 8-channel tiles of att (every other one of 16)
  static_assert(RB == 8 * NW && KT >= RB && N % KT == 0 && KT % 32 == 0,
                "8 warps, two a 16-row tile; q and att fit a buffer");
  extern __shared__ __align__(16) float smem[];
  T* bufs = reinterpret_cast<T*>(smem);                      // two (KT, LD) buffers
  float* pt = reinterpret_cast<float*>(bufs + 2 * KT * LD);  // (RB, LP): bias rows, S, P
  int* tok = reinterpret_cast<int*>(pt + RB * LP);           // (N) the window's tokens
  const int hd = C / nh;
  const long long C3 = 3LL * C;
  const int nww = W / wc, nwh = H / wr;
  const int r0 = RB * (blockIdx.x % (N / RB)), h = blockIdx.x / (N / RB);
  const int wi = blockIdx.y / nww, wj = blockIdx.y % nww;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  const int row0 = 16 * (warp / 2), part = warp % 2;
  WideRows w;
  w.unit = unit;
  w.hd = hd;
  w.p = unit ? h * hd % unit : 0;
  const int span = hd + w.p;  // channels of a staged row, the p before the head's included
  w.units = unit ? (span + unit - 1) / unit : 0;
  w.last = unit ? (span - (w.units - 1) * unit) * (int)sizeof(T) : 0;
  const int nks = (span + KSTEP - 1) / KSTEP, nct = (span + 7) / 8;
  const int nj = (nct - part + 1) / 2;  // this warp's channel tiles 2 j + part of att
  const int off = h * hd - w.p;
  {  // zeros from the copied channels to the last k-step's, in both buffers (never copied over)
    const int z0 = unit ? w.units * unit : hd, zw = nks * KSTEP - z0;
    for (int e = threadIdx.x; e < 2 * KT * zw; e += kWideFwdThreads)
      st_f(bufs + (e / zw) * LD + z0 + e % zw, 0.f);
  }
  for (int r = threadIdx.x; r < N; r += kWideFwdThreads)
    tok[r] = (int)roll_token(blockIdx.z, wi, wj, r, H, W, wr, wc, 0);
  const float* table =
      bias + (((size_t)window_kind(kinds, wi, wj, nwh, nww) * nh + h) * N + r0) * N;
  __syncthreads();  // the tokens
  for (int e = threadIdx.x; e < RB * (N / 4); e += kWideFwdThreads)  // the bias rows
    cp_async_unit(pt + (e / (N / 4)) * LP + 4 * (e % (N / 4)), table + 4 * e, 16, 16);
  T* qs = bufs + KT * LD;
  wide_stage<RB, LD>(qs, qkv, tok + r0, C3, off, w);  // q, into the second buffer
  wide_stage<KT, LD>(bufs, qkv, tok, C3, C + off, w);  // k's first tile
  cp_async_commit();
  auto stage_tile = [&](int i) {  // tile i (k's, then v's) into buffer i % 2
    T* dst = bufs + (i % 2) * KT * LD;
    if (i < NKT)
      wide_stage<KT, LD>(dst, qkv, tok + i * KT, C3, C + off, w);
    else
      wide_stage<KT, LD>(dst, qkv, tok + (i - NKT) * KT, C3, 2 * C + off, w);
    cp_async_commit();
  };
  auto landed = [&](int i) {  // tile i (and, the first time, q and the bias rows) staged
    cp_async_wait_all();
    wide_zero_lead<KT, LD>(bufs + (i % 2) * KT * LD, w);
    if (i == 0) wide_zero_lead<RB, LD>(qs, w);
    __syncthreads();
  };
  uint32_t qa[QS][4];  // this warp's q rows: fp32 values, or bf16 pairs
  landed(0);
#pragma unroll
  for (int st = 0; st < QS; ++st) {
    if constexpr (BF) {
      const bf16* x = qs + (row0 + g) * LD + 16 * st + 2 * q4;
      qa[st][0] = *reinterpret_cast<const uint32_t*>(x);
      qa[st][1] = *reinterpret_cast<const uint32_t*>(x + 8 * LD);
      qa[st][2] = *reinterpret_cast<const uint32_t*>(x + 8);
      qa[st][3] = *reinterpret_cast<const uint32_t*>(x + 8 * LD + 8);
    } else {
      const float* x = qs + (row0 + g) * LD + 8 * st + q4;
      qa[st][0] = __float_as_uint(x[0]);
      qa[st][1] = __float_as_uint(x[8 * LD]);
      qa[st][2] = __float_as_uint(x[4]);
      qa[st][3] = __float_as_uint(x[8 * LD + 4]);
    }
  }
  __syncthreads();  // every warp holds its q rows: the second buffer is free
#pragma unroll 1
  for (int i = 0; i < NKT; ++i) {  // S = q k^T scale + bias, a key tile at a time
    if (i > 0) landed(i);
    stage_tile(i + 1);
    const T* ks = bufs + (i % 2) * KT * LD + part * (KT / 2) * LD;  // this warp's keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int st = 0; st < QS; ++st) {
      if (st >= nks) continue;  // (no break: the loop stays unrolled, qa in registers)
      if constexpr (BF) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bf16* x = ks + (8 * j + g) * LD + 16 * st + 2 * q4;
          mma_bf16(s[j], qa[st], *reinterpret_cast<const uint32_t*>(x),
                   *reinterpret_cast<const uint32_t*>(x + 8));
        }
      } else {
        MmaA a;
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_trunc(__uint_as_float(qa[st][e]), a.h[e], a.l[e]);
        float b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* x = ks + (8 * j + g) * LD + 8 * st + q4;
          b[j][0] = x[0];
          b[j][1] = x[4];
        }
        mma3_tiles(s, a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2* d = reinterpret_cast<float2*>(pt + (row0 + g + 8 * e) * LP + i * KT +
                                              part * (KT / 2) + 8 * j + 2 * q4);
        const float2 b = *d;
        *d = make_float2(s[j][2 * e] * scale + b.x, s[j][2 * e + 1] * scale + b.y);
      }
  }
  float o[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll 1
  for (int i = NKT; i < TILES; ++i) {  // att = P v, a key tile at a time
    landed(i);  // and every warp done with S
    if (i + 1 < TILES) stage_tile(i + 1);
    if (i == NKT) {
      wide_softmax<N, RB, BF>(pt);
      __syncthreads();  // P whole
    }
    const T* vs = bufs + (i % 2) * KT * LD;
    const int k0 = (i - NKT) * KT;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += KSTEP) {
      if constexpr (BF) {
        const bf16* x = reinterpret_cast<const bf16*>(pt) + (row0 + g) * 2 * LP + k0 + kk + 2 * q4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(x),
                               *reinterpret_cast<const uint32_t*>(x + 16 * LP),
                               *reinterpret_cast<const uint32_t*>(x + 8),
                               *reinterpret_cast<const uint32_t*>(x + 16 * LP + 8)};
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < nj) {
            uint32_t b0, b1;
            ldmatrix_b_trans(b0, b1, vs + kk * LD + 8 * (2 * j + part), LD);
            mma_bf16(o[j], a, b0, b1);
          }
        }
      } else {
        MmaA a;
        mma_load_a<false>(a, pt + row0 * LP + k0 + kk, LP);
        float b[CT][2];
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float* x = vs + (kk + q4) * LD + 8 * (2 * j + part) + g;
          b[j][0] = j < nj ? x[0] : 0.f;
          b[j][1] = j < nj ? x[4 * LD] : 0.f;
        }
        mma3_tiles(o, a, b, nj);
      }
    }
  }
  // att through the first buffer (free since the barrier of the last tile,
  // which is in the second), out a head row at a time
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st_f(bufs + (row0 + g + 8 * (e / 2)) * LD + 8 * (2 * j + part) + 2 * q4 + e % 2,
             o[j][e]);
  }
  __syncthreads();
#pragma unroll 1
  for (int r = warp; r < RB; r += NW) {
    T* dst = att + (long long)tok[r0 + r] * C + h * hd;
    const T* src = bufs + r * LD + w.p;
    for (int c = lane; c < hd; c += 32) dst[c] = src[c];
  }
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

// attn_rows_bwd_recompute_bf16_kernel (#8's bf16 form) at windows of N
// tokens and rows of HD channels.
template <int N, int HD = 32>
cudaError_t attn_rows_bwd_recompute_bf16(const bf16* qkv, const float* bias, const bf16* datt,
                                         bf16* dqkv, float* dS, int B, int H, int W, int C,
                                         int nh, int wr, int wc, int kinds, int shift, float scale,
                                         cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N, HD);
  constexpr int floats = attn_rows_bwd_tc_smem_floats(N, plan.rb, plan.ks, false, false, HD);
  const cudaError_t err =
      set_smem(attn_rows_bwd_recompute_bf16_kernel<N, plan.rb, plan.ks, HD>, floats);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, (H / wr) * (W / wc), B);
  attn_rows_bwd_recompute_bf16_kernel<N, plan.rb, plan.ks, HD>
      <<<grid, attn_tc_threads(plan.rb, plan.ks), floats * sizeof(float), stream>>>(
          qkv, bias, datt, dqkv, dS, H, W, C, nh, wr, wc, kinds, shift, scale);
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

// The copy unit (elements) of attn_wide_fwd_kernel's staging: the widest
// 16-, 8- or 4-byte copy that qkv's base and C allow (every head row then
// starts p = h hd mod unit elements past a copy's start, the same p for
// q, k and v) and whose staged rows, p elements longer, still fit the
// head's k-steps (128 channels); else (a bf16 qkv at an odd C) 0, element
// by element.
template <typename T>
int wide_fwd_unit(const T* qkv, int C, int nh) {
  constexpr int KSTEP = std::is_same<T, bf16>::value ? 16 : 8;
  const uintptr_t base = reinterpret_cast<uintptr_t>(qkv);
  const int hd = C / nh;
  for (int a = 16 / (int)sizeof(T); a * (int)sizeof(T) >= 4; a /= 2) {
    if (C % a != 0 || base % (a * sizeof(T)) != 0) continue;
    int fits = 1;
    for (int h = 0; h < nh; ++h) fits &= (hd + h * hd % a + KSTEP - 1) / KSTEP * KSTEP <= 128;
    if (fits) return a;
  }
  return 0;
}

// attn_wide_fwd_kernel at windows of N tokens (the 128-wide #3), on
// kWideFwdPlan.
template <int N, typename T>
cudaError_t attn_wide_fwd(const T* qkv, const float* bias, T* att, int B, int H, int W, int C,
                          int nh, int wr, int wc, int kinds, float scale, cudaStream_t stream) {
  constexpr WideFwdPlan plan = kWideFwdPlan;
  constexpr int bytes =
      attn_wide_fwd_smem_bytes(N, plan.rb, plan.kt, std::is_same<T, bf16>::value);
  const cudaError_t err = set_smem(attn_wide_fwd_kernel<N, plan.rb, plan.kt, T>, bytes / 4);
  if (err != cudaSuccess) return err;
  attn_wide_fwd_kernel<N, plan.rb, plan.kt, T>
      <<<dim3(nh * (N / plan.rb), (H / wr) * (W / wc), B), kWideFwdThreads, bytes, stream>>>(
          qkv, bias, att, H, W, C, nh, wr, wc, kinds, scale, wide_fwd_unit(qkv, C, nh));
  return cudaGetLastError();
}

// The 128-wide #8 at windows of N tokens: the row pass
// (attn_wide_bwd_rows_kernel on attn_plan(N, 128)), then the key pass
// (attn_wide_bwd_keys_kernel on kWideKeyPlan), which reads the row pass's
// dS and stats (B, H/wr, W/wc, nh, N) scratch.
template <int N, typename T>
cudaError_t attn_rows_bwd_wide(const T* qkv, const float* bias, const T* datt, T* dqkv, float* dS,
                               float2* stats, int B, int H, int W, int C, int nh, int wr, int wc,
                               int kinds, float scale, cudaStream_t stream) {
  constexpr AttnPlan plan = attn_plan(N, 128);
  constexpr WideKeyPlan kp = kWideKeyPlan;
  constexpr int rows_floats = attn_wide_rows_smem_floats(N, plan.rb, plan.ks);
  constexpr int keys_floats = attn_wide_keys_smem_floats(N, kp.kb, kp.r);
  cudaError_t err = set_smem(attn_wide_bwd_rows_kernel<N, plan.rb, plan.ks, T>, rows_floats);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_wide_bwd_keys_kernel<N, kp.kb, kp.r, kp.ks, T>, keys_floats);
  if (err != cudaSuccess) return err;
  const int windows = (H / wr) * (W / wc);
  attn_wide_bwd_rows_kernel<N, plan.rb, plan.ks, T>
      <<<dim3(nh * (N / plan.rb), windows, B), attn_tc_threads(plan.rb, plan.ks),
         rows_floats * sizeof(float), stream>>>(qkv, bias, datt, dqkv, dS, stats, H, W, C, nh,
                                                wr, wc, kinds, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_wide_bwd_keys_kernel<N, kp.kb, kp.r, kp.ks, T>
      <<<dim3(nh * (N / kp.kb), windows, B), attn_tc_threads(kp.r, kp.ks),
         keys_floats * sizeof(float), stream>>>(qkv, bias, datt, dqkv, dS, stats, H, W, C, nh,
                                                wr, wc, kinds, scale);
  return cudaGetLastError();
}

}  // namespace trr
