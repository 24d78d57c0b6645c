// The window-attention backwards' products on the tensor cores: mma.sync
// m16n8k8 tf32 in 3xTF32 (tc_gemm.cuh) on the operands a thread block holds
// in shared memory for one (window, head). Shared by #6's
// attn_rows_bwd_tc_kernel (attn_block_staged.cu) and #12's
// cos_attn_bwd_tc_kernel (fused_block_v2.cu).
//
// A block takes the N keys of a window and its query rows in blocks of RB,
// 16 a row tile, two warps a row tile. In S = q k^T and dP = dA v^T warp w
// takes row tile w / 2 and half w % 2 of the keys, the scores staying in
// its accumulator fragments; the two halves of a row exchange their row
// sums through shared memory. P, then dS, of the row block lies in a shared
// (RB, N + 4) tile: att = P v and dQ = dS k read it as A, warp w taking
// (row tile w / 2, channel half w % 2); dV += P^T dA and dK += dS^T q read
// it transposed, warp w taking the (key tile, channel half) units w, w +
// warps, ..., whose sums a kernel carries across its row blocks. Rows of q,
// k, v and dA are padded with zeros to 32 channels, kHeadLd floats apart
// (36: the row fragments' loads hit 32 banks).
#pragma once

#include "tc_gemm.cuh"

namespace trr {

constexpr int kHeadLd = 36;

__host__ __device__ constexpr int attn_tc_threads(int RB) { return 32 * (RB / 8); }

template <int N, int RB>
struct AttnWarps {
  static constexpr int NTH = attn_tc_threads(RB), NW = NTH / 32;
  static constexpr int LD = kHeadLd, LP = N + 4, HALF = N / 2, NT = HALF / 8, UNITS = N / RB;
  static_assert(RB % 16 == 0 && N % RB == 0 && HALF % 8 == 0, "the tiles must split evenly");
  static_assert(2 * (N / 16) == UNITS * NW, "dK and dV units must share out evenly");

  int warp, g, q4, row0, half, col0;

  __device__ AttnWarps()
      : warp(threadIdx.x / 32),
        g(threadIdx.x % 32 / 4),
        q4(threadIdx.x % 4),
        row0(16 * (warp / 2)),
        half(warp % 2),
        col0(half * HALF) {}

  // Element (i, two columns from s_col(j)) of this warp's S / dP fragments:
  // p[j][2 i + c] is (row s_row(i), column s_col(j) + c) of the row block.
  __device__ int s_row(int i) const { return row0 + g + 8 * i; }
  __device__ int s_col(int j) const { return col0 + 8 * j + 2 * q4; }
  // Element e of tile j of this warp's (row tile, channel half) output.
  __device__ int o_row(int e) const { return row0 + g + 8 * (e / 2); }
  __device__ int o_chan(int j, int e) const { return 16 * half + 8 * j + 2 * q4 + e % 2; }
  // Element e of tile j of this warp's dV / dK unit u.
  __device__ int u_key(int u, int e) const { return 16 * ((warp + NW * u) / 2) + g + 8 * (e / 2); }
  __device__ int u_chan(int u, int j, int e) const {
    return 16 * ((warp + NW * u) % 2) + 8 * j + 2 * q4 + e % 2;
  }

  // o = Y X^T for this warp's rows and half of the keys, over the 32
  // channels: Y the (RB, LD) rows (q or dA), X the (N, LD) rows (k or v).
  __device__ void rows_by_channels(const float* Y, const float* X, float (&o)[NT][4]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 8) {
      MmaA a;
      mma_load_a<false>(a, Y + row0 * LD + k0, LD);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3<true>(o[j], a, X + (col0 + 8 * j) * LD + k0, LD);
    }
  }

  // o = pt X for this warp's (row tile, channel half) over the N keys: pt
  // the (RB, LP) P / dS tile, X the (N, LD) rows (v or k).
  __device__ void rows_by_keys(const float* pt, const float* X, float (&o)[2][4]) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < N; k0 += 8) {
      MmaA a;
      mma_load_a<false>(a, pt + row0 * LP + k0, LP);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma3<false>(o[j], a, X + k0 * LD + 16 * half + 8 * j, LD);
    }
  }

  // acc[u] += pt^T Y for this warp's (key tile, channel half) units over the
  // RB rows of the block: Y the (RB, LD) rows (dA or q).
  __device__ void keys_by_rows(const float* pt, const float* Y, float (&acc)[UNITS][2][4]) const {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int unit = warp + NW * u, kt = unit / 2, ch = unit % 2;
#pragma unroll 2
      for (int k0 = 0; k0 < RB; k0 += 8) {
        MmaA a;
        mma_load_a<true>(a, pt + k0 * LP + 16 * kt, LP);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3<false>(acc[u][j], a, Y + k0 * LD + 16 * ch + 8 * j, LD);
      }
    }
  }

  // v[i] (row s_row(i), this thread's part) becomes the row's max (is_max)
  // or sum over both halves, the halves combined in order through buf (2 *
  // RB floats). Holds a block barrier.
  __device__ void row_total(float* buf, float (&v)[2], bool is_max) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v[i], o);
        v[i] = is_max ? fmaxf(v[i], w) : v[i] + w;
      }
      if (q4 == 0) buf[half * RB + s_row(i)] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a = buf[s_row(i)], c = buf[RB + s_row(i)];
      v[i] = is_max ? fmaxf(a, c) : a + c;
    }
  }

  // The two floats of pt at this thread's fragment element (i, j).
  __device__ float2* at(float* pt, int i, int j) const {
    return reinterpret_cast<float2*>(pt + s_row(i) * LP + s_col(j));
  }
};

// dst[r * kHeadLd + d] = row(r)[d] for d < hd, else 0, for the ROWS rows
// (NTH threads; each thread's loads issued before its stores).
template <int ROWS, int NTH, class Row>
__device__ __forceinline__ void stage_head_rows(float* dst, int hd, Row row) {
  static_assert(ROWS * 32 % NTH == 0, "the rows must split evenly");
  constexpr int PER = ROWS * 32 / NTH;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NTH, d = e % 32;
    v[i] = d < hd ? __ldg(row(e / 32) + d) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NTH;
    dst[(e / 32) * kHeadLd + e % 32] = v[i];
  }
}

// The ROWS x N rows of the table at src (row stride N) into the (ROWS, N +
// 4) tile pt, 16 bytes a copy (NTH threads).
template <int ROWS, int N, int NTH>
__device__ __forceinline__ void stage_table_rows(float* pt, const float* __restrict__ src) {
  constexpr int Q = N / 4;
  static_assert(N % 4 == 0, "16-byte rows");
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * Q; e += NTH)
    reinterpret_cast<float4*>(pt + (e / Q) * (N + 4))[e % Q] =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)(e / Q) * N) + e % Q);
}

// row(r)[d] = src[r * kHeadLd + d] for d < hd, for the ROWS rows (NTH
// threads; a warp writes a row's hd floats at once).
template <int ROWS, int NTH, class Row>
__device__ __forceinline__ void store_head_rows(const float* src, int hd, Row row) {
  static_assert(ROWS * 32 % NTH == 0, "the rows must split evenly");
#pragma unroll 4
  for (int i = 0; i < ROWS * 32 / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, d = e % 32;
    if (d < hd) row(e / 32)[d] = src[(e / 32) * kHeadLd + d];
  }
}

}  // namespace trr
