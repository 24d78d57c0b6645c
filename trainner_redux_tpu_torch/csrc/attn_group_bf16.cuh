// #6's bf16 window attention at 12x12 windows (n 144), for sm_90a: the
// recompute backward of softmax(q k^T scale + bias) v over groups of windows
// of one bias kind, summing dbias inside the kernel as the JAX kernel does
// (trainner_redux_tpu/ops/pallas/fused_block.py:557-618: dbias_acc, the
// (kinds, nh, n, n) sums in VMEM over the windows it walks, one write at the
// end). The stage of trr_attn_block_bwd_bf16 (fused_block_train.cu) between
// qkv and the LN1 backward.
//
// The function, with the JAX kernel's rounding points: P = softmax(q k^T
// scale + bias) in fp32; att = bf16(bf16(P) v) (for dwp); dV = bf16(P)^T dA;
// dP = dA v^T; dS = P (dP - rowsum(P dP)) in fp32, summed into dbias; dQ =
// bf16(scale dS) k and dK = bf16(scale dS)^T q; dq, dk, dv rounded to bf16.
//
// What bounds it on the card, at SRFormerV2's block (B 16, 72x72, C 240, 8
// heads of 30: 4,608 (window, head) pairs): six products of 1.3 MFLOP a pair
// (heads padded to 32 channels), 36.7 GFLOP, 37 us on the bf16 tensor cores;
// its rows, qkv, datt, dqkv and att in bf16, 318 MB, 95 us at 3.35 TB/s. So
// bytes, with the products close behind.
//
// What the design does about it:
//   - One block per (head, group of kGroupWindows windows of one kind), the
//     heads fastest, so the heads of a window run together and each token's
//     rows are read while they stay in L2. The groups list each kind's
//     windows in order (sample, window row, window column); the last group
//     of a kind takes the rest.
//   - dbias in the block: a window's dS (all 144 x 144 of a head) lies in
//     the fragments of the 9 warps, 72 entries a thread, each the same (row,
//     key) in every window; the thread adds them to 72 fp32 sums of its own
//     in shared memory (a slot a thread, so the accesses hit 32 banks),
//     windows in order. Only the group's sums go to device memory, (groups,
//     nh, 144, 144) fp32 (48 MB at SRFormerV2's block, where the per-window
//     dS was 382 MB); dbias_group_sum_kernel adds each kind's groups in
//     order. No atomics: two runs give the same bits.
//   - The whole window at once: 9 warps, warp w the 16-row tile w over all
//     144 keys in S and dP, so each row's max, sum and rowsum(P dP) stay in
//     the four lanes of a quad (no exchange between warps), its P in fp32 in
//     72 registers from the softmax to dS (dP goes an 8-key tile at a time,
//     twice: for rowsum(P dP), then for dS); the row tile w of att and dQ,
//     the key tile w of dV and dK, all 32 channels. No row loop, five
//     barriers a window. (18 warps, two a row tile, left a thread 96
//     registers: P spilled, and three more barriers exchanged the parts'
//     row sums.)
//   - bf16 stays bf16: q, k, v and dA rows are staged as bf16 (rows of 32
//     channels, zero past the head, 80 bytes apart), bf16(P), then
//     bf16(scale dS), in a (144, 152) bf16 tile (304-byte rows); every
//     product is mma.sync m16n8k16 with fp32 sums, its operands loaded as
//     they lie (A and the [n][k] B as 32-bit pairs, the [k][n] B by
//     ldmatrix.trans, P^T and dS^T by ldmatrix.x4.trans), every row stride 16
//     bytes past a multiple of 128 (5 or 19 16-byte units), so each
//     fragment load hits 32 banks. 218,880 bytes of shared memory: one block
//     a SM.
//   - The rows come in one window ahead, as the 16-byte pieces that hold a
//     head row (at most five for 32 channels; a head of 30 starts 60 h
//     bytes into its token's row, no 16-byte boundary), by cp.async into a
//     raw buffer while the window before computes; a shift within shared
//     memory (unpack) then puts each head row at the start of its room. Copies of the
//     head alone (4 bytes for heads of 30) kept the card's load units
//     busy for a third of the kernel's time. Where C is no multiple of 8 (or
//     a base is off 16 bytes) the rows go straight into the rooms in the
//     widest unit they allow, not overlapped. att, dq, dk and dv go from the
//     fragments to device memory as bf16 pairs.
#pragma once

#include "tc_attn.cuh"

namespace trr {

constexpr int kGroupN = 144;          // tokens of a 12x12 window
constexpr int kGroupWs = 12;
constexpr int kGroupWindows = 8;      // windows a block walks
constexpr int kGroupThreads = 288;    // 9 warps: a 16-row tile each
constexpr int kGroupLd = 40;          // bf16 between two staged head rows (32 channels + 8)
constexpr int kGroupLp = kGroupN + 8;  // bf16 between two rows of the P / dS tile

// Shared memory of attn_group_bwd_bf16_kernel, in bytes: the threads' dbias
// sums (n * n fp32), the rooms of n head rows each of q, k, v and dA, the
// raw buffer of the next window's pieces (as large), and the P / dS tile.
__host__ __device__ constexpr int attn_group_smem_bytes() {
  return 4 * kGroupN * kGroupN + 2 * 2 * 4 * kGroupN * kGroupLd + 2 * kGroupN * kGroupLp;
}

// Windows of kind `kind` of a (nwh, nww) grid: rows of windows and columns
// of them a sample (kinds 1: all of them).
__host__ __device__ inline void kind_grid(int kinds, int kind, int nwh, int nww, int& rows,
                                          int& cols) {
  rows = kinds == 1 ? nwh : (kind & 2) ? 1 : nwh - 1;
  cols = kinds == 1 ? nww : (kind & 1) ? 1 : nww - 1;
}

// The groups of each kind: goff[k] is the first group of kind k, goff[4]
// the total.
inline void attn_groups(int B, int nwh, int nww, int kinds, int (&goff)[5]) {
  goff[0] = 0;
  for (int k = 0; k < 4; ++k) {
    int rows, cols;
    kind_grid(kinds, k, nwh, nww, rows, cols);
    const int count = k < kinds ? B * rows * cols : 0;
    goff[k + 1] = goff[k] + (count + kGroupWindows - 1) / kGroupWindows;
  }
}

// The A fragment of m16n8k16 for the 16 x 16 block at X, A(m, k) = X[k * ld
// + m] (ld a multiple of 8): ldmatrix.x4.trans, matrices (k 0-7, m 0-7),
// (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15).
__device__ __forceinline__ void ldmatrix_a_trans(uint32_t (&a)[4], const bf16* X, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = X + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The A fragment of the 16 x 16 block at X, A(m, k) = X[m * ld + k] (ld even).
__device__ __forceinline__ void load_a_pairs(uint32_t (&a)[4], const bf16* X, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bf16* x = X + g * ld + 2 * q;
  a[0] = *reinterpret_cast<const uint32_t*>(x);
  a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(x + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * ld + 8);
}

// d[j] += A X_j^T for the NJ 8-row blocks X_j = X + 8 j ld (B(k, n) = X[n *
// ld + k], a k-step of 16 from X).
template <int NJ>
__device__ __forceinline__ void mma_rows(float (&d)[NJ][4], const uint32_t (&a)[4], const bf16* X,
                                         int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bf16* x = X + (8 * j + g) * ld + 2 * q;
    mma_bf16(d[j], a, *reinterpret_cast<const uint32_t*>(x),
             *reinterpret_cast<const uint32_t*>(x + 8));
  }
}

// One block per (head, group of windows of one kind); groups [g1, g2) are of
// kind 1, [g2, g3) of kind 2, [g3, g4) of kind 3, the first g1 of kind 0.
// From qkv (T, 3C), the kind table (kinds, nh, 144, 144) and datt (T, C), in
// x's frame, windows of the map rolled by (-shift, -shift): this head's dq |
// dk | dv into dqkv (T, 3C) and its attention output into att (T, C), and
// the group's dbias sums into part[(group, head)] (144, 144). span: the
// rows come as the 16-byte pieces around each head (C a multiple of 8, hd
// even, the bases 16-byte aligned); else unit: the elements of a copy straight into
// the rooms (2, 4 or 8: 4-, 8- or 16-byte copies), 0 element by element;
// unit also sets the stores of the outputs (bf16 pairs where it is not 0).
__global__ void __launch_bounds__(kGroupThreads, 1)
    attn_group_bwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                               const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                               bf16* __restrict__ att, float* __restrict__ part, int B, int H,
                               int W, int C, int nh, int kinds, int shift, float scale, int unit,
                               int span, int g1, int g2, int g3) {
  constexpr int N = kGroupN, NTH = kGroupThreads, LD = kGroupLd, LP = kGroupLp;
  constexpr int NT = N / 8, ACC = 4 * NT, CT = 32 / 8;  // key tiles of S; channel tiles
  constexpr int ROOMS = 4 * N * LD;                      // q, k, v, dA of a window, in bf16
  extern __shared__ __align__(16) float smem[];
  float* accs = smem;                                 // (ACC, NTH) the threads' dbias sums
  bf16* qs = reinterpret_cast<bf16*>(accs + N * N);   // (4, N, LD) rooms: q, k, v, dA
  bf16* raw = qs + ROOMS;                             // (4, N, LD) the next window's pieces
  bf16* pt = raw + ROOMS;                             // (N, LP) bf16(P), then bf16(scale dS)
  bf16* ks = qs + N * LD;
  bf16* vs = ks + N * LD;
  bf16* das = vs + N * LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  const int row0 = 16 * warp;  // this warp's row tile (S, dP, att, dQ) and key tile (dV, dK)
  const int h = blockIdx.x, gi = blockIdx.y;
  const int kind = gi < g1 ? 0 : gi < g2 ? 1 : gi < g3 ? 2 : 3;
  const int nwh = H / kGroupWs, nww = W / kGroupWs, hd = C / nh;
  int rows, cols;
  kind_grid(kinds, kind, nwh, nww, rows, cols);
  const int m0 = (gi - (kind == 0 ? 0 : kind == 1 ? g1 : kind == 2 ? g2 : g3)) * kGroupWindows;
  const int m1 = min(B * rows * cols, m0 + kGroupWindows);
  const long long C3 = 3LL * C;
  const float* table = bias + ((size_t)kind * nh + h) * N * N;
  const int ub = 2 * unit, units = unit ? hd / unit : 0;
  constexpr std::false_type kRows{};  // tile_product's A: the tile's rows
  constexpr std::true_type kCols{};   // or its columns (the transpose)
  struct Win {
    int b, wi, wj;
  };
  auto window = [&](int m) {  // window m of the group's kind
    const int r = m % (rows * cols);
    return Win{m / (rows * cols), kinds == 1 || !(kind & 2) ? r / cols : nwh - 1,
               kinds == 1 || !(kind & 1) ? r % cols : nww - 1};
  };
  auto token = [&](const Win& w, int row) {
    return roll_token(w.b, w.wi, w.wj, row, H, W, kGroupWs, kGroupWs, shift);
  };
  // span: q, k, v and dA of window m as the 16-byte pieces that hold each
  // head row (its first element p = h hd mod 8 into the first, at most five
  // pieces, ceil((p + hd) / 8)), eight lanes a row, into raw (cp.async, one
  // group); unpack then moves them into the rooms, half a warp a row, a lane
  // a bf16 pair, the padding past hd left zero.
  const int p0 = h * hd % 8, pieces = (p0 + hd + 7) / 8;
  auto raw_in = [&](int m) {
    const Win w = window(m);
#pragma unroll 1
    for (int q = 4 * warp + lane / 8; q < 4 * N; q += NTH / 8) {
      const int t = q / N, row = q % N, u = lane % 8;
      if (u < pieces) {
        const long long tk = token(w, row);
        const bf16* src = (t < 3 ? qkv + tk * C3 + t * C : datt + tk * C) + h * hd - p0 + 8 * u;
        cp_async16(reinterpret_cast<float*>(raw + (t * N + row) * LD + 8 * u),
                   reinterpret_cast<const float*>(src), 16);
      }
    }
    cp_async_commit();
  };
  auto unpack = [&]() {
#pragma unroll 2
    for (int q = 2 * warp + lane / 16; q < 4 * N; q += NTH / 16) {
      const int c = 2 * (lane % 16);
      if (c < hd)
        *reinterpret_cast<uint32_t*>(qs + q * LD + c) =
            *reinterpret_cast<const uint32_t*>(raw + q * LD + p0 + c);
    }
  };
  // else q, k, v and dA of window m straight into the rooms, half a warp a
  // row, a lane a copy (hd / unit <= 16), or, unit 0, a warp a row and a lane
  // an element
  auto rows_in = [&](int m) {
    bf16* room = qs;
    const Win w = window(m);
    if (unit) {
#pragma unroll 1
      for (int p = 2 * warp + lane / 16; p < 4 * N; p += NTH / 16) {
        const int t = p / N, row = p % N, u = lane % 16;
        if (u < units) {
          const long long tk = token(w, row);
          const bf16* src = (t < 3 ? qkv + tk * C3 + t * C : datt + tk * C) + h * hd + u * unit;
          cp_async_unit(room + (t * N + row) * LD + u * unit, src, ub, ub);
        }
      }
    } else {
#pragma unroll 1
      for (int p = warp; p < 4 * N; p += NTH / 32) {
        const int t = p / N, row = p % N;
        const long long tk = token(w, row);
        const bf16* src = (t < 3 ? qkv + tk * C3 + t * C : datt + tk * C) + h * hd;
        if (lane < hd) room[(t * N + row) * LD + lane] = src[lane];
      }
    }
    cp_async_commit();
  };
  // o (CT channel tiles) = A X over the N keys or rows: A the 16 x N rows at
  // `a` (a_t kCols: A(m, k) = a[k * LP + m], the transpose), X (N, LD) at x
  // through ldmatrix.trans; then to dst + token(row) * ld + off at this
  // warp's 16 rows (window rows, or keys), rounded to bf16, the channels past
  // hd left out: bf16 pairs (unit > 0: hd, C and the base even) or single
  // elements.
  auto tile_product = [&](auto a_t, const bf16* a, const bf16* x, const Win& w, bf16* dst,
                          long long ld, long long off) {
    float o[CT][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t fa[4], b0, b1;
      if constexpr (decltype(a_t)::value)
        ldmatrix_a_trans(fa, a + k0 * LP, LP);
      else
        load_a_pairs(fa, a + k0, LP);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        ldmatrix_b_trans(b0, b1, x + k0 * LD + 8 * j, LD);
        mma_bf16(o[j], fa, b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* d = dst + token(w, row0 + g + 8 * i) * ld + off;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = 8 * j + 2 * q4;
        if (unit) {
          if (c < hd)
            *reinterpret_cast<uint32_t*>(d + c) = pack_f32(o[j][2 * i], o[j][2 * i + 1]);
        } else {
          if (c < hd) d[c] = f2bf(o[j][2 * i]);
          if (c + 1 < hd) d[c + 1] = f2bf(o[j][2 * i + 1]);
        }
      }
    }
  };
  for (int e = tid; e < ROOMS / 2; e += NTH)  // the rooms' padding past hd stays zero
    reinterpret_cast<uint32_t*>(qs)[e] = 0u;
#pragma unroll
  for (int i = 0; i < ACC; ++i) accs[i * NTH + tid] = 0.f;
  __syncthreads();
  if (span && m0 < m1) raw_in(m0);
#pragma unroll 1
  for (int m = m0; m < m1; ++m) {
    const Win w = window(m);
    if (span) {
      cp_async_wait_all();
      __syncthreads();  // this window's pieces have landed; the last window is done
      unpack();
    } else {
      __syncthreads();  // the last window is done with the rooms
      rows_in(m);
      cp_async_wait_all();
    }
    __syncthreads();  // the rooms are whole (raw is free)
    if (span && m + 1 < m1) raw_in(m + 1);  // the next window's pieces, in flight meanwhile
    // S = q k^T scale + bias over all the keys; the softmax inside the warp
    // (a row lies in the four lanes of a quad), P kept in s
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 16) {
      uint32_t a[4];
      load_a_pairs(a, qs + row0 * LD + k0, LD);
      mma_rows<NT>(s, a, ks + k0, LD);
    }
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 bb = __ldg(
            reinterpret_cast<const float2*>(table + (row0 + g + 8 * i) * N + 8 * j + 2 * q4));
        s[j][2 * i] = s[j][2 * i] * scale + bb.x;
        s[j][2 * i + 1] = s[j][2 * i + 1] * scale + bb.y;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // exp as 2^(x log2 e): one MUFU.EX2, ~2 ulp
        s[j][e] = exp2f((s[j][e] - mx[e / 2]) * 1.4426950408889634f);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      const float inv = 1.f / sum[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * i] *= inv;
        s[j][2 * i + 1] *= inv;
        *reinterpret_cast<uint32_t*>(pt + (row0 + g + 8 * i) * LP + 8 * j + 2 * q4) =
            pack_f32(s[j][2 * i], s[j][2 * i + 1]);
      }
    }
    __syncthreads();  // bf16(P) is whole
    tile_product(kRows, pt + row0 * LP, vs, w, att, C, (long long)h * hd);  // att = bf16(P) v
    tile_product(kCols, pt + row0, das, w, dqkv, C3, 2LL * C + h * hd);     // dV = bf16(P)^T dA
    // dP = dA v^T an 8-key tile at a time, twice: for rowsum(P dP), then for
    // dS (the same products in the same order), so a thread holds P and one
    // tile of dP
    uint32_t da[2][4];
    load_a_pairs(da[0], das + row0 * LD, LD);
    load_a_pairs(da[1], das + row0 * LD + 16, LD);
    auto dp_tile = [&](int j, float (&d)[4]) {
      const bf16* x = vs + (8 * j + g) * LD + 2 * q4;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        mma_bf16(d, da[k], *reinterpret_cast<const uint32_t*>(x + 16 * k),
                 *reinterpret_cast<const uint32_t*>(x + 16 * k + 8));
    };
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
      dp_tile(j, d);
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e / 2] = fmaf(s[j][e], d[e], delta[e / 2]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
    __syncthreads();  // every warp is done with bf16(P)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
      dp_tile(j, d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float d0 = s[j][2 * i] * (d[2 * i] - delta[i]);
        const float d1 = s[j][2 * i + 1] * (d[2 * i + 1] - delta[i]);
        accs[(4 * j + 2 * i) * NTH + tid] += d0;
        accs[(4 * j + 2 * i + 1) * NTH + tid] += d1;
        *reinterpret_cast<uint32_t*>(pt + (row0 + g + 8 * i) * LP + 8 * j + 2 * q4) =
            pack_f32(scale * d0, scale * d1);
      }
    }
    __syncthreads();  // bf16(scale dS) is whole
    tile_product(kRows, pt + row0 * LP, ks, w, dqkv, C3, (long long)h * hd);  // dQ = dS k
    tile_product(kCols, pt + row0, qs, w, dqkv, C3, (long long)C + h * hd);    // dK = dS^T q
  }
  // the group's dbias sums, at each thread's (row, key) pairs
  float* dst = part + ((size_t)gi * nh + h) * N * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(dst + (row0 + g + 8 * i) * N + 8 * j + 2 * q4) =
          make_float2(accs[(4 * j + 2 * i) * NTH + tid], accs[(4 * j + 2 * i + 1) * NTH + tid]);
}

// dbias[kind] (nh, n, n; `per` floats) = the sums of the kind's groups, in
// order: part (groups, nh, n, n), groups [goff[kind], goff[kind + 1]).
__global__ void __launch_bounds__(kThreads)
    dbias_group_sum_kernel(const float* __restrict__ part, int kinds, long long per, int g1,
                           int g2, int g3, int g4, float* __restrict__ dbias) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= kinds * per) return;
  const int kind = (int)(i / per);
  const int lo = kind == 0 ? 0 : kind == 1 ? g1 : kind == 2 ? g2 : g3;
  const int hi = kind == 0 ? g1 : kind == 1 ? g2 : kind == 2 ? g3 : g4;
  const long long off = i % per;
  float acc = 0.f;
  for (int gr = lo; gr < hi; ++gr) acc += __ldg(part + (size_t)gr * per + off);
  dbias[i] = acc;
}

// Floats of the groups' dbias sums (B, H, W the map; 12x12 windows).
inline long long attn_group_part_floats(int B, int H, int W, int nh, int kinds) {
  int goff[5];
  attn_groups(B, H / kGroupWs, W / kGroupWs, kinds, goff);
  return (long long)goff[4] * nh * kGroupN * kGroupN;
}

// The copy unit of attn_group_bwd_bf16_kernel, in elements: the widest 16-,
// 8- or 4-byte piece that the heads' offsets (hd), C and the four tensors'
// bases allow; 0 (element by element) where none does (an odd hd).
inline int attn_group_unit(const void* qkv, const void* datt, const void* dqkv, const void* att,
                           int C, int nh) {
  const int hd = C / nh;
  const uintptr_t base = reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(datt) |
                         reinterpret_cast<uintptr_t>(dqkv) | reinterpret_cast<uintptr_t>(att);
  for (int u = 8; u >= 2; u /= 2)
    if (hd % u == 0 && C % u == 0 && base % (2 * u) == 0) return u;
  return 0;
}

// #6's bf16 window attention over the (B, H/12, W/12) windows: dqkv, att and
// dbias (kinds, nh, 144, 144) through `part` (attn_group_part_floats).
inline cudaError_t attn_group_bwd_bf16(const bf16* qkv, const float* bias, const bf16* datt,
                                       bf16* dqkv, bf16* att, float* part, float* dbias, int B,
                                       int H, int W, int C, int nh, int kinds, int shift,
                                       float scale, cudaStream_t stream) {
  int goff[5];
  attn_groups(B, H / kGroupWs, W / kGroupWs, kinds, goff);
  const long long per = (long long)nh * kGroupN * kGroupN;
  if (goff[4] > 0) {
    const int bytes = attn_group_smem_bytes();
    const cudaError_t err = cudaFuncSetAttribute(
        attn_group_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const bool span = C % 8 == 0 && C / nh % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(datt)) %
                              16 ==
                          0;
    attn_group_bwd_bf16_kernel<<<dim3(nh, goff[4]), kGroupThreads, bytes, stream>>>(
        qkv, bias, datt, dqkv, att, part, B, H, W, C, nh, kinds, shift, scale,
        attn_group_unit(qkv, datt, dqkv, att, C, nh), span, goff[1], goff[2], goff[3]);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return e2;
  }
  dbias_group_sum_kernel<<<(unsigned)((kinds * per + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(part, kinds, per, goff[1], goff[2], goff[3], goff[4], dbias);
  return cudaGetLastError();
}

}  // namespace trr
