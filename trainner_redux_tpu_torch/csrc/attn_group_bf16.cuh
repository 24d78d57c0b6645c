// The bf16 window attention over groups of windows of one bias kind, for
// sm_90a: #6's bf16 window attention (12x12 windows, n 144), #8's bf16 form
// at heads of up to 32 channels (n 64, 128 and 256) and #1's bf16 window
// attention (n 144). Each sums dbias inside the kernel as the JAX kernels do
// (trainner_redux_tpu/ops/pallas/fused_block.py:557-618 and
// ops/pallas/window_attention.py:240-288: dbias_ref, the (kinds, nh, n, n)
// sums in VMEM over the windows the kernel walks, one write at the end), and
// no per-window dS reaches device memory.
//
// The functions, with the JAX kernels' rounding points: P = softmax(q k^T
// scale + bias) in fp32; att = bf16(bf16(P) v); dV = bf16(P)^T dA; dP = dA
// v^T; dS = P (dP - rowsum(P dP)) in fp32, summed into dbias; dQ =
// bf16(scale dS) k and dK = bf16(scale dS)^T q; dq, dk, dv rounded to bf16.
//
// What bounds them on the card. #6 at SRFormerV2's block (B 16, 72x72, C
// 240, 8 heads of 30: 4,608 (window, head) pairs): six products of 1.3 MFLOP
// a pair (heads padded to 32 channels), 36.7 GFLOP, 37 us on the bf16 tensor
// cores; its rows, qkv, datt, dqkv and att in bf16, 318 MB, 95 us at 3.35
// TB/s: bytes, with the products close behind. #8 at HAT-M's block (B 8,
// 48x48, C 180, 6 heads of 30, 16x16 windows: 432 pairs of n 256) 8.49 GFLOP
// against 59 MB (18 us): bytes; #1's window attention at SRFormerV2's block
// 119 MB of qkv in and 40 MB of att out (48 us): bytes.
//
// What the design does about it:
//   - One block per (head, group of windows of one kind), the heads fastest,
//     so the heads of a window run together and each token's rows are read
//     while they stay in L2, and the kind's bias rows are read by the group
//     from L2. The groups list each kind's windows in order (sample, window
//     row, window column), `gw` a group, the last group of a kind taking the
//     rest. #6 takes kGroupWindows (8); #8 and #1 the most windows, up to
//     8, whose grid fills two waves of the card (group_windows): at HAT-M's
//     block, K=4, 7 a group for #8's row pass (13 groups, 312 blocks at one
//     a SM) and 3 for its key pass (26, 624 at two a SM); DAT's 8x32 branch
//     (B 8, 64x64, 3 heads) 6 (24, 288) and 3 (44, 528); SwinIR-L's ws 8 (C
//     240, 8 heads) 2 (144 groups, 1,152 blocks at three a SM); #1 at
//     SRFormerV2's block 8 (72 groups, 576 blocks at one a SM).
//   - dbias in the block: a window's dS of a block's rows lies in the
//     fragments of its warps, each the same (row, key) in every window; a
//     thread adds its entries to fp32 sums of its own in shared memory (a
//     slot a thread, so the accesses hit 32 banks), windows in order. Only the
//     group's sums go to device memory, (groups, nh, n, n) fp32;
//     dbias_group_sum_kernel adds each kind's groups in order. No atomics:
//     two runs give the same bits.
//   - Whole rows at once: a warp takes a 16-row tile over all n keys in S
//     and dP (at n 256 over half of them), so each row's max, sum and
//     rowsum(P dP) stay in the four lanes of a quad, its P in fp32 in
//     registers from the softmax to dS (dP goes an 8-key tile at a time,
//     twice: for rowsum(P dP), then for dS).
//   - bf16 stays bf16: q, k, v and dA rows are staged as bf16 (rows of 32
//     channels, zero past the head, kGroupLd = 40 elements apart), every
//     product is mma.sync m16n8k16 with fp32 sums, its operands loaded as they
//     lie (A and the [n][k] B as 32-bit pairs, the [k][n] B by
//     ldmatrix.trans), every row stride an odd number of 16-byte units, so
//     each fragment load hits 32 banks.
//   - The rows come in one window ahead, as the 16-byte pieces that hold a
//     head row on the tensor's own 16-byte grid (at most five, at any C:
//     HAT-M's 1,080-byte and DAT's 540-byte qkv rows too), four lanes a
//     row, into a raw buffer while the window before computes; a shift
//     within shared memory (unpack, 8 bytes a lane) then puts each head row
//     at the start of its room. (Copies of the head alone, 4 bytes for heads
//     of 30, kept the card's load units busy for a third of #6's time; 8-
//     and 4-byte pieces at C 180 and 90, with a lane a piece, took half of
//     the n-256 passes' time.) Where a base is off 16 bytes the rows go
//     straight into the rooms element by element, not overlapped. att, dq,
//     dk and dv go from the fragments to device memory as bf16 pairs. #6
//     keeps its own staging (16-byte pieces at C a multiple of 8).
//
// The kernels:
//   - attn_group_bwd_bf16_kernel: #6's recompute backward (N 144, 9 warps,
//     a 16-row tile each), which writes att = bf16(P) v for dwp too. The
//     window's (144, 144) fp32 sums fit a block (81 KB); bf16(P), then
//     bf16(scale dS), go through a (144, 152) bf16 tile for dV = P^T dA and
//     dK = dS^T q (ldmatrix.x4.trans), dQ and att read it as rows. One
//     block a SM (218,880 B), 168 registers, the cap of 9 warps.
//   - attn_window_bwd_bf16_kernel<N, WC>: #8 at n 64 (SwinIR-L's 8x8) and
//     n 128 (dat_s's 8x16, 16x8), #6's kernel over n without att, N / 16
//     warps: (n, n) sums of 16 and 64 KB; three blocks a SM at n 64 (66,816
//     B), one at n 128 (182,784 B). (Its n-144 instance spilled 20 bytes
//     under the 168-register cap, so #6 keeps its own kernel.)
//   - #8 at n 256 (HAT-M's and DRCT's 16x16, DAT's 8x32 and 32x8): one
//     window's (256, 256) fp32 sums take 256 KB, past a block's 227, so the
//     rows are split and the products go in two passes, each doing its own
//     sums (as the 128-wide #8 of tc_attn.cuh):
//       - the row pass (attn_group_rows_bf16_kernel): one block per (head,
//         group, block of 64 rows), 8 warps, two a 16-row tile, each over
//         half the keys (a thread's P in 64 registers: a whole row's 128
//         spilled at 255), the halves' row max, sum and rowsum(P dP)
//         combined through shared memory, half 0's then half 1's. S, the
//         softmax, dP, rowsum(P dP) and dS; dS into the block's (64, 256)
//         sums (64 KB); dQ = bf16(scale dS) k with bf16(scale dS) packed
//         from the fragments straight into the A fragments (no tile), the
//         second half's sums added to the first's through shared memory;
//         each row's max, inverse sum and rowsum(P dP) to a stats scratch
//         (B, nwh, nww, nh, 256) float4 (1.8 MB at HAT-M's block). 178,304
//         B: one block a SM.
//       - the key pass (attn_group_keys_bf16_kernel): one block per (head,
//         group, block of 64 keys), 4 warps, warp w the keys 16 w.. of the
//         block over all 256 rows, 16 rows a step: S and dP of its keys are
//         the row pass's own products in the same order (the same A and B
//         fragments, k-steps and accumulators), P = exp(S scale + bias -
//         max) / sum and dS = P (dP - rowsum(P dP)) from the stats the same
//         fp32 operations, so P and dS are the row pass's bit for bit; bf16(P)
//         and bf16(scale dS) go from the fragments into the A fragments of
//         P^T and dS^T by movmatrix.trans, and dV += P^T dA, dK += dS^T q sum
//         in registers over the rows in order. 111,232 B: two blocks a SM.
//         (A cluster of four blocks adding dK and dV through distributed
//         shared memory was not built: the key pass needs no sums across
//         blocks.)
//       - dbias_group_sum_kernel adds the row pass's groups of each kind.
//   - attn_group_fwd_bf16_kernel: #1's window attention (N 144), 9 warps, a
//     16-row tile over all 144 keys each, fp32 P in registers, bf16(P)
//     packed from the S fragments straight into the A fragments of P v (no P
//     tile), the shift indexed in the kernel. 69,552 B; one block a SM (two
//     would cap a thread at 96 registers: P spilled).
#pragma once

#include "tc_attn.cuh"

namespace trr {

constexpr int kGroupN = 144;          // tokens of a 12x12 window
constexpr int kGroupWs = 12;
constexpr int kGroupWindows = 8;      // windows a block walks, at most
constexpr int kGroupThreads = 288;    // 9 warps: a 16-row tile each
constexpr int kGroupLd = 40;          // bf16 between two staged head rows (32 channels + 8)
constexpr int kGroupLp = kGroupN + 8;  // bf16 between two rows of the P / dS tile
constexpr int kGroupSms = 132;        // the H100's SMs: group_windows fills two waves of them
constexpr int kPassRows = 64;         // n 256: rows of a row-pass block, keys of a key-pass block
constexpr int kPassThreads = 128;     // n 256: 4 warps a key-pass block, 16 keys each
constexpr int kRowPassThreads = 256;  // and 8 a row-pass block, two a 16-row tile (a key half each)
constexpr int kPassN = 256;
constexpr int kRowPassBlocks = 1;     // blocks a SM of the row pass
constexpr int kKeyPassBlocks = 2;     // and of the key pass
constexpr int kGroupFwdBlocks = 1;    // and of #1's forward

// Threads and blocks a SM of the whole-window backward at windows of n
// tokens (64, 128: attn_window_bwd_bf16_kernel; 144: #6's kernel).
__host__ __device__ constexpr int group_threads(int n) { return n / 16 * 32; }
__host__ __device__ constexpr int group_blocks(int n) { return n == 64 ? 3 : 1; }
// bf16 between two rows of its P / dS tile
__host__ __device__ constexpr int group_lp(int n) { return n + 8; }

// Shared memory of the whole-window backward, in bytes: the threads' dbias
// sums (n * n fp32), the rooms of n head rows each of q, k, v and dA, the
// raw buffer of the next window's pieces (as large), and the P / dS tile.
__host__ __device__ constexpr int attn_group_smem_bytes(int n = kGroupN) {
  return 4 * n * n + 2 * 2 * 4 * n * kGroupLd + 2 * n * group_lp(n);
}

// #8's whole-window backward at n 64 and 128 (attn_window_bwd_bf16_kernel):
// #6's layout and a byte a staged row (its offset in raw).
__host__ __device__ constexpr int attn_window_smem_bytes(int n) {
  return attn_group_smem_bytes(n) + 4 * n;
}

// The row pass's: the (64, 256) fp32 sums, the rooms of 64 q, 64 dA, 256 k
// and 256 v rows and the raw buffer, the key halves' (3, 2, 64) row values
// and (64, 32) dq sums, a byte a staged row.
__host__ __device__ constexpr int attn_rows_pass_smem_bytes() {
  return 4 * kPassRows * kPassN + 2 * 2 * (2 * kPassRows + 2 * kPassN) * kGroupLd +
         4 * (3 * 2 * kPassRows + 32 * kPassRows) + 2 * kPassRows + 2 * kPassN;
}

// The key pass's: the rooms of 256 q, 256 dA, 64 k and 64 v rows, the raw
// buffer, two windows' row stats (float4), a byte a staged row.
__host__ __device__ constexpr int attn_keys_pass_smem_bytes() {
  return 2 * 2 * (2 * kPassN + 2 * kPassRows) * kGroupLd + 2 * 16 * kPassN + 2 * kPassN +
         2 * kPassRows;
}

// #1's forward: the rooms of q, k and v, the raw buffer, a byte a staged row.
__host__ __device__ constexpr int attn_group_fwd_smem_bytes() {
  return 2 * 2 * 3 * kGroupN * kGroupLd + 3 * kGroupN;
}

// Windows of kind `kind` of a (nwh, nww) grid: rows of windows and columns
// of them a sample (kinds 1: all of them).
__host__ __device__ inline void kind_grid(int kinds, int kind, int nwh, int nww, int& rows,
                                          int& cols) {
  rows = kinds == 1 ? nwh : (kind & 2) ? 1 : nwh - 1;
  cols = kinds == 1 ? nww : (kind & 1) ? 1 : nww - 1;
}

// The groups of each kind, gw windows a group: goff[k] is the first group
// of kind k, goff[4] the total.
inline void attn_groups(int B, int nwh, int nww, int kinds, int (&goff)[5],
                        int gw = kGroupWindows) {
  goff[0] = 0;
  for (int k = 0; k < 4; ++k) {
    int rows, cols;
    kind_grid(kinds, k, nwh, nww, rows, cols);
    const int count = k < kinds ? B * rows * cols : 0;
    goff[k + 1] = goff[k] + (count + gw - 1) / gw;
  }
}

// Windows a group: the most, up to kGroupWindows, whose grid of `per_group`
// blocks a group fills two waves of `per_sm` blocks a SM; 1 if none does.
inline int group_windows(int B, int nwh, int nww, int kinds, long long per_group, int per_sm) {
  for (int gw = kGroupWindows; gw > 1; --gw) {
    int goff[5];
    attn_groups(B, nwh, nww, kinds, goff, gw);
    if (goff[4] * per_group >= 2LL * kGroupSms * per_sm) return gw;
  }
  return 1;
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

// The transpose of the 8 x 8 bf16 matrix that a warp holds as bf16 pairs
// (lane l: row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), in the same
// layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// A staged row's source: its head's first element and the end of the
// tensor that holds it.
struct HeadSrc {
  const bf16* head;
  const bf16* end;
};

// The 16-byte pieces of `rows` head rows into raw (rows kGroupLd apart),
// src(q) row q's source: the pieces on the tensor's 16-byte grid from the
// boundary p = (the head's address / 2) mod 8 elements before the head, at
// most five a row (ceil((p + hd) / 8)), the last cut at the tensor's end;
// four lanes a row, a lane pieces u and u + 4; each row's p to pr for
// unpack_rows. The tensors' bases are 16-byte aligned, so no piece starts
// before them. Issued, not committed.
template <int NTH, class Src>
__device__ __forceinline__ void pieces_in(bf16* raw, uint8_t* pr, int rows, int hd, Src src) {
#pragma unroll 1
  for (int q = threadIdx.x >> 2; q < rows; q += NTH >> 2) {
    const int u = threadIdx.x & 3;
    const HeadSrc hs = src(q);
    const int p = (int)((reinterpret_cast<uintptr_t>(hs.head) >> 1) & 7);
    const bf16* base = hs.head - p;
    if (u == 0) pr[q] = (uint8_t)p;
    for (int k = u; 8 * k < p + hd; k += 4) {
      const long long left = hs.end - (base + 8 * k);
      cp_async16(reinterpret_cast<float*>(raw + q * kGroupLd + 8 * k),
                 reinterpret_cast<const float*>(base + 8 * k),
                 left >= 8 ? 16 : (int)(2 * max(left, 0LL)));
    }
  }
}

// Each of `rows` staged rows from raw (its head p = pr[q] elements in) to
// the start of its room, eight lanes a row, a lane four channels as one
// 8-byte store, the channels past hd written as zero (the padding stays
// zero): bf16 pairs where p is even, else single elements.
template <int NTH>
__device__ __forceinline__ void unpack_rows(bf16* rooms, const bf16* raw, const uint8_t* pr,
                                            int rows, int hd) {
#pragma unroll 2
  for (int q = threadIdx.x >> 3; q < rows; q += NTH >> 3) {
    const int c = 4 * (threadIdx.x & 7), p = pr[q];
    if (c >= hd) continue;
    const bf16* x = raw + q * kGroupLd + p + c;
    uint32_t lo, hi = 0u;
    if ((p & 1) == 0) {
      lo = *reinterpret_cast<const uint32_t*>(x);
      if (c + 2 < hd) hi = *reinterpret_cast<const uint32_t*>(x + 2);
    } else {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(x);
      lo = e[0] | (uint32_t)e[1] << 16;
      if (c + 2 < hd) hi = e[2] | (uint32_t)e[3] << 16;
    }
    if (c + 1 >= hd) lo &= 0xffffu;
    if (c + 3 >= hd) hi &= 0xffffu;
    *reinterpret_cast<uint2*>(rooms + q * kGroupLd + c) = make_uint2(lo, hi);
  }
}

// `rows` head rows straight into their rooms, a warp a row and a lane an
// element (no piece fits).
template <int NTH, class Src>
__device__ __forceinline__ void rows_direct(bf16* rooms, int rows, int hd, Src src) {
#pragma unroll 1
  for (int q = threadIdx.x / 32; q < rows; q += NTH / 32) {
    const int c = threadIdx.x % 32;
    if (c < hd) rooms[q * kGroupLd + c] = src(q).head[c];
  }
}

// The 16 x (8 CT) output tile o of this warp to rows row(i) (i 0, 1: rows g
// and g + 8 of the tile), rounded to bf16, the channels past hd left out:
// bf16 pairs where `unit` is not 0 (hd, C and the base even), else single
// elements.
template <int CT, class Row>
__device__ __forceinline__ void store_tile_rows(const float (&o)[CT][4], int hd, int unit,
                                                Row row) {
  const int q4 = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* d = row(i);
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = 8 * j + 2 * q4;
      if (unit) {
        if (c < hd) *reinterpret_cast<uint32_t*>(d + c) = pack_f32(o[j][2 * i], o[j][2 * i + 1]);
      } else {
        if (c < hd) d[c] = f2bf(o[j][2 * i]);
        if (c + 1 < hd) d[c + 1] = f2bf(o[j][2 * i + 1]);
      }
    }
  }
}

// The group's kind and windows [m0, m1) of the kind's list: groups [g1, g2)
// are of kind 1, [g2, g3) of kind 2, [g3, ..) of kind 3, the first g1 of
// kind 0; gw windows a group.
struct GroupWindows {
  int kind, rows, cols, m0, m1;
};

__device__ __forceinline__ GroupWindows group_of(int gi, int gw, int g1, int g2, int g3, int B,
                                                 int nwh, int nww, int kinds) {
  GroupWindows gr;
  gr.kind = gi < g1 ? 0 : gi < g2 ? 1 : gi < g3 ? 2 : 3;
  kind_grid(kinds, gr.kind, nwh, nww, gr.rows, gr.cols);
  gr.m0 = (gi - (gr.kind == 0 ? 0 : gr.kind == 1 ? g1 : gr.kind == 2 ? g2 : g3)) * gw;
  gr.m1 = min(B * gr.rows * gr.cols, gr.m0 + gw);
  return gr;
}

struct Win {
  int b, wi, wj;
};

// Window m of the group's kind.
__device__ __forceinline__ Win window_of(const GroupWindows& gr, int m, int kinds, int nwh,
                                         int nww) {
  const int r = m % (gr.rows * gr.cols);
  return Win{m / (gr.rows * gr.cols), kinds == 1 || !(gr.kind & 2) ? r / gr.cols : nwh - 1,
             kinds == 1 || !(gr.kind & 1) ? r % gr.cols : nww - 1};
}

// S = q k^T scale + bias over the NT key tiles for this warp's 16 rows
// (q rows at qs, LD apart; k rows at ks; the bias rows of this warp's rows
// at table, n apart), the row softmax inside the warp (a row lies in the
// four lanes of a quad): P in s (unnormalised: exp(S - max)), each row's
// max in mx and inverse sum in inv.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], float (&mx)[2], float (&inv)[2],
                                             const bf16* qs, const bf16* ks, const float* table,
                                             float scale) {
  constexpr int N = 8 * NT, LD = kGroupLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 16) {
    uint32_t a[4];
    load_a_pairs(a, qs + k0, LD);
    mma_rows<NT>(s, a, ks + k0, LD);
  }
  float sum[2] = {0.f, 0.f};
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 bb =
          __ldg(reinterpret_cast<const float2*>(table + (g + 8 * i) * N + 8 * j + 2 * q4));
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
    inv[i] = 1.f / sum[i];
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

// #8's bf16 form at n 64 and 128: #6's kernel over n, without att. One
// block per (head, group of windows of one kind). From qkv (T, 3C), the kind
// table (kinds, nh, N, N) and datt (T, C), in x's frame, windows of WR x WC
// (WR = N / WC; no shift: the caller rolls): this head's dq | dk | dv into
// dqkv (T, 3C) and the group's dbias sums into part[(group, head)] (N, N).
// pieces: the rows come as 16-byte pieces (pieces_in), else element by
// element; unit the stores of the outputs (bf16 pairs where it is not 0).
template <int N, int WC>
__global__ void __launch_bounds__(group_threads(N), group_blocks(N))
    attn_window_bwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                                float* __restrict__ part, int B, int H, int W, int C, int nh,
                                int kinds, float scale, int unit, int pieces, int gw, int g1,
                                int g2, int g3) {
  constexpr int NTH = group_threads(N), LD = kGroupLd, LP = group_lp(N), WR = N / WC;
  constexpr int NT = N / 8, ACC = 4 * NT, CT = 32 / 8;  // key tiles of S; channel tiles
  constexpr int ROOMS = 4 * N * LD;                      // q, k, v, dA of a window, in bf16
  extern __shared__ __align__(16) float smem[];
  float* accs = smem;                                 // (ACC, NTH) the threads' dbias sums
  bf16* qs = reinterpret_cast<bf16*>(accs + N * N);   // (4, N, LD) rooms: q, k, v, dA
  bf16* raw = qs + ROOMS;                             // (4, N, LD) the next window's pieces
  bf16* pt = raw + ROOMS;                             // (N, LP) bf16(P), then bf16(scale dS)
  uint8_t* pr = reinterpret_cast<uint8_t*>(pt + N * LP);  // (4 N) the staged rows' offsets
  bf16* ks = qs + N * LD;
  bf16* vs = ks + N * LD;
  bf16* das = vs + N * LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  const int row0 = 16 * warp;  // this warp's row tile (S, dP, att, dQ) and key tile (dV, dK)
  const int h = blockIdx.x, gi = blockIdx.y;
  const int nwh = H / WR, nww = W / WC, hd = C / nh;
  const GroupWindows gr = group_of(gi, gw, g1, g2, g3, B, nwh, nww, kinds);
  const long long C3 = 3LL * C;
  const float* table = bias + ((size_t)gr.kind * nh + h) * N * N;
  const bf16* qkv_end = qkv + (long long)B * H * W * C3;
  const bf16* datt_end = datt + (long long)B * H * W * C;
  constexpr std::false_type kRows{};  // tile_product's A: the tile's rows
  constexpr std::true_type kCols{};   // or its columns (the transpose)
  auto token = [&](const Win& w, int row) {
    return roll_token(w.b, w.wi, w.wj, row, H, W, WR, WC, 0);
  };
  // row q of the window's staged rows: q, k, v, dA, N rows each
  auto src_of = [&](const Win& w) {
    return [&, w](int q) {
      const int t = q / N;
      const long long tk = token(w, q % N);
      return t < 3 ? HeadSrc{qkv + tk * C3 + t * C + h * hd, qkv_end}
                   : HeadSrc{datt + tk * C + h * hd, datt_end};
    };
  };
  // o (CT channel tiles) = A X over the N keys or rows: A the 16 x N rows at
  // `a` (a_t kCols: A(m, k) = a[k * LP + m], the transpose), X (N, LD) at x
  // through ldmatrix.trans; then to dst + token(row) * ld + off at this
  // warp's 16 rows (window rows, or keys), rounded to bf16.
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
    store_tile_rows<CT>(o, hd, unit,
                        [&](int i) { return dst + token(w, row0 + g + 8 * i) * ld + off; });
  };
  for (int e = tid; e < ROOMS / 2; e += NTH)  // the rooms' padding past hd stays zero
    reinterpret_cast<uint32_t*>(qs)[e] = 0u;
#pragma unroll
  for (int i = 0; i < ACC; ++i) accs[i * NTH + tid] = 0.f;
  __syncthreads();
  if (pieces && gr.m0 < gr.m1) {
    pieces_in<NTH>(raw, pr, 4 * N, hd, src_of(window_of(gr, gr.m0, kinds, nwh, nww)));
    cp_async_commit();
  }
#pragma unroll 1
  for (int m = gr.m0; m < gr.m1; ++m) {
    const Win w = window_of(gr, m, kinds, nwh, nww);
    if (pieces) {
      cp_async_wait_all();
      __syncthreads();  // this window's pieces have landed; the last window is done
      unpack_rows<NTH>(qs, raw, pr, 4 * N, hd);
    } else {
      __syncthreads();  // the last window is done with the rooms
      rows_direct<NTH>(qs, 4 * N, hd, src_of(w));
    }
    __syncthreads();  // the rooms are whole (raw is free)
    if (pieces && m + 1 < gr.m1) {  // the next window's pieces, in flight meanwhile
      pieces_in<NTH>(raw, pr, 4 * N, hd, src_of(window_of(gr, m + 1, kinds, nwh, nww)));
      cp_async_commit();
    }
    float s[NT][4], mx[2], inv[2];
    softmax_rows<NT>(s, mx, inv, qs + row0 * LD, ks, table + row0 * N, scale);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * i] *= inv[i];
        s[j][2 * i + 1] *= inv[i];
        *reinterpret_cast<uint32_t*>(pt + (row0 + g + 8 * i) * LP + 8 * j + 2 * q4) =
            pack_f32(s[j][2 * i], s[j][2 * i + 1]);
      }
    __syncthreads();  // bf16(P) is whole
    tile_product(kCols, pt + row0, das, w, dqkv, C3, 2LL * C + h * hd);       // dV = bf16(P)^T dA
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

// #8's row pass at n 256: one block per (head, group of windows of one
// kind, block of 64 rows). From qkv (T, 3C), the kind table (kinds, nh,
// 256, 256) and datt (T, C), windows of WR x WC (no shift: the caller rolls):
// dq into dqkv (T, 3C), the group's dbias sums of the block's rows into
// part[(group, head)] (256, 256), and each row's (max, inverse sum,
// rowsum(P dP)) into stats (B, nwh, nww, nh, 256) float4.
template <int WC>
__global__ void __launch_bounds__(kRowPassThreads, kRowPassBlocks)
    attn_group_rows_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                                float* __restrict__ part, float4* __restrict__ stats, int B,
                                int H, int W, int C, int nh, int kinds, float scale, int unit,
                                int pieces, int gw, int g1, int g2, int g3) {
  constexpr int N = kPassN, RB = kPassRows, NTH = kRowPassThreads, LD = kGroupLd, WR = N / WC;
  constexpr int NK = N / 2, NT = NK / 8, ACC = 4 * NT, CT = 32 / 8;  // a warp's keys: a half
  constexpr int ROWS = 2 * RB + 2 * N;  // staged rows: q and dA of the row block, k, v
  extern __shared__ __align__(16) float smem[];
  float* accs = smem;                                // (ACC, NTH) the threads' dbias sums
  bf16* qs = reinterpret_cast<bf16*>(accs + RB * N);  // rooms: q (RB), dA (RB), k (N), v (N)
  bf16* das = qs + RB * LD;
  bf16* ks = das + RB * LD;
  bf16* vs = ks + N * LD;
  bf16* raw = qs + ROWS * LD;                      // (ROWS, LD) the next window's pieces
  float* red = reinterpret_cast<float*>(raw + ROWS * LD);  // (3, 2, RB): each half's row max,
                                                           // sum and rowsum(P dP)
  float* xq = red + 3 * 2 * RB;                    // (RB, 32) the second halves' dq sums
  uint8_t* pr = reinterpret_cast<uint8_t*>(xq + RB * 32);  // (ROWS) the staged rows' offsets
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  const int h = blockIdx.x, gi = blockIdx.y, r0 = RB * blockIdx.z;
  const int lrow = 16 * (warp / 2), kp = warp % 2;  // this warp's 16 rows of the block, key half
  const int row0 = r0 + lrow;                       // and of the window
  const bf16* kh = ks + kp * NK * LD;
  const bf16* vh = vs + kp * NK * LD;
  const int nwh = H / WR, nww = W / WC, hd = C / nh;
  const GroupWindows gr = group_of(gi, gw, g1, g2, g3, B, nwh, nww, kinds);
  const long long C3 = 3LL * C;
  const float* table = bias + ((size_t)gr.kind * nh + h) * N * N + (size_t)row0 * N + kp * NK;
  const bf16* qkv_end = qkv + (long long)B * H * W * C3;
  const bf16* datt_end = datt + (long long)B * H * W * C;
  auto token = [&](const Win& w, int row) {
    return roll_token(w.b, w.wi, w.wj, row, H, W, WR, WC, 0);
  };
  auto src_of = [&](const Win& w) {
    return [&, w](int q) {
      if (q < 2 * RB) {  // q, then dA, of the row block
        const long long tk = token(w, r0 + q % RB);
        return q < RB ? HeadSrc{qkv + tk * C3 + h * hd, qkv_end}
                      : HeadSrc{datt + tk * C + h * hd, datt_end};
      }
      const int t = (q - 2 * RB) / N;  // k, then v
      return HeadSrc{qkv + token(w, (q - 2 * RB) % N) * C3 + (t + 1) * C + h * hd, qkv_end};
    };
  };
  // the two halves' row values v[i] (rows g, g + 8) through red[which]:
  // half 0's, then half 1's, combined by f
  auto exchange = [&](int which, float (&v)[2], auto f) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[i] = f(v[i], __shfl_xor_sync(0xffffffffu, v[i], 1));
      v[i] = f(v[i], __shfl_xor_sync(0xffffffffu, v[i], 2));
      if (q4 == 0) red[(2 * which + kp) * RB + lrow + g + 8 * i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[i] = f(red[2 * which * RB + lrow + g + 8 * i],
               red[(2 * which + 1) * RB + lrow + g + 8 * i]);
  };
  const auto fmax2 = [](float x, float y) { return fmaxf(x, y); };
  const auto add2 = [](float x, float y) { return x + y; };
  for (int e = tid; e < ROWS * LD / 2; e += NTH)  // the rooms' padding past hd stays zero
    reinterpret_cast<uint32_t*>(qs)[e] = 0u;
#pragma unroll
  for (int i = 0; i < ACC; ++i) accs[i * NTH + tid] = 0.f;
  __syncthreads();
  if (pieces && gr.m0 < gr.m1) {
    pieces_in<NTH>(raw, pr, ROWS, hd, src_of(window_of(gr, gr.m0, kinds, nwh, nww)));
    cp_async_commit();
  }
#pragma unroll 1
  for (int m = gr.m0; m < gr.m1; ++m) {
    const Win w = window_of(gr, m, kinds, nwh, nww);
    if (pieces) {
      cp_async_wait_all();
      __syncthreads();  // this window's pieces have landed; the last window is done
      unpack_rows<NTH>(qs, raw, pr, ROWS, hd);
    } else {
      __syncthreads();
      rows_direct<NTH>(qs, ROWS, hd, src_of(w));
    }
    __syncthreads();  // the rooms are whole (raw is free)
    if (pieces && m + 1 < gr.m1) {
      pieces_in<NTH>(raw, pr, ROWS, hd, src_of(window_of(gr, m + 1, kinds, nwh, nww)));
      cp_async_commit();
    }
    // S = q k^T scale + bias over this half's keys; the row max and sum
    // over both halves
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 16) {
      uint32_t a[4];
      load_a_pairs(a, qs + lrow * LD + k0, LD);
      mma_rows<NT>(s, a, kh + k0, LD);
    }
    float mx[2] = {-INFINITY, -INFINITY}, inv[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(table + (g + 8 * i) * N + 8 * j + 2 * q4));
        s[j][2 * i] = s[j][2 * i] * scale + bb.x;
        s[j][2 * i + 1] = s[j][2 * i + 1] * scale + bb.y;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
    exchange(0, mx, fmax2);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // exp as 2^(x log2 e): one MUFU.EX2, ~2 ulp
        s[j][e] = exp2f((s[j][e] - mx[e / 2]) * 1.4426950408889634f);
        inv[e / 2] += s[j][e];
      }
    exchange(1, inv, add2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      inv[i] = 1.f / inv[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * i] *= inv[i];
        s[j][2 * i + 1] *= inv[i];
      }
    }
    uint32_t da[2][4];
    load_a_pairs(da[0], das + lrow * LD, LD);
    load_a_pairs(da[1], das + lrow * LD + 16, LD);
    auto dp_tile = [&](int j, float (&d)[4]) {
      const bf16* x = vh + (8 * j + g) * LD + 2 * q4;
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
    exchange(2, delta, add2);
    if (kp == 0 && q4 == 0) {
      float4* st = stats + ((((size_t)w.b * nwh + w.wi) * nww + w.wj) * nh + h) * N + row0 + g;
      st[0] = make_float4(mx[0], inv[0], delta[0], 0.f);
      st[8] = make_float4(mx[1], inv[1], delta[1], 0.f);
    }
    // dS into the sums and, two key tiles a k-step, bf16(scale dS) into the
    // A fragments of this half's dQ = dS k
    float dq[CT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = 2 * kk + t;
        float d[4];
        dp_tile(j, d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d0 = s[j][2 * i] * (d[2 * i] - delta[i]);
          const float d1 = s[j][2 * i + 1] * (d[2 * i + 1] - delta[i]);
          accs[(4 * j + 2 * i) * NTH + tid] += d0;
          accs[(4 * j + 2 * i + 1) * NTH + tid] += d1;
          a[2 * t + i] = pack_f32(scale * d0, scale * d1);
        }
      }
#pragma unroll
      for (int jc = 0; jc < CT; ++jc) {
        uint32_t b0, b1;
        ldmatrix_b_trans(b0, b1, kh + 16 * kk * LD + 8 * jc, LD);
        mma_bf16(dq[jc], a, b0, b1);
      }
    }
    // dq: the first half's sums plus the second's, through xq
    if (kp == 1)
#pragma unroll
      for (int jc = 0; jc < CT; ++jc)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(xq + (lrow + g + 8 * i) * 32 + 8 * jc + 2 * q4) =
              make_float2(dq[jc][2 * i], dq[jc][2 * i + 1]);
    __syncthreads();
    if (kp == 0) {
#pragma unroll
      for (int jc = 0; jc < CT; ++jc)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 o =
              *reinterpret_cast<const float2*>(xq + (lrow + g + 8 * i) * 32 + 8 * jc + 2 * q4);
          dq[jc][2 * i] += o.x;
          dq[jc][2 * i + 1] += o.y;
        }
      store_tile_rows<CT>(dq, hd, unit, [&](int i) {
        return dqkv + token(w, row0 + g + 8 * i) * C3 + h * hd;
      });
    }
  }
  float* dst = part + ((size_t)gi * nh + h) * N * N + (size_t)row0 * N + kp * NK;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(dst + (g + 8 * i) * N + 8 * j + 2 * q4) =
          make_float2(accs[(4 * j + 2 * i) * NTH + tid], accs[(4 * j + 2 * i + 1) * NTH + tid]);
}

// #8's key pass at n 256: one block per (head, group of windows of one
// kind, block of 64 keys). From qkv, the kind table, datt and the row
// pass's stats: dk and dv of the block's keys into dqkv.
template <int WC>
__global__ void __launch_bounds__(kPassThreads, kKeyPassBlocks)
    attn_group_keys_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                const bf16* __restrict__ datt, bf16* __restrict__ dqkv,
                                const float4* __restrict__ stats, int B, int H, int W, int C,
                                int nh, int kinds, float scale, int unit, int pieces, int gw,
                                int g1, int g2, int g3) {
  constexpr int N = kPassN, KB = kPassRows, NTH = kPassThreads, LD = kGroupLd, WR = N / WC;
  constexpr int CT = 32 / 8;
  constexpr int ROWS = 2 * N + 2 * KB;  // staged rows: q and dA of every row, k and v of the keys
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // rooms: q (N), dA (N), k (KB), v (KB)
  bf16* das = qs + N * LD;
  bf16* ks = das + N * LD;
  bf16* vs = ks + KB * LD;
  bf16* raw = qs + ROWS * LD;                              // (ROWS, LD) the next window's pieces
  float4* sts = reinterpret_cast<float4*>(raw + ROWS * LD);  // (2, N) the windows' row stats
  uint8_t* pr = reinterpret_cast<uint8_t*>(sts + 2 * N);      // (ROWS) the staged rows' offsets
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  const int h = blockIdx.x, gi = blockIdx.y, k0 = KB * blockIdx.z;
  const int key0 = k0 + 16 * warp;  // this warp's 16 keys of the window
  const int nwh = H / WR, nww = W / WC, hd = C / nh;
  const GroupWindows gr = group_of(gi, gw, g1, g2, g3, B, nwh, nww, kinds);
  const long long C3 = 3LL * C;
  const float* table = bias + ((size_t)gr.kind * nh + h) * N * N + key0;
  const bf16* qkv_end = qkv + (long long)B * H * W * C3;
  const bf16* datt_end = datt + (long long)B * H * W * C;
  auto token = [&](const Win& w, int row) {
    return roll_token(w.b, w.wi, w.wj, row, H, W, WR, WC, 0);
  };
  auto src_of = [&](const Win& w) {
    return [&, w](int q) {
      if (q < 2 * N) {  // q, then dA, of every row
        const long long tk = token(w, q % N);
        return q < N ? HeadSrc{qkv + tk * C3 + h * hd, qkv_end}
                     : HeadSrc{datt + tk * C + h * hd, datt_end};
      }
      const int t = (q - 2 * N) / KB;  // k, then v, of the block's keys
      return HeadSrc{qkv + token(w, k0 + (q - 2 * N) % KB) * C3 + (t + 1) * C + h * hd,
                     qkv_end};
    };
  };
  auto stats_in = [&](const Win& w, int buf) {  // the window's row stats, 16 bytes a copy
    const float4* src = stats + ((((size_t)w.b * nwh + w.wi) * nww + w.wj) * nh + h) * N;
    for (int r = tid; r < N; r += NTH)
      cp_async16(reinterpret_cast<float*>(sts + buf * N + r),
                 reinterpret_cast<const float*>(src + r), 16);
  };
  for (int e = tid; e < ROWS * LD / 2; e += NTH)  // the rooms' padding past hd stays zero
    reinterpret_cast<uint32_t*>(qs)[e] = 0u;
  __syncthreads();
  if (pieces && gr.m0 < gr.m1) {
    const Win w = window_of(gr, gr.m0, kinds, nwh, nww);
    pieces_in<NTH>(raw, pr, ROWS, hd, src_of(w));
    stats_in(w, 0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int m = gr.m0; m < gr.m1; ++m) {
    const Win w = window_of(gr, m, kinds, nwh, nww);
    const int buf = (m - gr.m0) & 1;
    if (pieces) {
      cp_async_wait_all();
      __syncthreads();  // this window's pieces and stats have landed; the last window is done
      unpack_rows<NTH>(qs, raw, pr, ROWS, hd);
    } else {
      __syncthreads();
      rows_direct<NTH>(qs, ROWS, hd, src_of(w));
      stats_in(w, buf);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();  // the rooms and stats are whole (raw is free)
    if (pieces && m + 1 < gr.m1) {
      const Win wn = window_of(gr, m + 1, kinds, nwh, nww);
      pieces_in<NTH>(raw, pr, ROWS, hd, src_of(wn));
      stats_in(wn, buf ^ 1);
      cp_async_commit();
    }
    const float4* st = sts + buf * N;
    // the B fragments of this warp's keys, k for S and v for dP: [key tile][k-step]
    uint32_t kf[2][2][2], vf[2][2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int off = (16 * warp + 8 * t + g) * LD + 16 * k + 2 * q4;
        kf[t][k][0] = *reinterpret_cast<const uint32_t*>(ks + off);
        kf[t][k][1] = *reinterpret_cast<const uint32_t*>(ks + off + 8);
        vf[t][k][0] = *reinterpret_cast<const uint32_t*>(vs + off);
        vf[t][k][1] = *reinterpret_cast<const uint32_t*>(vs + off + 8);
      }
    float dv[CT][4] = {}, dk[CT][4] = {};
#pragma unroll 2
    for (int rc = 0; rc < N; rc += 16) {  // 16 rows a step
      uint32_t qa[2][4], daa[2][4];
      load_a_pairs(qa[0], qs + rc * LD, LD);
      load_a_pairs(qa[1], qs + rc * LD + 16, LD);
      load_a_pairs(daa[0], das + rc * LD, LD);
      load_a_pairs(daa[1], das + rc * LD + 16, LD);
      float s[2][4], d[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = d[t][e] = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) mma_bf16(s[t], qa[k], kf[t][k][0], kf[t][k][1]);
#pragma unroll
        for (int k = 0; k < 2; ++k) mma_bf16(d[t], daa[k], vf[t][k][0], vf[t][k][1]);
      }
      const float4 sr[2] = {st[rc + g], st[rc + g + 8]};  // (max, 1 / sum, rowsum(P dP))
      uint32_t pa[4], sa[4];  // P^T and bf16(scale dS)^T as A fragments
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bb = __ldg(
              reinterpret_cast<const float2*>(table + (rc + g + 8 * i) * N + 8 * t + 2 * q4));
          float p0 = s[t][2 * i] * scale + bb.x, p1 = s[t][2 * i + 1] * scale + bb.y;
          p0 = exp2f((p0 - sr[i].x) * 1.4426950408889634f);
          p1 = exp2f((p1 - sr[i].x) * 1.4426950408889634f);
          p0 *= sr[i].y;
          p1 *= sr[i].y;
          const float d0 = p0 * (d[t][2 * i] - sr[i].z);
          const float d1 = p1 * (d[t][2 * i + 1] - sr[i].z);
          // the (rows 8 i.., keys 8 t..) 8 x 8 block, transposed: A fragment
          // register t + 2 i of the keys-by-rows matrix
          pa[t + 2 * i] = movmatrix_trans(pack_f32(p0, p1));
          sa[t + 2 * i] = movmatrix_trans(pack_f32(scale * d0, scale * d1));
        }
#pragma unroll
      for (int jc = 0; jc < CT; ++jc) {
        uint32_t b0, b1;
        ldmatrix_b_trans(b0, b1, das + rc * LD + 8 * jc, LD);
        mma_bf16(dv[jc], pa, b0, b1);
        ldmatrix_b_trans(b0, b1, qs + rc * LD + 8 * jc, LD);
        mma_bf16(dk[jc], sa, b0, b1);
      }
    }
    store_tile_rows<CT>(dk, hd, unit, [&](int i) {
      return dqkv + token(w, key0 + g + 8 * i) * C3 + C + h * hd;
    });
    store_tile_rows<CT>(dv, hd, unit, [&](int i) {
      return dqkv + token(w, key0 + g + 8 * i) * C3 + 2 * C + h * hd;
    });
  }
}

// #1's bf16 window attention at 12x12 windows: one block per (head, group
// of windows of one kind). From qkv (T, 3C) and the kind table (kinds, nh,
// 144, 144), in x's frame, windows of the map rolled by (-shift, -shift):
// this head's attention output bf16(bf16(P) v) into att (T, C).
__global__ void __launch_bounds__(kGroupThreads, kGroupFwdBlocks)
    attn_group_fwd_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                               bf16* __restrict__ att, int B, int H, int W, int C, int nh,
                               int kinds, int shift, float scale, int unit, int pieces, int gw,
                               int g1, int g2, int g3) {
  constexpr int N = kGroupN, NTH = kGroupThreads, LD = kGroupLd, WS = kGroupWs;
  constexpr int NT = N / 8, CT = 32 / 8, ROWS = 3 * N;
  extern __shared__ __align__(16) float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // rooms: q, k, v (N rows each)
  bf16* ks = qs + N * LD;
  bf16* vs = ks + N * LD;
  bf16* raw = qs + ROWS * LD;  // (ROWS, LD) the next window's pieces
  uint8_t* pr = reinterpret_cast<uint8_t*>(raw + ROWS * LD);  // (ROWS) the staged rows' offsets
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  const int row0 = 16 * warp;
  const int h = blockIdx.x, gi = blockIdx.y;
  const int nwh = H / WS, nww = W / WS, hd = C / nh;
  const GroupWindows gr = group_of(gi, gw, g1, g2, g3, B, nwh, nww, kinds);
  const long long C3 = 3LL * C;
  const float* table = bias + ((size_t)gr.kind * nh + h) * N * N;
  const bf16* qkv_end = qkv + (long long)B * H * W * C3;
  auto token = [&](const Win& w, int row) {
    return roll_token(w.b, w.wi, w.wj, row, H, W, WS, WS, shift);
  };
  auto src_of = [&](const Win& w) {
    return [&, w](int q) {
      return HeadSrc{qkv + token(w, q % N) * C3 + (q / N) * C + h * hd, qkv_end};
    };
  };
  for (int e = tid; e < ROWS * LD / 2; e += NTH)  // the rooms' padding past hd stays zero
    reinterpret_cast<uint32_t*>(qs)[e] = 0u;
  __syncthreads();
  if (pieces && gr.m0 < gr.m1) {
    pieces_in<NTH>(raw, pr, ROWS, hd, src_of(window_of(gr, gr.m0, kinds, nwh, nww)));
    cp_async_commit();
  }
#pragma unroll 1
  for (int m = gr.m0; m < gr.m1; ++m) {
    const Win w = window_of(gr, m, kinds, nwh, nww);
    if (pieces) {
      cp_async_wait_all();
      __syncthreads();  // this window's pieces have landed; the last window is done
      unpack_rows<NTH>(qs, raw, pr, ROWS, hd);
    } else {
      __syncthreads();
      rows_direct<NTH>(qs, ROWS, hd, src_of(w));
    }
    __syncthreads();  // the rooms are whole (raw is free)
    if (pieces && m + 1 < gr.m1) {
      pieces_in<NTH>(raw, pr, ROWS, hd, src_of(window_of(gr, m + 1, kinds, nwh, nww)));
      cp_async_commit();
    }
    float s[NT][4], mx[2], inv[2];
    softmax_rows<NT>(s, mx, inv, qs + row0 * LD, ks, table + row0 * N, scale);
    // att = bf16(P) v, bf16(P / sum) packed from the fragments, two key
    // tiles a k-step
    float o[CT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[2 * t + i] = pack_f32(s[2 * kk + t][2 * i] * inv[i], s[2 * kk + t][2 * i + 1] * inv[i]);
#pragma unroll
      for (int jc = 0; jc < CT; ++jc) {
        uint32_t b0, b1;
        ldmatrix_b_trans(b0, b1, vs + 16 * kk * LD + 8 * jc, LD);
        mma_bf16(o[jc], a, b0, b1);
      }
    }
    store_tile_rows<CT>(o, hd, unit,
                        [&](int i) { return att + token(w, row0 + g + 8 * i) * C + h * hd; });
  }
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

// Floats of #6's groups' dbias sums (B, H, W the map; 12x12 windows).
inline long long attn_group_part_floats(int B, int H, int W, int nh, int kinds) {
  int goff[5];
  attn_groups(B, H / kGroupWs, W / kGroupWs, kinds, goff);
  return (long long)goff[4] * nh * kGroupN * kGroupN;
}

// The store unit of the kernels' outputs, in elements: the widest 16-, 8-
// or 4-byte piece that the heads' offsets (hd), C and the four tensors'
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

// Whether the rows come as 16-byte pieces (pieces_in): the bases of the
// tensors read 16-byte aligned; else element by element (rows_direct).
inline int attn_pieces(const void* qkv, const void* datt) {
  return (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(datt)) % 16 == 0;
}

// Shared memory above 48 KB for `kernel`, once a process.
template <class K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The kinds' sums of the groups' dbias sums into dbias (kinds, nh, n, n).
inline cudaError_t group_sums(const float* part, float* dbias, int kinds, int nh, int n,
                              const int (&goff)[5], cudaStream_t stream) {
  const long long per = (long long)nh * n * n;
  dbias_group_sum_kernel<<<(unsigned)((kinds * per + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(part, kinds, per, goff[1], goff[2], goff[3], goff[4], dbias);
  return cudaGetLastError();
}

// attn_window_bwd_bf16_kernel<N, WC> over the (B, H/WR, W/WC) windows, gw
// windows a group; its groups' dbias sums to part, then dbias.
template <int N, int WC>
inline cudaError_t launch_window_bwd(const bf16* qkv, const float* bias, const bf16* datt,
                                     bf16* dqkv, float* part, float* dbias, int B, int H, int W,
                                     int C, int nh, int kinds, float scale, int gw,
                                     cudaStream_t stream) {
  constexpr int WR = N / WC;
  int goff[5];
  attn_groups(B, H / WR, W / WC, kinds, goff, gw);
  if (goff[4] > 65535) return cudaErrorInvalidValue;
  if (goff[4] > 0) {
    auto kernel = attn_window_bwd_bf16_kernel<N, WC>;
    const int bytes = attn_window_smem_bytes(N);
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(nh, goff[4]), group_threads(N), bytes, stream>>>(
        qkv, bias, datt, dqkv, part, B, H, W, C, nh, kinds, scale,
        attn_group_unit(qkv, datt, dqkv, nullptr, C, nh), attn_pieces(qkv, datt), gw,
        goff[1], goff[2], goff[3]);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return e2;
  }
  return group_sums(part, dbias, kinds, nh, N, goff, stream);
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

// The windows (wr x wc) that #8's bf16 form takes at heads of up to 32
// channels; tc_attn.cuh's kernels take the rest.
inline bool window_bwd_grouped(int wr, int wc) {
  return (wr == 8 && (wc == 8 || wc == 16 || wc == 32)) || (wr == 16 && (wc == 8 || wc == 16)) ||
         (wr == 32 && wc == 8);
}

// #8's bf16 form at heads of up to 32 channels: windows a group of its
// grid (pass 0: the one launch at n 64 and 128, or the row pass at n 256;
// pass 1: the key pass), at windows of wr x wc tokens.
inline int window_bwd_group_windows(int B, int H, int W, int nh, int kinds, int wr, int wc,
                                    int pass) {
  const int n = wr * wc, nwh = H / wr, nww = W / wc;
  if (n == kPassN)
    return group_windows(B, nwh, nww, kinds, (long long)nh * (kPassN / kPassRows),
                         pass ? kKeyPassBlocks : kRowPassBlocks);
  return group_windows(B, nwh, nww, kinds, nh, group_blocks(n));
}

// Floats of #8's bf16 scratch at heads of up to 32 channels: the groups'
// dbias sums (which 0) and, at n 256, the row stats (which 1: four floats
// a row of every window and head).
inline long long window_bwd_scratch_floats(int B, int H, int W, int nh, int kinds, int wr, int wc,
                                           int which) {
  const int n = wr * wc, nwh = H / wr, nww = W / wc;
  if (which == 1) return n == kPassN ? 4LL * B * nwh * nww * nh * n : 0;
  int goff[5];
  attn_groups(B, nwh, nww, kinds, goff, window_bwd_group_windows(B, H, W, nh, kinds, wr, wc, 0));
  return (long long)goff[4] * nh * n * n;
}

// The n-256 passes at windows of WR x WC, then the groups' sums.
template <int WC>
inline cudaError_t launch_window_passes(const bf16* qkv, const float* bias, const bf16* datt,
                                        bf16* dqkv, float* part, float4* stats, float* dbias,
                                        int B, int H, int W, int C, int nh, int kinds,
                                        float scale, cudaStream_t stream) {
  constexpr int WR = kPassN / WC;
  const int nwh = H / WR, nww = W / WC;
  const int unit = attn_group_unit(qkv, datt, dqkv, nullptr, C, nh);
  const int pieces = attn_pieces(qkv, datt);
  int goff[5], koff[5];
  const int gw = window_bwd_group_windows(B, H, W, nh, kinds, WR, WC, 0);
  const int kw = window_bwd_group_windows(B, H, W, nh, kinds, WR, WC, 1);
  attn_groups(B, nwh, nww, kinds, goff, gw);
  attn_groups(B, nwh, nww, kinds, koff, kw);
  if (goff[4] > 65535 || koff[4] > 65535) return cudaErrorInvalidValue;
  if (goff[4] > 0) {
    auto rows = attn_group_rows_bf16_kernel<WC>;
    auto keys = attn_group_keys_bf16_kernel<WC>;
    cudaError_t err = allow_smem(rows, attn_rows_pass_smem_bytes());
    if (err == cudaSuccess) err = allow_smem(keys, attn_keys_pass_smem_bytes());
    if (err != cudaSuccess) return err;
    rows<<<dim3(nh, goff[4], kPassN / kPassRows), kRowPassThreads, attn_rows_pass_smem_bytes(),
           stream>>>(qkv, bias, datt, dqkv, part, stats, B, H, W, C, nh, kinds, scale, unit, pieces,
                     gw, goff[1], goff[2], goff[3]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    keys<<<dim3(nh, koff[4], kPassN / kPassRows), kPassThreads, attn_keys_pass_smem_bytes(),
           stream>>>(qkv, bias, datt, dqkv, stats, B, H, W, C, nh, kinds, scale, unit, pieces, kw,
                     koff[1], koff[2], koff[3]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return group_sums(part, dbias, kinds, nh, kPassN, goff, stream);
}

// #8's bf16 form at heads of up to 32 channels over the (B, H/wr, W/wc)
// windows (no shift: the caller rolls): dqkv and dbias (kinds, nh, n, n)
// through part and stats (window_bwd_scratch_floats). n 64 (8x8), 128 (8x16,
// 16x8) or 256 (16x16, 8x32, 32x8); cudaErrorInvalidValue for another.
inline cudaError_t window_bwd_bf16(const bf16* qkv, const float* bias, const bf16* datt,
                                   bf16* dqkv, float* part, float* stats, float* dbias, int B,
                                   int H, int W, int C, int nh, int kinds, int wr, int wc,
                                   float scale, cudaStream_t stream) {
  const int gw = window_bwd_group_windows(B, H, W, nh, kinds, wr, wc, 0);
  float4* st = reinterpret_cast<float4*>(stats);
  if (wr == 8 && wc == 8)
    return launch_window_bwd<64, 8>(qkv, bias, datt, dqkv, part, dbias, B, H, W, C, nh, kinds,
                                    scale, gw, stream);
  if (wr == 8 && wc == 16)
    return launch_window_bwd<128, 16>(qkv, bias, datt, dqkv, part, dbias, B, H, W, C, nh, kinds,
                                      scale, gw, stream);
  if (wr == 16 && wc == 8)
    return launch_window_bwd<128, 8>(qkv, bias, datt, dqkv, part, dbias, B, H, W, C, nh, kinds,
                                     scale, gw, stream);
  if (wr == 16 && wc == 16)
    return launch_window_passes<16>(qkv, bias, datt, dqkv, part, st, dbias, B, H, W, C, nh,
                                    kinds, scale, stream);
  if (wr == 8 && wc == 32)
    return launch_window_passes<32>(qkv, bias, datt, dqkv, part, st, dbias, B, H, W, C, nh,
                                    kinds, scale, stream);
  if (wr == 32 && wc == 8)
    return launch_window_passes<8>(qkv, bias, datt, dqkv, part, st, dbias, B, H, W, C, nh, kinds,
                                   scale, stream);
  return cudaErrorInvalidValue;
}

// #1's bf16 window attention over the (B, H/12, W/12) windows: att (T, C).
inline cudaError_t attn_group_fwd_bf16(const bf16* qkv, const float* bias, bf16* att, int B,
                                       int H, int W, int C, int nh, int kinds, int shift,
                                       float scale, cudaStream_t stream) {
  const int nwh = H / kGroupWs, nww = W / kGroupWs;
  const int gw = group_windows(B, nwh, nww, kinds, nh, kGroupFwdBlocks);
  int goff[5];
  attn_groups(B, nwh, nww, kinds, goff, gw);
  if (goff[4] > 65535) return cudaErrorInvalidValue;
  if (goff[4] == 0) return cudaSuccess;
  const int bytes = attn_group_fwd_smem_bytes();
  const cudaError_t err = allow_smem(attn_group_fwd_bf16_kernel, bytes);
  if (err != cudaSuccess) return err;
  attn_group_fwd_bf16_kernel<<<dim3(nh, goff[4]), kGroupThreads, bytes, stream>>>(
      qkv, bias, att, B, H, W, C, nh, kinds, shift, scale,
      attn_group_unit(qkv, nullptr, att, nullptr, C, nh), attn_pieces(qkv, nullptr), gw,
      goff[1], goff[2], goff[3]);
  return cudaGetLastError();
}

}  // namespace trr
