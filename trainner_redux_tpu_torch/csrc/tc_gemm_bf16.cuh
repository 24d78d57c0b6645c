// The bf16 form of the tensor-core product engine (tc_gemm.cuh), for the
// bf16 training block (#4 and #5 on bf16 activations, fused_block_train.cu),
// for sm_90a.
//
// Numerics. The operands are bf16 as they lie in device memory (the JAX
// kernels compute in x.dtype: weights cast to bf16 on the way in,
// activations rounded to bf16 between stages); each product sums in fp32 in
// the wgmma accumulator, as the Pallas kernels' dots with
// preferred_element_type=float32 do. No hi/lo split: a bf16 x bf16 product
// is exact in fp32, and one instruction does the work of the 3xTF32 form's
// six.
//
// Instruction. wgmma.mma_async m64nNk16 .f32.bf16.bf16: a warpgroup takes a
// 64-row A from registers (mma.sync m16n8k16's A fragment layout, warp w of
// the group owning rows 16 w..16 w+15, two bf16 of neighbouring k a
// register, the lower k in the lower half) and an N-column B from shared
// memory, K-major, in "core matrices" of 8 rows by 8 bf16 (16 bytes a row),
// no swizzle: a (n, kc) tile lies as [n / 8][kc / 8][8][8] bf16, so the core
// matrices next along K are 128 bytes apart (LBO) and the 8-row groups kc *
// 16 bytes (SBO), the same bytes as the tf32 form's [n / 8][kc / 4][8][4]
// floats. Each chunk of B is staged raw as the matrix lies (a weight (N, K)
// for dX = dY W^T, w1 (K, N) for h = y W), then copied into its core-matrix
// tile, the transpose taken on the way where B lies N-major, as the tf32
// form splits it. A goes to registers from the staged [row][k] chunk. (The
// weight gradients A^T B read both operands MN-major from shared memory:
// wgrad_bf16.cuh.)
//
// Feeding and warps: those of tc_gemm.cuh (its Ring, its mbarriers, two
// warpgroups of 64 rows a 128-row block tile, three core-tile buffers and
// two sets of A registers, so chunk c's wgmmas run while chunk c + 1 is
// copied), a chunk 32 deep (the fp32 form's 16, in the same bytes). Rows
// move by 8-byte cp.async copies (4 bf16): every width the
// bf16 block takes (C 60 and 180, 3C, hidden; the MLP half's C 240) is a
// multiple of 4, and a chunk's K tail past the matrix is zero-filled.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace trr {

using bf16 = __nv_bfloat16;

constexpr int kBfK = 2 * kTcK;   // depth of a per-token bf16 chunk: the fp32 chunk's bytes
constexpr int kBfLd = kBfK + 8;  // row stride, in bf16, of a staged [row][k] chunk

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// v rounded to bf16 and back: the JAX kernels' .astype(bf16) between fp32 steps
__device__ __forceinline__ float rbf(float v) { return bf2f(f2bf(v)); }

// Two bf16 in one register, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(f2bf(lo), f2bf(hi));
}

// One element, four (8 or 16 bytes, aligned) and their stores, of an fp32
// or a bf16 row, as fp32: the bf16 forms read and write either.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(bf16* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_f32(v.x, v.y), pack_f32(v.z, v.w));
}

// 8 bytes from src to dst, of which the first `bytes` are read and the rest
// are zero.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// ROWS x COLS bf16 (COLS a multiple of 4) of the row-major matrix G (row
// stride ldg, a multiple of 4) from (r0, c0) into the shared tile S (row
// stride lds), by 8-byte cp.async copies dealt out to the block's threads
// in turn; rows >= rlim and columns >= clim (a multiple of 4) read as 0.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_bf16(bf16* S, int lds, const bf16* __restrict__ G,
                                               long long ldg, long long r0, long long rlim,
                                               int c0, int clim) {
  constexpr int SEG = COLS / 4, ALL = ROWS * SEG;
#pragma unroll
  for (int i = 0; i < (ALL + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (ALL % kThreads && e >= ALL) break;
    const int r = e / SEG, c = (e % SEG) * 4;
    const long long gr = r0 + r;
    const int gc = c0 + c;
    const bool ok = gr < rlim && gc < clim;
    cp_async8(S + r * lds + c, ok ? G + gr * ldg + gc : G, ok ? 8 : 0);
  }
}

// The bf16 wgmma, m64nNk16: D += A B, B K-major (imm-trans-b 0).
template <int N>
struct WgmmaBf;

#define TRR_D8(o)                                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

template <>
struct WgmmaBf<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf<96> {
  __device__ static void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
        "}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf<128> {
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf<192> {
  __device__ static void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
        "}, {%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf<256> {
  __device__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
        "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
        "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
        "}, {%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88),
          TRR_D8(96), TRR_D8(104), TRR_D8(112), TRR_D8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef TRR_D8

// Copy a staged (BN, KC) chunk of B into its core-matrix tile cb (32-bit
// words, two bf16 of neighbouring k each). B_KMAJOR: the chunk lies [n][k]
// (row stride ldb, even), else [k][n] (the transpose is taken here). Warp
// w fills core matrices w, w + 8, ...: lane 4 g + q takes row g, k pair q.
template <int BN, int KC, bool B_KMAJOR>
__device__ __forceinline__ void bf16_to_core(const bf16* raw, int ldb, uint32_t* cb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  static_assert(BN * KC / 2 % kThreads == 0, "the copy must share out evenly");
#pragma unroll 4
  for (int i = 0; i < BN * KC / 2 / kThreads; ++i) {
    const int cm = (threadIdx.x + i * kThreads) / 32;  // the core matrix
    const int kg = cm % (KC / 8), ng = cm / (KC / 8);
    const int n = 8 * ng + g, k = 8 * kg + 2 * q;
    cb[cm * 32 + g * 4 + q] =
        B_KMAJOR ? *reinterpret_cast<const uint32_t*>(raw + n * ldb + k)
                 : pack_bf16(raw[k * ldb + n], raw[(k + 1) * ldb + n]);
  }
}

// 32-bit words of the kSplitBufs core-tile buffers of an (N, kBfK) chunk.
__host__ __device__ constexpr int core_words(int n) { return kSplitBufs * n * kBfK / 2; }

// A chunk's A fragments: the registers a running wgmma group reads, so two
// sets alternate and each stays alive until its group is known to be done.
template <int KC = kBfK>
struct AFragBf {
  uint32_t a[KC / 16][4];
};

template <int KC>
__device__ __forceinline__ void keep(AFragBf<KC>& f) {
#pragma unroll
  for (int s = 0; s < KC / 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f.a[s][e]));
}

// This warp's 16 rows of a staged A chunk (from row ar of As, [row][k], row
// stride lda, even) into the fragments f.
template <int KC>
__device__ __forceinline__ void load_a_frag_bf16(AFragBf<KC>& f, const bf16* As, int lda,
                                                 int ar) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int s = 0; s < KC / 16; ++s) {
    const bf16* a = As + (ar + g) * lda + 16 * s + 2 * q;
    f.a[s][0] = *reinterpret_cast<const uint32_t*>(a);
    f.a[s][1] = *reinterpret_cast<const uint32_t*>(a + 8 * lda);
    f.a[s][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    f.a[s][3] = *reinterpret_cast<const uint32_t*>(a + 8 * lda + 8);
  }
}

template <int N, int KC, bool B_KMAJOR>
__device__ __forceinline__ void wgmma_bf16_step(float (&acc)[N / 2], const bf16* As, int lda,
                                                int ar, const bf16* raw, int ldb, uint32_t* cb,
                                                AFragBf<KC>& cur, AFragBf<KC>& prev) {
  bf16_to_core<N, KC, B_KMAJOR>(raw, ldb, cb);
  load_a_frag_bf16<KC>(cur, As, lda, ar);
  fence_proxy_async();
  __syncthreads();  // cb is whole
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KC / 16; ++s)
    WgmmaBf<N>::mma(acc, cur.a[s],
                    wgmma_desc(reinterpret_cast<const float*>(cb + 64 * s), 128, KC * 16));
  wgmma_commit();
  wgmma_wait_prev();
  keep(prev);  // the previous chunk's group is done only now
}

// acc (the warpgroup's 64 x N block) += A B over chunk j (KC deep), as
// tc_gemm.cuh's wgmma_chunk: A the warp's 16 rows from row ar of the
// staged As, B the staged chunk `raw` copied into core-tile buffer j %
// kSplitBufs of `core`. wgmma_wait_all() before the accumulators are read.
template <int N, int KC, bool B_KMAJOR>
__device__ __forceinline__ void wgmma_bf16_chunk(float (&acc)[N / 2], const bf16* As, int lda,
                                                 int ar, const bf16* raw, int ldb,
                                                 uint32_t* core, int j, AFragBf<KC> (&af)[2]) {
  uint32_t* cb = core + (j % kSplitBufs) * N * KC / 2;
  if (j & 1)
    wgmma_bf16_step<N, KC, B_KMAJOR>(acc, As, lda, ar, raw, ldb, cb, af[1], af[0]);
  else
    wgmma_bf16_step<N, KC, B_KMAJOR>(acc, As, lda, ar, raw, ldb, cb, af[0], af[1]);
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 bf16, for the window attention's products on operands a
// thread block holds in fp32 shared memory (tc_attn.cuh's bf16 form): each
// fragment pair is rounded to bf16 as it is loaded (exact where the value
// is a bf16 already: q, k, v, dA, P). Fragments of lane 4 g + q: A r0 (g,
// 2q..2q+1), r1 (g + 8, 2q..), r2 (g, 2q + 8..), r3 (g + 8, 2q + 8..); B b0
// (k 2q..2q+1, n g), b1 (k 2q + 8.., n g); the sums as m16n8k8's.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct MmaABf {
  uint32_t r[4];
};

// The A fragment of the 16 x 16 slice at X: element (r, k) at X[r * ld +
// k] (ld even), or, A_T, at X[k * ld + r].
template <bool A_T>
__device__ __forceinline__ void mma_load_a_bf16(MmaABf& a, const float* X, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (A_T) {
    const float* x = X + 2 * q * ld + g;
    a.r[0] = pack_f32(x[0], x[ld]);
    a.r[1] = pack_f32(x[8], x[ld + 8]);
    a.r[2] = pack_f32(x[8 * ld], x[9 * ld]);
    a.r[3] = pack_f32(x[8 * ld + 8], x[9 * ld + 8]);
  } else {
    const float* x = X + g * ld + 2 * q;
    const float2 v0 = *reinterpret_cast<const float2*>(x);
    const float2 v1 = *reinterpret_cast<const float2*>(x + 8 * ld);
    const float2 v2 = *reinterpret_cast<const float2*>(x + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(x + 8 * ld + 8);
    a.r[0] = pack_f32(v0.x, v0.y);
    a.r[1] = pack_f32(v1.x, v1.y);
    a.r[2] = pack_f32(v2.x, v2.y);
    a.r[3] = pack_f32(v3.x, v3.y);
  }
}

// d += A B over one k-step of 16: B element (k, n) at X[k * ld + n], or,
// B_T, at X[n * ld + k] (ld even).
template <bool B_T>
__device__ __forceinline__ void mma1_bf16(float (&d)[4], const MmaABf& a, const float* X, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t b0, b1;
  if constexpr (B_T) {
    const float2 u = *reinterpret_cast<const float2*>(X + g * ld + 2 * q);
    const float2 v = *reinterpret_cast<const float2*>(X + g * ld + 2 * q + 8);
    b0 = pack_f32(u.x, u.y);
    b1 = pack_f32(v.x, v.y);
  } else {
    const float* x = X + 2 * q * ld + g;
    b0 = pack_f32(x[0], x[ld]);
    b1 = pack_f32(x[8 * ld], x[9 * ld]);
  }
  mma_bf16(d, a.r, b0, b1);
}

}  // namespace trr
