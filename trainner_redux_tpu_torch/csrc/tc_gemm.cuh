// The tensor-core product engine of the training backwards, fp32 in 3xTF32,
// for sm_90a.
//
// Numerics. Each fp32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), both exact TF32 values (10 mantissa bits), and a
// product accumulates lo*hi + hi*lo + hi*hi in fp32 (the small terms
// first): CUTLASS's "fast accurate fp32" scheme. Only lo*lo (about 2^-22 of
// |a||b|) is dropped, so a product keeps about 2^-21 of relative error per
// term, that of fp32 itself; plain 1xTF32 (hi*hi alone, about 2^-11) is
// not used: the training is fp32 with TF32 off.
//
// Instruction. wgmma.mma_async m64nNk8 tf32: a warpgroup (4 warps) takes
// a 64-row A from registers and an N-column B from shared memory. tf32
// wgmma reads B only K-major, in 8 x 4 "core matrices": each chunk of B is
// staged raw as the matrix lies (a weight (N, K) for dX = dY W^T, w1 (K, N)
// for h = y W, an activation (tokens, N) for the weight gradients A^T B),
// then split into its hi and lo core-matrix tiles in shared memory, the
// transpose taken on the way where B lies N-major. A is split in
// registers and, for A^T, transposed by its fragment loads from a [k][row]
// tile. So the wrappers pass the weights as they are: no transposed copies.
//
// Feeding. Operand chunks (16 deep) stream from device memory through a
// ring of kStages stages in shared memory filled with cp.async, 16 bytes a
// copy, zero-filling what lies outside the matrix. Each stage has a "full"
// mbarrier (every thread's copies for the stage arrive on it through
// cp.async.mbarrier.arrive.noinc) and an "empty" one (every thread arrives
// when it has taken the stage into its split buffer and registers). A
// thread refills the stage of chunk c - 1 with chunk c + kStages - 1 after
// it has issued chunk c, so kStages - 2 chunks are in flight while one is
// split, and the loop holds one barrier a chunk, for the split buffer.
// Chunk c's wgmma group runs while chunk c + 1 is split: three split
// buffers, and two sets of A registers, each kept alive until its group
// is done.
//
// Warps. 256 threads a block: two warpgroups, each owning 64 of the block
// tile's 128 rows and all its columns.
//
// Below the engine, 3xTF32 mma.sync m16n8k8 helpers for the small products
// that a thread block runs on operands it already holds in shared memory.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace trr {

constexpr int kStages = 4;         // depth of the operand ring
constexpr int kTcK = 16;           // depth of a per-token chunk
constexpr int kTcRows = 128;       // rows (tokens, or weight-gradient rows) of a block tile
constexpr int kSplitBufs = 3;      // buffers of B's split tiles: one written, two read

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, of which the first `bytes` are read and the
// rest are zero (bytes 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive on `bar` once this thread's cp.async copies issued so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The ring of S operand stages: `stage_floats` floats each, then 2 * S
// mbarriers. Every thread of the block runs `run` with the same arguments.
template <int S = kStages>
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int stage_floats;
  int next;  // chunks issued so far, over every run: the barriers' phases

  // Shared memory of a ring, in bytes.
  __host__ __device__ static int bytes(int stage_floats) {
    return S * stage_floats * (int)sizeof(float) + 2 * S * (int)sizeof(uint64_t);
  }

  __device__ void init(float* smem, int sf) {
    buf = smem;
    stage_floats = sf;
    full = reinterpret_cast<uint64_t*>(smem + S * sf);
    empty = full + S;
    next = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full + s, kThreads);
        mbar_init(empty + s, kThreads);
      }
    }
    __syncthreads();
  }

  __device__ float* stage(int c) const { return buf + (c % S) * stage_floats; }

  // Chunks 0..n-1: load(j, stage) issues chunk j's copies; use(j, stage)
  // reads it once it has landed.
  template <class Load, class Use>
  __device__ void run(int n, Load load, Use use) {
    const int base = next;
    auto produce = [&](int j) {
      const int c = base + j;
      if (c >= S) mbar_wait(empty + c % S, ((c / S) - 1) & 1);
      load(j, stage(c));
      mbar_arrive_copies(full + c % S);
    };
    const int pre = n < S - 1 ? n : S - 1;
    for (int j = 0; j < pre; ++j) produce(j);
    for (int i = 0; i < n; ++i) {
      const int c = base + i;
      mbar_wait(full + c % S, (c / S) & 1);
      use(i, stage(c));
      mbar_arrive(empty + c % S);
      if (i + S - 1 < n) produce(i + S - 1);
    }
    next = base + n;
  }
};

// ROWS x COLS floats (COLS a multiple of 4) of the row-major matrix G
// (row stride ldg) from (r0, c0) into the shared tile S (row stride lds),
// by cp.async, the copies dealt out to the block's threads in turn; rows >=
// rlim and columns >= clim read as 0. VEC: 16-byte
// copies, which need ldg, c0 and G's address in multiples of 4 floats;
// else 4-byte copies.
template <int ROWS, int COLS, bool VEC = true>
__device__ __forceinline__ void load_tile(float* S, int lds, const float* __restrict__ G,
                                          long long ldg, long long r0, long long rlim, int c0,
                                          int clim) {
  if constexpr (VEC) {
    constexpr int SEG = COLS / 4, ALL = ROWS * SEG;
#pragma unroll
    for (int i = 0; i < (ALL + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (ALL % kThreads && e >= ALL) break;
      const int r = e / SEG, c = (e % SEG) * 4;
      const long long gr = r0 + r;
      const int gc = c0 + c;
      const int n = gr < rlim ? min(4, clim - gc) : 0;
      const int bytes = n > 0 ? 4 * n : 0;
      cp_async16(S + r * lds + c, bytes ? G + gr * ldg + gc : G, bytes);
    }
  } else {
    static_assert(ROWS * COLS % kThreads == 0, "copies must split evenly");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / COLS, c = e % COLS;
      const long long gr = r0 + r;
      const int gc = c0 + c;
      const bool ok = gr < rlim && gc < clim;
      cp_async4(S + r * lds + c, ok ? G + gr * ldg + gc : G, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (4 warps) multiplies a 64-row A held in registers (the
// mma.sync A-fragment layout, warp w of the group owning rows 16 w..16 w+15)
// by an N-column B read from shared memory through a descriptor. tf32 wgmma
// reads B only K-major; here B is stored in "core matrices" of 8 rows by 4
// floats (16 bytes), no swizzle: a (n, k) tile with n rows and kc columns
// lies as [n / 8][kc / 4][8][4] floats, so the core matrices next along K
// are 128 bytes apart (LBO) and the 8-row groups kc * 32 bytes (SBO).
// Accumulator d[4 j + e] of a thread (lane 4 g + q) is row 16 w + g + 8 (e / 2),
// column 8 j + 2 q + e % 2, as mma.sync's per n8 tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int lbo_bytes, int sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, no swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// All but this warpgroup's latest group of wgmmas are done.
__device__ __forceinline__ void wgmma_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Shared-memory writes of this thread (cp.async's included) before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
struct Wgmma;

// The accumulator operands of a wgmma wrapper, eight at a time.
#define TRR_D8(o)                                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                  int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ static void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                  int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
        "}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                  int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<192> {
  __device__ static void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b,
                                  int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
        "}, {%96,%97,%98,%99}, %100, p, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                  int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
        "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
        "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
        "}, {%128,%129,%130,%131}, %132, p, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88),
          TRR_D8(96), TRR_D8(104), TRR_D8(112), TRR_D8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef TRR_D8

// Split a staged (BN, KC) chunk of B into its TF32 hi and lo core-matrix
// tiles (hi at cb, lo at cb + BN * KC). B_KMAJOR: the chunk lies [n][k]
// (row stride ldb), else [k][n] (the transpose is taken here). A warp's
// lanes take k % 4 = lane % 4 and n % 8 = lane / 4, so the loads (strides
// of 4 or 8 words mod 32) and the stores hit 32 banks.
template <int BN, int KC, bool B_KMAJOR>
__device__ __forceinline__ void split_to_core(const float* raw, int ldb, float* cb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  static_assert(BN * KC % kThreads == 0, "the split must share out evenly");
#pragma unroll 4
  for (int i = 0; i < BN * KC / kThreads; ++i) {
    const int rest = (threadIdx.x + i * kThreads) / 32;
    const int kg = rest % (KC / 4), ng = rest / (KC / 4);
    const int n = 8 * ng + g, k = 4 * kg + q;
    uint32_t h, l;
    split_tf32(B_KMAJOR ? raw[n * ldb + k] : raw[k * ldb + n], h, l);
    const int o = (ng * (KC / 4) + kg) * 32 + g * 4 + q;
    cb[o] = __uint_as_float(h);
    cb[BN * KC + o] = __uint_as_float(l);
  }
}

// Floats of the kSplitBufs buffers of an (N, kc) chunk's hi / lo tiles.
__host__ __device__ constexpr int split_floats(int n, int kc = kTcK) {
  return kSplitBufs * 2 * n * kc;
}

// A chunk's A fragments, TF32 hi and lo: the registers a running wgmma
// group reads, so two sets alternate and each stays alive until its group
// is known to be done.
template <int KC = kTcK>
struct AFrag {
  uint32_t h[KC / 8][4], l[KC / 8][4];
};

// Keep `f` in its registers up to here.
template <int KC>
__device__ __forceinline__ void keep(AFrag<KC>& f) {
#pragma unroll
  for (int s = 0; s < KC / 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f.h[s][e]), "+r"(f.l[s][e]));
}

// This warp's 16 rows of a staged A chunk (from row ar of As, [row][k]
// (A_ROWK, row stride lda) or [k][row]) into the fragments cur, split.
template <int KC, bool A_ROWK>
__device__ __forceinline__ void load_a_frag(AFrag<KC>& cur, const float* As, int lda, int ar) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int s = 0; s < KC / 8; ++s) {
    float v[4];
    if constexpr (A_ROWK) {
      const float* a = As + (ar + g) * lda + 8 * s + q;
      v[0] = a[0];
      v[1] = a[8 * lda];
      v[2] = a[4];
      v[3] = a[8 * lda + 4];
    } else {
      const float* a = As + (8 * s + q) * lda + ar + g;
      v[0] = a[0];
      v[1] = a[8];
      v[2] = a[4 * lda];
      v[3] = a[4 * lda + 8];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], cur.h[s][e], cur.l[s][e]);
  }
}

template <int N, int KC, bool A_ROWK, bool B_KMAJOR>
__device__ __forceinline__ void wgmma_step(float (&acc)[N / 2], const float* As, int lda, int ar,
                                           const float* raw, int ldb, float* cb, AFrag<KC>& cur,
                                           AFrag<KC>& prev) {
  split_to_core<N, KC, B_KMAJOR>(raw, ldb, cb);
  load_a_frag<KC, A_ROWK>(cur, As, lda, ar);
  fence_proxy_async();
  __syncthreads();  // cb is whole
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KC / 8; ++s) {
    const uint64_t dh = wgmma_desc(cb + 64 * s, 128, KC * 32);
    const uint64_t dl = wgmma_desc(cb + N * KC + 64 * s, 128, KC * 32);
    Wgmma<N>::mma(acc, cur.l[s], dh);
    Wgmma<N>::mma(acc, cur.h[s], dl);
    Wgmma<N>::mma(acc, cur.h[s], dh);
  }
  wgmma_commit();
  wgmma_wait_prev();
  keep(prev);  // the previous chunk's group is done only now
}

// acc (the warpgroup's 64 x N block) += A B over chunk j (KC deep) in
// 3xTF32. A: the warp's 16 rows from row ar of the staged tile As, [row][k]
// (A_ROWK, row stride lda) or [k][row], split into af[j % 2]. B: the
// staged chunk `raw` (see split_to_core), split into buffer j % kSplitBufs
// of `split`. One barrier (the buffer is whole), then the chunk's wgmmas
// are issued and left running: the call returns once the previous chunk's
// are done, so when chunk j + 1 writes its buffer no warpgroup still reads
// the one chunk j - 2 used, and the stage is free as soon as this returns.
// wgmma_wait_all() before the accumulators are read.
template <int N, int KC, bool A_ROWK, bool B_KMAJOR>
__device__ __forceinline__ void wgmma_chunk(float (&acc)[N / 2], const float* As, int lda, int ar,
                                            const float* raw, int ldb, float* split, int j,
                                            AFrag<KC> (&af)[2]) {
  float* cb = split + (j % kSplitBufs) * 2 * N * KC;
  if (j & 1)
    wgmma_step<N, KC, A_ROWK, B_KMAJOR>(acc, As, lda, ar, raw, ldb, cb, af[1], af[0]);
  else
    wgmma_step<N, KC, A_ROWK, B_KMAJOR>(acc, As, lda, ar, raw, ldb, cb, af[0], af[1]);
}

// Precision of the sums. A sum carried in one wgmma accumulator over a long
// K strays further than an fp32 sum, the more the more wgmmas add into it
// (three a k-step of 8). On an H100 the forwards' products (qkv, fc1 and
// fc2, K 180 to 480, unit-scale operands) strayed 8.8e-6 to 2.3e-5 from a
// float64 result, where PyTorch's fp32 product strayed 3.0e-6 to 5.5e-6. A
// promoted product (wgmma_chunk_promoted) sums kPromoteChunks chunks (32
// deep) alone, in `part`, and adds them to acc on the CUDA cores in fp32
// with round-to-nearest: 1.7e-6 to 1.9e-6, for under 1% of the product's
// time (every chunk: 1.3e-6 to 1.9e-6 and 4-5%; every four chunks: 2.7e-6
// to 3.1e-6). scripts/benchmarking/chip_promote_sums.py measures the
// settings on linear_kernel's PROMOTE.

// Order the reads of part after the wait for the wgmmas that wrote it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(part[i])::"memory");
}

constexpr int kPromoteChunks = 2;  // chunks a promoted product sums in `part` before acc

template <int N, int KC, bool A_ROWK, bool B_KMAJOR, int PROMOTE>
__device__ __forceinline__ void promoted_step(float (&acc)[N / 2], float (&part)[N / 2],
                                              const float* As, int lda, int ar, const float* raw,
                                              int ldb, float* cb, int i, AFrag<KC>& cur,
                                              AFrag<KC>& prev) {
  const bool fresh = i % PROMOTE == 0;
  split_to_core<N, KC, B_KMAJOR>(raw, ldb, cb);
  load_a_frag<KC, A_ROWK>(cur, As, lda, ar);
  fence_proxy_async();
  __syncthreads();  // cb is whole
  if (fresh && i > 0) {  // the chunks before are done: their sum joins acc
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += part[e];
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KC / 8; ++s) {
    const uint64_t dh = wgmma_desc(cb + 64 * s, 128, KC * 32);
    const uint64_t dl = wgmma_desc(cb + N * KC + 64 * s, 128, KC * 32);
    Wgmma<N>::mma(part, cur.l[s], dh, !fresh || s > 0);
    Wgmma<N>::mma(part, cur.h[s], dl);
    Wgmma<N>::mma(part, cur.h[s], dh);
  }
  wgmma_commit();
  wgmma_wait_prev();
  keep(prev);  // the previous chunk's group is done only now
}

// acc (the warpgroup's 64 x N block) += A B over chunk i of a product, the
// block's chunk j (its split buffer), as wgmma_chunk takes its operands,
// promoted: every PROMOTE chunks, part starts afresh (scale-d 0 on the
// first wgmma) once the sum of those before, done, has joined acc;
// wgmma_promote_last adds the last. As in wgmma_chunk, a chunk's wgmmas run
// while the next is split.
template <int N, int KC, bool A_ROWK, bool B_KMAJOR, int PROMOTE = kPromoteChunks>
__device__ __forceinline__ void wgmma_chunk_promoted(float (&acc)[N / 2], float (&part)[N / 2],
                                                     const float* As, int lda, int ar,
                                                     const float* raw, int ldb, float* split,
                                                     int j, int i, AFrag<KC> (&af)[2]) {
  float* cb = split + (j % kSplitBufs) * 2 * N * KC;
  if (j & 1)
    promoted_step<N, KC, A_ROWK, B_KMAJOR, PROMOTE>(acc, part, As, lda, ar, raw, ldb, cb, i, af[1],
                                                    af[0]);
  else
    promoted_step<N, KC, A_ROWK, B_KMAJOR, PROMOTE>(acc, part, As, lda, ar, raw, ldb, cb, i, af[0],
                                                    af[1]);
}

// The last chunks' sum to acc, after a run of wgmma_chunk_promoted.
template <int N>
__device__ __forceinline__ void wgmma_promote_last(float (&acc)[N], float (&part)[N]) {
  wgmma_wait_all();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k8 tf32 in 3xTF32, for products whose operands a thread
// block already holds in shared memory (the per-window attention
// backwards). A warp multiplies a 16 x 8 slice of A by an 8 x 8 slice of B
// into a 16 x 8 tile of fp32 sums. Fragments of lane 4 g + q: A a0 (g, q),
// a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B b0 (q, g), b1 (q + 4,
// g); the sums d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
// Each fragment element is split as it is loaded, by truncation: hi = x
// with its low 13 bits cleared, lo = x - hi (exact) likewise, both TF32
// values; x - hi - lo < 2^-20 |x|. Here every element is split once for
// each use, and cvt.rna.tf32.f32 compiles to a sequence of some ten integer
// and compare instructions, which cost #6's attention stage about a tenth
// of its time on an H100 (both forms timed); the engine above splits each
// chunk once and keeps round-to-nearest.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into TF32 hi and lo.
struct MmaA {
  uint32_t h[4], l[4];
};

// The A fragment of the 16 x 8 slice at X: element (r, k) at X[r * ld + k],
// or, A_T, at X[k * ld + r] (A is X's transpose).
template <bool A_T>
__device__ __forceinline__ void mma_load_a(MmaA& a, const float* X, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float v[4];
  if constexpr (A_T) {
    v[0] = X[q * ld + g];
    v[1] = X[q * ld + g + 8];
    v[2] = X[(q + 4) * ld + g];
    v[3] = X[(q + 4) * ld + g + 8];
  } else {
    v[0] = X[g * ld + q];
    v[1] = X[(g + 8) * ld + q];
    v[2] = X[g * ld + q + 4];
    v[3] = X[(g + 8) * ld + q + 4];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_trunc(v[e], a.h[e], a.l[e]);
}

// d += A B over one k-step of 8 in 3xTF32 (lo*hi, hi*lo, then hi*hi, in
// the wgmma engine's order): B element (k, n) at X[k * ld + n], or, B_T,
// at X[n * ld + k].
template <bool B_T>
__device__ __forceinline__ void mma3(float (&d)[4], const MmaA& a, const float* X, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float b0 = B_T ? X[g * ld + q] : X[q * ld + g];
  const float b1 = B_T ? X[g * ld + q + 4] : X[(q + 4) * ld + g];
  uint32_t h0, l0, h1, l1;
  split_tf32_trunc(b0, h0, l0);
  split_tf32_trunc(b1, h1, l1);
  mma_tf32(d, a.l, h0, h1);
  mma_tf32(d, a.h, l0, l1);
  mma_tf32(d, a.h, h0, h1);
}

}  // namespace trr
