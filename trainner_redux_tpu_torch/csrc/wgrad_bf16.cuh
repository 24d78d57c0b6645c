// The bf16 weight gradients of the training backwards, for sm_90a: out =
// (A^T B, the column sums of the fp32 values B was rounded from) over T
// tokens, A (T, M) and B (T, N) bf16 and token-major. One stage, every
// caller's: #5's, #6's and #7's bf16 forms (fused_block_train.cu) and #12's
// and #14's (through trr_weight_grad_bf16, fused_block_v2.py). The JAX
// kernels sum these in the dots of their backward kernels (dW = y^T dY with
// preferred_element_type=float32, db = sum of the fp32 dY:
// trainner_redux_tpu/ops/pallas/fused_block.py:594-613 for #6, :226-235 for
// #7), so the stage replaces no pallas_call of its own.
//
// What bounds it on the card: bytes. At #5's block (T 32,768; (360, 180),
// (180, 360), (180, 180), (180, 540)) the four products are 17.0 GFLOP, 17
// us on the bf16 tensor cores, against some 224 MB of operands and bias-sum
// sources, 67 us at 3.35 TB/s; at #6's (T 82,944; (240, 240), (240, 720))
// 38.2 GFLOP and some 280 MB.
//
// What the design does about it:
//   - Both operands go from shared memory into wgmma m64nNk16 as they lie in
//     device memory. bf16 wgmma reads either operand MN-major (its
//     descriptor's transpose bits), and token-major A and B are exactly
//     that: A^T is (M, tokens) with M contiguous, B (tokens, N) with N
//     contiguous. A chunk's tiles lie in the no-swizzle MN-major layout: core
//     matrices of 8 tokens by 8 columns (8 rows of 16 bytes, one a token), the
//     column groups of 8 tokens side by side, 128 bytes apart (SBO, the
//     stride along M or N), the 8-token groups a row of them apart (LBO, the
//     stride along K: W / 8 * 128 bytes). cp.async copies each 8- or
//     16-byte piece of a token's row straight into its core-matrix row: no
//     transpose anywhere, in shared memory or in registers.
//   - Chunks of kWgK = 64 tokens (four k16 steps a barrier) on a ring of
//     kWgStages stages with full and empty mbarriers (tc_gemm.cuh's Ring).
//     Chunk i's wgmmas are issued, then the thread waits for chunk i - 1's,
//     releases its stage and refills it with chunk i + kWgStages - 1: three
//     chunks in flight while one multiplies.
//   - The copies are of the widest unit the rows allow. TMA wants global
//     strides in multiples of 16 bytes, which SwinIR-M's 180 (360 B), 540
//     and DRCT's 276 and 308 are not; cp.async takes 16 bytes where M (or N)
//     is a multiple of 8 and the base is 16-byte aligned, else 8 (every width
//     the gates take is a multiple of 4). A warp's copies fill whole core
//     matrices (eight lanes a core matrix, its eight tokens; in 8-byte units
//     sixteen), so a phase of a warp's stores covers 128 contiguous bytes.
//   - A block takes a 128-row tile of M (two warpgroups of 64) by a BN-column
//     tile of N, BN the one of 64, 128, 192 and 256 whose tiles copy the
//     fewest bytes (192 at N 180, 276, 308, 360, 540; 256 at 240, 480, 720), and a
//     range of tokens as long as it takes to give one wave of kWgWaveBlocks
//     blocks (one a SM: 98-197 KB of shared memory). Each block writes its
//     range's partial product; wg_sum_kernel adds the ranges in order.
//   - The bias sums. Where the source is B itself (the bf16 values summed,
//     no row scale: dbq's dqkv), the blocks sum the staged B tile: chunk j
//     of a range by the block of m-tile j mod (m-tiles), so the work shares
//     out, eight lanes a column group, a lane every eighth token, sixteen-byte
//     reads of whole core-matrix rows (a warp's four groups lie side by side:
//     512 contiguous bytes), eight sums a lane; the lanes' sums are added by
//     a fixed shuffle tree at the end. Every other source (fp32 dh, dz,
//     dm, dproj; the bf16 dout times the DropPath scale of its sample) is
//     read once by wg_colsum_kernel, a warp 64 tokens of 128 columns, the
//     block's eight warps added in order.
// No atomics: every sum has a fixed order, so two runs give the same bits.
#pragma once

#include <algorithm>

#include "tc_gemm_bf16.cuh"
#include "tc_rows.cuh"

namespace trr {

constexpr int kWgK = 64;            // tokens of a chunk: four k16 steps a barrier
constexpr int kWgStages = 4;        // depth of the ring
constexpr int kWgRows = 128;        // rows (of M) of a block tile: two warpgroups of 64
constexpr int kWgWaveBlocks = 132;  // blocks a product aims at: one a SM of an H100
constexpr int kWgSumTokens = 512;   // tokens of a wg_colsum_kernel partial: 64 a warp

// Columns of a block tile over N: the one of 64, 128, 192 and 256 whose
// tiles copy the fewest bytes a chunk, n-tiles x (kWgRows + BN) (each
// n-tile copies the A tile again), the wider at a tie.
__host__ __device__ inline int wg_cols(int N) {
  int best = 256, cost = (N + 255) / 256 * (kWgRows + 256);
  for (int bn = 192; bn >= 64; bn -= 64) {
    const int c = (N + bn - 1) / bn * (kWgRows + bn);
    if (c < cost) {
      cost = c;
      best = bn;
    }
  }
  return best;
}

// Shared memory of wg_bf16_kernel at BN columns: the ring of a (kWgK,
// kWgRows) A tile and a (kWgK, BN) B tile a stage.
__host__ __device__ inline int wg_bf16_smem_bytes(int bn) {
  return Ring<kWgStages>::bytes(kWgK * (kWgRows + bn) / 2);
}

// How a product is cut: m and n tiles, the tokens of a range (a multiple
// of kWgK) and the ranges.
struct WgPlan {
  int bn, nm, nn;
  long long chunk;
  int z;
};

inline WgPlan wg_plan(long long T, int M, int N) {
  WgPlan p;
  p.bn = wg_cols(N);
  p.nm = (M + kWgRows - 1) / kWgRows;
  p.nn = (N + p.bn - 1) / p.bn;
  const int tiles = p.nm * p.nn;
  const long long want = tiles >= kWgWaveBlocks ? 1 : kWgWaveBlocks / tiles;
  p.chunk = (T + want - 1) / want;
  p.chunk = p.chunk < 1 ? kWgK : (p.chunk + kWgK - 1) / kWgK * kWgK;
  p.z = (int)((T + p.chunk - 1) / p.chunk);
  return p;
}

// Partial rows of the column sums: the blocks' (z, m-tile) rows where B is
// the source, wg_colsum_kernel's rows of kWgSumTokens tokens otherwise.
inline long long wg_sum_rows(long long T, const WgPlan& p, bool from_b) {
  return from_b ? (long long)p.z * p.nm : (T + kWgSumTokens - 1) / kWgSumTokens;
}

// Floats of a product's partial sums, either source of its bias sums.
inline long long wg_part_floats(long long T, int M, int N) {
  const WgPlan p = wg_plan(T, M, N);
  const long long rows = std::max(wg_sum_rows(T, p, true), wg_sum_rows(T, p, false));
  return (long long)p.z * M * N + rows * N;
}

// The bf16 wgmma with both operands in shared memory, MN-major (transpose
// bits 1, 1): D = A B + (acc ? D : 0), A through descriptor da (64 x 16), B
// through db (16 x N).
template <int N>
struct WgmmaSS;

#define TRR_D8(o)                                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

template <>
struct WgmmaSS<64> {
  __device__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<192> {
  __device__ static void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
        "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<256> {
  __device__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
        "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
        "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
        "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : TRR_D8(0), TRR_D8(8), TRR_D8(16), TRR_D8(24), TRR_D8(32), TRR_D8(40),
          TRR_D8(48), TRR_D8(56), TRR_D8(64), TRR_D8(72), TRR_D8(80), TRR_D8(88),
          TRR_D8(96), TRR_D8(104), TRR_D8(112), TRR_D8(120)
        : "l"(da), "l"(db), "r"(acc));
  }
};

#undef TRR_D8

// Element (token k, column c) of a chunk's MN-major tile of W columns:
// core matrix (k / 8, c / 8) of the [k / 8][c / 8] grid, row k % 8,
// element c % 8.
template <int W>
__host__ __device__ constexpr int wg_tile_index(int k, int c) {
  return ((k / 8) * (W / 8) + c / 8) * 64 + (k % 8) * 8 + c % 8;
}

// The (kWgK, W) chunk of G (row stride ld) from token t0 and column c0 into
// the MN-major tile S; tokens >= te and columns >= clim read as 0. unit 16:
// 16-byte copies (clim a multiple of 8), else 8-byte ones (clim a multiple
// of 4). Eight lanes (sixteen) fill a core matrix, the next ones the next
// column group of the same tokens, which lies next to it.
template <int W>
__device__ __forceinline__ void wg_load_tile(bf16* S, const bf16* __restrict__ G, long long ld,
                                             long long t0, long long te, int c0, int clim,
                                             int unit) {
  constexpr int MG = W / 8;
  if (unit == 16) {
    constexpr int ALL = kWgK * MG;
    static_assert(ALL % kThreads == 0, "the copies must share out evenly");
#pragma unroll 4
    for (int i = 0; i < ALL / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int kr = e & 7, c = e >> 3, mg = c % MG, kg = c / MG;
      const long long t = t0 + kg * 8 + kr;
      const int col = c0 + mg * 8;
      const bool ok = t < te && col < clim;
      cp_async16(reinterpret_cast<float*>(S + (kg * MG + mg) * 64 + kr * 8),
                 reinterpret_cast<const float*>(ok ? G + t * ld + col : G), ok ? 16 : 0);
    }
  } else {
    constexpr int ALL = 2 * kWgK * MG;
    static_assert(ALL % kThreads == 0, "the copies must share out evenly");
#pragma unroll 4
    for (int i = 0; i < ALL / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int kr = e & 7, h = (e >> 3) & 1, c = e >> 4, mg = c % MG, kg = c / MG;
      const long long t = t0 + kg * 8 + kr;
      const int col = c0 + mg * 8 + 4 * h;
      const bool ok = t < te && col < clim;
      cp_async8(S + (kg * MG + mg) * 64 + kr * 8 + 4 * h, ok ? G + t * ld + col : G, ok ? 8 : 0);
    }
  }
}

// One block per (128-row tile of M, BN-column tile of N, token range of
// `chunk`): part[z] (M, N) = A^T B over the range, in fp32. ua, ub: the
// copy units of A and B (16 or 8 bytes). from_b: the bias sums are B's
// column sums, to colpart[(z * m-tiles + m-tile) * N + n] (this block's
// share of the range's chunks, zero where it has none): the eight lanes of
// octet o (of the block's 32) sum column group o, lane r its tokens r, r +
// 8, .., a whole core-matrix row (16 bytes) a read; the lanes are added by
// a fixed shuffle tree at the end.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    wg_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, long long T, int M,
                   int N, long long chunk, int ua, int ub, int from_b, float* __restrict__ part,
                   float* __restrict__ colpart) {
  constexpr int S = kWgStages, KG = kWgK / 8, AE = kWgK * kWgRows;
  constexpr int MA = kWgRows / 8, MB = BN / 8;  // column groups of the A and B tiles
  extern __shared__ __align__(16) float smem[];
  Ring<S> ring;
  ring.init(smem, kWgK * (kWgRows + BN) / 2);
  const int nm = gridDim.x, mi = blockIdx.x;
  const int m0 = mi * kWgRows, n0 = blockIdx.y * BN;
  const long long tb = (long long)blockIdx.z * chunk;
  const long long te = min(T, tb + chunk);
  const int n = (int)((te - tb + kWgK - 1) / kWgK);
  const int wg = threadIdx.x / 128, oct = threadIdx.x / 8, kr = threadIdx.x % 8;
  const bool sums = from_b && oct < MB;
  float acc[BN / 2];  // set by the first wgmma (scale-d 0): no other instruction defines them
  float cs[8];  // this lane's sums of its tokens in column group oct
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = 0.f;
  auto issue = [&](int j) {  // chunk j into stage j % S, once chunk j - S has left it
    if (j >= S) mbar_wait(ring.empty + j % S, ((j / S) - 1) & 1);
    bf16* st = reinterpret_cast<bf16*>(ring.stage(j));
    const long long t0 = tb + (long long)j * kWgK;
    wg_load_tile<kWgRows>(st, A, M, t0, te, m0, M, ua);
    wg_load_tile<BN>(st + AE, B, N, t0, te, n0, N, ub);
    mbar_arrive_copies(ring.full + j % S);
  };
  const int pre = n < S - 1 ? n : S - 1;
  for (int j = 0; j < pre; ++j) issue(j);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    mbar_wait(ring.full + i % S, (i / S) & 1);
    fence_proxy_async();  // the landed copies before the wgmmas read them
    const bf16* st = reinterpret_cast<const bf16*>(ring.stage(i));
    const bf16* sb = st + AE;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kWgK / 16; ++s)  // LBO: the next 8 tokens; SBO: the next 8 columns
      WgmmaSS<BN>::mma(
          acc, wgmma_desc(reinterpret_cast<const float*>(st + (2 * s * MA + 8 * wg) * 64),
                          MA * 128, 128),
          wgmma_desc(reinterpret_cast<const float*>(sb + 2 * s * MB * 64), MB * 128, 128),
          i > 0 || s > 0);
    wgmma_commit();
    fence_operands(acc);
    if (sums && i % nm == mi) {  // B's column sums, tokens kr, kr + 8, ..
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(sb + wg_tile_index<BN>(8 * kg + kr, 8 * oct));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          cs[2 * e] += f.x;
          cs[2 * e + 1] += f.y;
        }
      }
    }
    wgmma_wait_prev();  // chunk i - 1's wgmmas are done: its stage is free
    if (i > 0) mbar_arrive(ring.empty + (i - 1) % S);
    if (i + S - 1 < n) issue(i + S - 1);
  }
  wgmma_wait_all();
  fence_operands(acc);
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + acc_row(4 * j + 2 * h), c = n0 + acc_col(4 * j + 2 * h);
      if (m < M && c < N)
        *reinterpret_cast<float2*>(out + (size_t)m * N + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  if (from_b) {
    float* row = colpart + ((size_t)blockIdx.z * nm + mi) * N;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
      const int c = n0 + 8 * oct + e;
      if (sums && kr == 0 && c < N) row[c] = cs[e];
    }
  }
}

// colpart[s] (N) = the column sums of src (T, N; fp32, or bf16), each row
// times ss[t / hw] where ss is not null, over the tokens [s kWgSumTokens,
// (s + 1) kWgSumTokens): a lane four columns, a warp 64 tokens, the block's
// warps added in order; grid (ceil(N / 128), ceil(T / kWgSumTokens)). The
// rows' loads go out eight at a time; the sample of a row is followed from
// the warp's first (one division a warp, none a row).
template <typename TS>
__global__ void __launch_bounds__(kThreads)
    wg_colsum_kernel(const TS* __restrict__ src, const float* __restrict__ ss, long long hw,
                     long long T, int N, float* __restrict__ colpart) {
  constexpr int WT = kWgSumTokens / kWarps;
  __shared__ float4 red[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = 4 * (blockIdx.x * 32 + lane);
  const long long t0 = (long long)blockIdx.y * kWgSumTokens + warp * WT;
  const long long t1 = min(T, t0 + WT);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < N && t0 < t1) {
    long long sample = ss != nullptr ? t0 / hw : 0, next = (sample + 1) * hw;
    float sc = ss != nullptr ? __ldg(ss + sample) : 1.f;
#pragma unroll 1
    for (long long t = t0; t < t1; t += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = t + i < t1 ? ldg4(src + (t + i) * N + c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (t + i >= t1) break;
        if (ss != nullptr && t + i == next) {
          ++sample;
          next += hw;
          sc = __ldg(ss + sample);
        }
        acc.x += sc * v[i].x;
        acc.y += sc * v[i].y;
        acc.z += sc * v[i].z;
        acc.w += sc * v[i].w;
      }
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < N) {
    float4 s = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 v = red[w][lane];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(colpart + (size_t)blockIdx.y * N + c) = s;
  }
}

// out (M*N + N): the Z partial products (M*N floats each) and the S partial
// column-sum rows (N each), each added in order.
__global__ void __launch_bounds__(kThreads)
    wg_sum_kernel(const float* __restrict__ part, int Z, long long MN,
                  const float* __restrict__ colpart, int S, int N, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= MN + N) return;
  float acc = 0.f;
  if (i < MN) {
    for (int s = 0; s < Z; ++s) acc += __ldg(part + (size_t)s * MN + i);
  } else {
    for (int s = 0; s < S; ++s) acc += __ldg(colpart + (size_t)s * N + (i - MN));
  }
  out[i] = acc;
}

template <int BN>
cudaError_t wg_bf16_launch(const bf16* A, const bf16* B, long long T, int M, int N,
                           const WgPlan& p, int ua, int ub, int from_b, float* part,
                           float* colpart, cudaStream_t stream) {
  const int smem = wg_bf16_smem_bytes(BN);
  const cudaError_t err =
      cudaFuncSetAttribute(wg_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wg_bf16_kernel<BN><<<dim3(p.nm, p.nn, p.z), kThreads, smem, stream>>>(
      A, B, T, M, N, p.chunk, ua, ub, from_b, part, colpart);
  return cudaGetLastError();
}

// out (M*N + N) = (A^T B, the column sums of sf (T, N) fp32 or, where sf is
// null, of sb (T, N) bf16, each row times ss[t / hw] where ss is not null)
// over T tokens, A (T, M) and B (T, N) bf16 (M and N multiples of 4, both
// 8-byte aligned), through `part` (wg_part_floats(T, M, N) floats). sb == B
// with no ss: the sums come from the staged B tiles.
inline cudaError_t weight_grad_bf16(const bf16* A, const bf16* B, long long T, int M, int N,
                                    const float* sf, const bf16* sb, const float* ss,
                                    long long hw, float* part, float* out, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A), b = reinterpret_cast<uintptr_t>(B);
  if (M % 4 || N % 4 || a % 8 || b % 8 || (sf == nullptr && sb == nullptr))
    return cudaErrorInvalidValue;
  const WgPlan p = wg_plan(T, M, N);
  const bool from_b = sf == nullptr && sb == B && ss == nullptr;
  float* colpart = part + (size_t)p.z * M * N;
  const int rows = T > 0 ? (int)wg_sum_rows(T, p, from_b) : 0;
  cudaError_t err = cudaSuccess;
  if (T > 0) {
    const int ua = M % 8 == 0 && a % 16 == 0 ? 16 : 8, ub = N % 8 == 0 && b % 16 == 0 ? 16 : 8;
    switch (p.bn) {
      case 64: err = wg_bf16_launch<64>(A, B, T, M, N, p, ua, ub, from_b, part, colpart, stream); break;
      case 128: err = wg_bf16_launch<128>(A, B, T, M, N, p, ua, ub, from_b, part, colpart, stream); break;
      case 192: err = wg_bf16_launch<192>(A, B, T, M, N, p, ua, ub, from_b, part, colpart, stream); break;
      default: err = wg_bf16_launch<256>(A, B, T, M, N, p, ua, ub, from_b, part, colpart, stream);
    }
    if (err != cudaSuccess) return err;
    if (!from_b) {
      const dim3 grid((unsigned)((N / 4 + 31) / 32), (unsigned)rows);
      if (sf != nullptr)
        wg_colsum_kernel<float><<<grid, kThreads, 0, stream>>>(sf, ss, hw, T, N, colpart);
      else
        wg_colsum_kernel<bf16><<<grid, kThreads, 0, stream>>>(sb, ss, hw, T, N, colpart);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const long long MN = (long long)M * N;
  wg_sum_kernel<<<(unsigned)((MN + N + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, T > 0 ? p.z : 0, MN, colpart, rows, N, out);
  return cudaGetLastError();
}

}  // namespace trr
