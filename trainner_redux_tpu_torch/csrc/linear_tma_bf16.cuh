// #1 bf16's two products (qkv = bf16(bf16(y wq) + bf16(bq)), and proj with
// the residual z = bf16(x + bf16(bf16(s) bf16(bf16(att wp) + bf16(bp))))) on
// Hopper's copy engine and wgmma, for sm_90a: the TMA-fed form of
// tc_rows_bf16.cuh's linear_bf16_kernel, whose roundings and epilogues it
// keeps (trainner_redux_tpu/ops/pallas/fused_block.py:468-511,
// _attn_block_fwd_kernel).
//
// What bounds it on the card. At SRFormerV2's block (T 82,944, C 240) qkv
// is 28.7 GFLOP (29 us on the bf16 tensor cores) against 159 MB of y in and
// qkv out (48 us at 3.35 TB/s); proj 9.6 GFLOP (10 us) against 120 MB of
// att, x and z (36 us): bytes bound both. linear_bf16_kernel took 0.3361 and
// 0.1761 ms: each 128-token block staged its weight column tile again,
// re-laid every chunk into core matrices in a second shared-memory pass and
// took A through registers, on 8-byte cp.async copies.
//
// What the design does about it:
//   - Both operands go by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//     straight into wgmma's shared-memory layout and by descriptor into
//     wgmma (K-major both: the caller hands the weight as W^T, (N, K), the
//     cast it makes anyway): no re-lay pass, no A in registers. A chunk is
//     64 deep (128 bytes a row, the swizzle's span); K past the matrix reads
//     as zero (TMA's bounds), and a k-step wholly past K is skipped.
//   - A persistent grid, one block a SM: block b owns column tile b mod
//     ncol (128 columns) and keeps its W^T tile resident (K <= 256: 64 KB)
//     while it walks the token tiles b / ncol, b / ncol + grid / ncol, ...
//   - A ring of kLtStages A chunks (128 tokens x 64, 16 KB), fed by one
//     producer warp (one lane issues the copies, each chunk's mbarrier
//     counting its bytes) while two consumer warpgroups (64 tokens each)
//     run wgmma m64n128k16 on the chunks that have landed; each consumer
//     thread frees a chunk's slot (an empty mbarrier of 256 arrivals) once
//     its warpgroup's wgmmas on it are done.
//   - A warpgroup keeps one chunk's wgmmas in flight while it issues the
//     next chunk's (wait_group 1), freeing the older chunk's slot then.
//   - The epilogue rounds the accumulators as linear_bf16_kernel does
//     (bf16(bf16(A W) + bf16(b))) into a bf16 tile in shared memory (rows
//     kLtEpLd apart: the pairs' stores hit 32 banks), then the warpgroup
//     moves its 64 rows out 16 bytes a thread, the residual's x read and
//     bf16(x + bf16(bf16(s) y)) formed on the way.
// Shapes it takes (a stated rule, linear_tma_fits): K a multiple of 8 (16-
// byte rows for TMA) and at most 256, N a multiple of 8, the bases 16-byte
// aligned; the caller takes linear_bf16 otherwise.
#pragma once

#include <cuda.h>

#include <algorithm>

#include "tc_rows_bf16.cuh"

namespace trr {

constexpr int kLtRows = 128;     // tokens of a tile: two consumer warpgroups of 64
constexpr int kLtCols = 128;     // columns of a tile (wgmma n)
constexpr int kLtK = 64;         // depth of a chunk: 128 bytes a row
constexpr int kLtMaxK = 256;     // the resident W^T tile's depth
constexpr int kLtStages = 4;     // A chunks in flight
constexpr int kLtThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kLtChunkBytes = kLtRows * kLtK * 2;  // an A chunk (and a W^T chunk: 128 rows too)
constexpr int kLtEpLd = kLtCols + 8;  // bf16 between two rows of the epilogue tile

// Shared memory: 1,024 bytes of alignment slack, the W^T tile (kLtMaxK /
// kLtK chunks), the A ring, the (128, kLtEpLd) bf16 epilogue tile, and the
// mbarriers.
__host__ __device__ constexpr int linear_tma_smem_bytes() {
  return 1024 + (kLtMaxK / kLtK + kLtStages) * kLtChunkBytes + 2 * kLtRows * kLtEpLd +
         8 * (2 * kLtStages + 1);
}

// The wgmma descriptor of a K-major operand tile with the 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1,024 bytes apart; the tile 1,024-byte
// aligned), from p (a k-step's offset added to the start address).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // LBO: unused by a swizzled K-major layout
  d |= (uint64_t)(1024 >> 4) << 32;  // SBO: the 8-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// D (64 x 128) = A B + (acc ? D : 0), both K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_k128(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// Arm `bar` for `bytes` more bytes of copies, and arrive.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The (kLtK, 128-row) box of the 2-D tensor map at (k, row) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int k, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// out (T, N) from A (T, K) and W (K, N) through their tensor maps (A's, and
// W^T's (N, K)), as EPI says (kLinearBias, kLinearResidual with x (T, N) and
// s (T / hw)), rounded as linear_bf16_kernel rounds. ncol column tiles; the
// grid a multiple of ncol.
template <int EPI>
__global__ void __launch_bounds__(kLtThreads, 1)
    linear_tma_bf16_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__
                           CUtensorMap tmw, const float* __restrict__ b,
                           const bf16* __restrict__ x, const float* __restrict__ s,
                           bf16* __restrict__ out, long long T, long long hw, int K, int N,
                           int ncol) {
  extern __shared__ __align__(16) uint8_t lt_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(lt_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int WCH = kLtMaxK / kLtK;
  uint8_t* ws = base;                             // (WCH, 128, 64) the W^T tile
  uint8_t* as = base + WCH * kLtChunkBytes;       // (kLtStages, 128, 64) the A ring
  bf16* ep = reinterpret_cast<bf16*>(as + kLtStages * kLtChunkBytes);  // (128, kLtEpLd)
  uint64_t* full = reinterpret_cast<uint64_t*>(ep + kLtRows * kLtEpLd);
  uint64_t* empty = full + kLtStages;
  uint64_t* wbar = empty + kLtStages;
  const int chunks = (K + kLtK - 1) / kLtK;
  const int n0 = (int)(blockIdx.x % ncol) * kLtCols;
  const long long tiles = (T + kLtRows - 1) / kLtRows;
  const long long first = blockIdx.x / ncol, stride = gridDim.x / ncol;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kLtStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * 128);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == 256) {
      mbar_expect_tx(wbar, chunks * kLtChunkBytes);
      for (int c = 0; c < chunks; ++c)
        tma_load_2d(ws + c * kLtChunkBytes, &tmw, c * kLtK, n0, wbar);
      long long it = 0;
      for (long long t = first; t < tiles; t += stride)
        for (int c = 0; c < chunks; ++c, ++it) {
          const int slot = (int)(it % kLtStages);
          if (it >= kLtStages) mbar_wait(empty + slot, (uint32_t)((it / kLtStages - 1) & 1));
          mbar_expect_tx(full + slot, kLtChunkBytes);
          tma_load_2d(as + slot * kLtChunkBytes, &tma, c * kLtK, (int)(t * kLtRows), full + slot);
        }
    }
    return;
  }
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 tokens of a tile
  bf16* et = ep + wg * 64 * kLtEpLd;  // its rows of the epilogue tile
  mbar_wait(wbar, 0);
  long long it = 0;
  for (long long t = first; t < tiles; t += stride) {
    float acc[64];
    int prev = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int slot = (int)(it % kLtStages);
      mbar_wait(full + slot, (uint32_t)((it / kLtStages) & 1));
      wgmma_fence();
      const uint8_t* a = as + slot * kLtChunkBytes + wg * 64 * 128;
      const uint8_t* w = ws + c * kLtChunkBytes;
#pragma unroll
      for (int k = 0; k < kLtK / 16; ++k)
        if (c * kLtK + 16 * k < K)
          wgmma_ss_k128(acc, wgmma_desc_sw128(a + 32 * k), wgmma_desc_sw128(w + 32 * k),
                        c > 0 || k > 0);
      wgmma_commit();
      if (c > 0) {  // the previous chunk's wgmmas are done: its slot is free
        wgmma_wait_prev();
        mbar_arrive(empty + prev);
      }
      prev = slot;
    }
    wgmma_wait_all();
    mbar_arrive(empty + prev);
    // the epilogue: y = bf16(bf16(acc) + bf16(b)) into the tile (a thread's
    // elements in rows acc_row(0) - 64 wg and 8 below it) ...
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the last tile's reads are done
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int cc = acc_col(i), r = acc_row(i) - 64 * wg;
      const float2 bb = n0 + cc < N ? __ldg(reinterpret_cast<const float2*>(b + n0 + cc))
                                    : make_float2(0.f, 0.f);
      *reinterpret_cast<uint32_t*>(et + r * kLtEpLd + cc) =
          pack_f32(rbf(acc[i]) + rbf(bb.x), rbf(acc[i + 1]) + rbf(bb.y));
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the tile is whole
    // ... then out, 16 bytes (8 columns) a thread, the residual on the way
    const long long t0 = t * kLtRows + 64 * wg;
#pragma unroll 2
    for (int e = threadIdx.x % 128; e < 64 * (kLtCols / 8); e += 128) {
      const int r = e / (kLtCols / 8), cc = 8 * (e % (kLtCols / 8));
      const long long tt = t0 + r;
      if (tt >= T || n0 + cc >= N) continue;
      uint4 v = *reinterpret_cast<const uint4*>(et + r * kLtEpLd + cc);
      if constexpr (EPI == kLinearResidual) {
        const float sc = rbf(__ldg(s + tt / hw));
        const uint4 xv = *reinterpret_cast<const uint4*>(x + tt * N + n0 + cc);
        uint32_t* vv = reinterpret_cast<uint32_t*>(&v);
        const uint32_t* xx = reinterpret_cast<const uint32_t*>(&xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vv + q));
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xx + q));
          vv[q] = pack_f32(r2.x + rbf(sc * y.x), r2.y + rbf(sc * y.y));
        }
      }
      *reinterpret_cast<uint4*>(out + tt * N + n0 + cc) = v;
    }
  }
}

// Whether linear_tma_bf16 takes a product: K a multiple of 8 (rows of 16
// bytes) up to kLtMaxK, N a multiple of 8 (the epilogue's 16-byte moves),
// A, W^T, out and x 16-byte aligned.
inline bool linear_tma_fits(const void* A, const void* Wt, const void* out, const void* x, int K,
                            int N) {
  return K % 8 == 0 && K <= kLtMaxK && N % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(Wt) |
          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(x)) %
                 16 ==
             0;
}

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda).
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

inline TensorMapEncode tensor_map_encode() {
  static TensorMapEncode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncode>(p);
  }
  return fn;
}

// The tensor map of a row-major bf16 (rows, cols) matrix in boxes of (kLtK
// columns, 128 rows), 128-byte swizzle, zeros past its bounds.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const bf16* p, long long rows, int cols) {
  const TensorMapEncode encode = tensor_map_encode();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kLtK, kLtRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out (T, N) = the EPI of A (T, K) W, W given as Wt = W^T (N, K), on the
// persistent TMA-fed kernel (linear_tma_fits must hold).
template <int EPI = kLinearBias>
inline cudaError_t linear_tma_bf16(const bf16* A, const bf16* Wt, const float* b, bf16* out,
                                   long long T, int K, int N, cudaStream_t stream,
                                   const bf16* x = nullptr, const float* s = nullptr,
                                   long long hw = 1) {
  if (!linear_tma_fits(A, Wt, out, x, K, N)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  CUtensorMap ma, mw;
  cudaError_t err = tensor_map_2d(&ma, A, T, K);
  if (err == cudaSuccess) err = tensor_map_2d(&mw, Wt, N, K);
  if (err != cudaSuccess) return err;
  const int bytes = linear_tma_smem_bytes();
  err = cudaFuncSetAttribute(linear_tma_bf16_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ncol = (N + kLtCols - 1) / kLtCols;
  const long long tiles = (T + kLtRows - 1) / kLtRows;
  const long long per_col = std::min<long long>(std::max(sms / ncol, 1), tiles);
  linear_tma_bf16_kernel<EPI><<<(unsigned)(per_col * ncol), kLtThreads, bytes, stream>>>(
      ma, mw, b, x, s, out, T, hw, K, N, ncol);
  return cudaGetLastError();
}

}  // namespace trr
