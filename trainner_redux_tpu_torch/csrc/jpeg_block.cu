// The DiffJPEG block transform, fp32, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _jpeg_core_kernel
// (trainner_redux_tpu/ops/pallas/jpeg_kernel.py, jpeg_block_transform,
// pallas_call at :62). Per flattened 8x8 block x (64 level-shifted spatial
// values) of sample b, with that sample's quantisation table qtab (64):
//
//     c_u  = sum_k dct[u, k] x_k                     (DCT)
//     y_u  = c_u / qtab_u;  r = rint(y_u);  q_u = r + (y_u - r)^3
//     out_k = sum_u (q_u qtab_u) idct[u, k]          (IDCT)
//
// rint rounds halves to even, as jnp.round and torch.round do.
//
// What bounds it on the card. Per block it reads 256 bytes, writes 256 and
// does 16,384 flops of products (two 64x64 matrix-vector products): 32
// flops a byte, above the fp32 ridge of 67 TFLOP/s over 3.35 TB/s (20
// flops a byte), so a large call is bound by fp32 arithmetic. The
// training path calls it on a few hundred blocks a plane, where one launch
// is all it costs.
//
// Design. One thread block of 256 threads takes a tile of 32 consecutive
// blocks of the flattened (B * N) blocks. The DCT (transposed by the
// caller) and the IDCT, 16 KB each, and the tile go to shared memory. A
// thread owns one coefficient u (t % 64) of 8 blocks (t / 64 + 4 j): it
// sums c_u over k in order, four k at a time (one 16-byte broadcast read of
// the block, four conflict-free reads of the matrix column), quantises, and
// after a barrier writes q_u qtab_u over the tile; then the same thread, now
// as output k, sums over u in order and stores. Each block's coefficients
// never leave the SM. Blocks of two samples may share a tile: every thread
// reads the table of its own block's sample.
#include <cuda_runtime.h>
#include <math.h>

namespace trr {

constexpr int kJpegThreads = 256;
constexpr int kJpegTile = 32;                            // blocks of a thread block
constexpr int kJpegGroups = kJpegThreads / 64;           // 4 blocks in flight per column
constexpr int kJpegPer = kJpegTile / kJpegGroups;        // 8 blocks per thread

__global__ void __launch_bounds__(kJpegThreads)
    jpeg_block_kernel(const float* __restrict__ x, const float* __restrict__ qtab,
                      const float* __restrict__ dct_t, const float* __restrict__ idct,
                      float* __restrict__ out, int total, int n) {
  __shared__ __align__(16) float dctT[64 * 64];  // dctT[k * 64 + u] = dct[u, k]
  __shared__ __align__(16) float idc[64 * 64];   // idc[u * 64 + k] = idct[u, k]
  __shared__ __align__(16) float tile[kJpegTile * 64];

  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * kJpegTile;
  const int nb = (int)min((long long)kJpegTile, (long long)total - first);

  for (int e = t; e < 64 * 64 / 4; e += kJpegThreads) {
    reinterpret_cast<float4*>(dctT)[e] = __ldg(reinterpret_cast<const float4*>(dct_t) + e);
    reinterpret_cast<float4*>(idc)[e] = __ldg(reinterpret_cast<const float4*>(idct) + e);
  }
  const float4* src = reinterpret_cast<const float4*>(x + first * 64);
  for (int e = t; e < kJpegTile * 16; e += kJpegThreads) {
    reinterpret_cast<float4*>(tile)[e] =
        e / 16 < nb ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int col = t % 64, grp = t / 64;
  float acc[kJpegPer];
#pragma unroll
  for (int j = 0; j < kJpegPer; ++j) acc[j] = 0.f;

  // DCT: c_u of the thread's blocks, k in order
#pragma unroll 4
  for (int k = 0; k < 64; k += 4) {
    const float d0 = dctT[k * 64 + col], d1 = dctT[(k + 1) * 64 + col];
    const float d2 = dctT[(k + 2) * 64 + col], d3 = dctT[(k + 3) * 64 + col];
#pragma unroll
    for (int j = 0; j < kJpegPer; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(tile + (grp + kJpegGroups * j) * 64 + k);
      acc[j] = fmaf(v.x, d0, acc[j]);
      acc[j] = fmaf(v.y, d1, acc[j]);
      acc[j] = fmaf(v.z, d2, acc[j]);
      acc[j] = fmaf(v.w, d3, acc[j]);
    }
  }
  // quantise with the differentiable round, dequantise
#pragma unroll
  for (int j = 0; j < kJpegPer; ++j) {
    const int blk = grp + kJpegGroups * j;
    if (blk < nb) {
      const float q = __ldg(qtab + ((first + blk) / n) * 64 + col);
      const float y = acc[j] / q;
      const float r = rintf(y);
      const float d = y - r;
      acc[j] = (r + d * d * d) * q;
    }
  }
  __syncthreads();  // every thread has read the tile
#pragma unroll
  for (int j = 0; j < kJpegPer; ++j) tile[(grp + kJpegGroups * j) * 64 + col] = acc[j];
  __syncthreads();

  // IDCT: out_k of the thread's blocks, u in order (the thread is now column k)
#pragma unroll
  for (int j = 0; j < kJpegPer; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int u = 0; u < 64; u += 4) {
    const float m0 = idc[u * 64 + col], m1 = idc[(u + 1) * 64 + col];
    const float m2 = idc[(u + 2) * 64 + col], m3 = idc[(u + 3) * 64 + col];
#pragma unroll
    for (int j = 0; j < kJpegPer; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(tile + (grp + kJpegGroups * j) * 64 + u);
      acc[j] = fmaf(v.x, m0, acc[j]);
      acc[j] = fmaf(v.y, m1, acc[j]);
      acc[j] = fmaf(v.z, m2, acc[j]);
      acc[j] = fmaf(v.w, m3, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kJpegPer; ++j) {
    const int blk = grp + kJpegGroups * j;
    if (blk < nb) out[(first + blk) * 64 + col] = acc[j];
  }
}

}  // namespace trr

extern "C" {

// x, out: (total, 64) fp32, the B * N flattened blocks of (B, N, 64);
// qtab (B, 64) fp32; dct_t (64, 64) the DCT transposed (dct_t[k][u] =
// dct[u][k]); idct (64, 64). All contiguous, x and out 16-byte aligned;
// total * 64 < 2^31.
int trr_jpeg_block(const float* x, const float* qtab, const float* dct_t, const float* idct,
                   float* out, int total, int n, cudaStream_t stream) {
  if (total <= 0) return 0;
  const unsigned blocks = (unsigned)((total + trr::kJpegTile - 1) / trr::kJpegTile);
  trr::jpeg_block_kernel<<<blocks, trr::kJpegThreads, 0, stream>>>(x, qtab, dct_t, idct, out,
                                                                     total, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
