// The DiffJPEG block transform, fp32 in 3xTF32 on the tensor cores, for
// sm_90a.
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
// What bounds it on the card. A block is a row of two (M, 64) x (64, 64)
// products: 256 bytes read, 256 written, 16,384 flops. At 8 x 4096 blocks
// that is 0.549 GFLOP over 16.78 MB: 0.0033 ms in 3xTF32 (3 x operations at
// 495 TFLOP/s) against 0.0050 ms for the bytes, so the bytes bound a large
// call. DiffJPEG calls it on a few hundred blocks a plane (the OTF path's
// 8 x 36 Y and 8 x 9 C blocks), where the launch and one tile's chain of
// dependent loads and products are all it costs.
//
// Design. Both products run on mma.sync m16n8k8 in 3xTF32 (tc_gemm.cuh's
// fragments, operands split by truncation, lo*hi + hi*lo + hi*hi a k-step
// of 8), k-steps 0-3 and 4-7 summed apart and then added: two chains of 12
// dependent products an output tile, not one of 24. The matrices are
// constants: the wrapper splits them once into TF32 hi and lo and lays them
// out in B-fragment order (jpeg_kernel.py's `dct_matrices`), so a lane reads
// its (hi b0, hi b1, lo b0, lo b1) of a k-step and n-tile as one 16-byte
// load. A thread block of 4 warps takes tiles of 64 / CW consecutive blocks
// of one plane, CW warps an m-tile of 16 blocks, 8 / CW n-tiles of 8
// columns each. The DCT's sums stay in the accumulator fragments, where each
// element, knowing its row's sample and its coefficient u, is divided by
// qtab_u, rounded with rintf and dequantised; the dequantised tile goes to
// shared memory as the IDCT's A, and the output back through the input's
// tile and out in 16-byte stores.
// The two regimes, chosen from the call's block count:
//   a few hundred blocks (the path's planes): tiles of 16 (CW 4), so a
//     plane of 8 x 36 blocks spreads over 18 SMs; a warp loads both
//     products' fragments (2 x 16 of 16 bytes) into registers before
//     anything waits;
//   from two tiles of 32 for each SM: tiles of 32 (CW 2), each warp's
//     fragments loaded as its products run.
// One launch takes up to three planes (Y, Cb, Cr of a compression), each
// with its own blocks, tables and block count a sample, given by value; a
// tile never spans two planes, and blocks of two samples may share one:
// every row reads the table of its own sample. A block's output does not
// depend on the tile or the call it is in. No atomics: two runs give the
// same output bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include "tc_gemm.cuh"

namespace trr {

constexpr int kJpegWarps = 4, kJpegThreads = 32 * kJpegWarps;
constexpr int kJpegLd = 68;  // a tile row: 64 values and 4 of padding, so fragment loads hit 32 banks
constexpr int kJpegPlanes = 3;

// One plane of a call: x and out (total, 64), `n` blocks a sample, qtab
// (total / n, 64); its tiles start at tile0 of the call's.
struct JpegPlane {
  const float* x;
  const float* qtab;
  float* out;
  int total, n, tile0;
};

struct JpegPlanes {
  JpegPlane p[kJpegPlanes];
};

__device__ __forceinline__ JpegPlane plane_of(const JpegPlanes& planes, int t) {
  return t >= planes.p[2].tile0 ? planes.p[2] : t >= planes.p[1].tile0 ? planes.p[1] : planes.p[0];
}

// acc = A B over the 64-deep rows of this warp's m-tile at A (rows kJpegLd
// apart) and its NT n-tiles, B's split fragments from frag(k-step, n-tile):
// k-steps 0-3 and 4-7 into two sums, then added.
template <int NT, class Frag>
__device__ __forceinline__ void jpeg_product(float (&acc)[NT][4], const float* A, Frag frag) {
  float part[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[h][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    MmaA a;
    mma_load_a<false>(a, A + 8 * ks, kJpegLd);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 b = frag(ks, j);
      const uint32_t h0 = __float_as_uint(b.x), h1 = __float_as_uint(b.y);
      mma_tf32(part[ks / 4][j], a.l, h0, h1);
      mma_tf32(part[ks / 4][j], a.h, __float_as_uint(b.z), __float_as_uint(b.w));
      mma_tf32(part[ks / 4][j], a.h, h0, h1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[0][j][e] + part[1][j][e];
}

// frags: (2, 8 k-steps, 8 n-tiles, 32 lanes) float4, the DCT's B (B(k, u) =
// dct[u, k]) then the IDCT's (B(u, k) = idct[u, k]). CW warps take each
// m-tile of 16 blocks, 8 / CW n-tiles each: a tile of 64 / CW blocks a
// thread block. HOLD: a warp's fragments of both products are loaded into
// registers first.
template <int CW, bool HOLD>
__global__ void __launch_bounds__(kJpegThreads)
    jpeg_tc_kernel(const JpegPlanes planes, const float4* __restrict__ frags) {
  constexpr int NT = 8 / CW, ROWS = 16 * (kJpegWarps / CW);
  __shared__ __align__(16) float xs[ROWS * kJpegLd];  // the blocks, then the output
  __shared__ __align__(16) float ds[ROWS * kJpegLd];  // the dequantised coefficients

  const int t = blockIdx.x;
  const JpegPlane pl = plane_of(planes, t);
  const int first = (t - pl.tile0) * ROWS, nb = min(ROWS, pl.total - first);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  const int m0 = 16 * (warp / CW), nt0 = NT * (warp % CW);
  const float4* fd = frags + nt0 * 32 + lane;               // the DCT's, at n-tile nt0
  const float4* fi = frags + 8 * 8 * 32 + nt0 * 32 + lane;  // the IDCT's
  float4 held[HOLD ? 2 : 1][HOLD ? 8 : 1][HOLD ? NT : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        held[0][ks][j] = __ldg(fd + (ks * 8 + j) * 32);
        held[1][ks][j] = __ldg(fi + (ks * 8 + j) * 32);
      }
  }
  // the tables of this thread's two rows (g and g + 8 of its m-tile)
  const float* qrow[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + g + 8 * i;
    live[i] = r < nb;
    qrow[i] = pl.qtab + (size_t)((first + (live[i] ? r : 0)) / pl.n) * 64;
  }
  const float4* src = reinterpret_cast<const float4*>(pl.x + (size_t)first * 64);
  for (int e = threadIdx.x; e < ROWS * 16; e += kJpegThreads)
    *reinterpret_cast<float4*>(xs + (e / 16) * kJpegLd + 4 * (e % 16)) =
        e / 16 < nb ? __ldg(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float acc[NT][4];
  if constexpr (HOLD)
    jpeg_product<NT>(acc, xs + m0 * kJpegLd, [&](int ks, int j) { return held[0][ks][j]; });
  else
    jpeg_product<NT>(acc, xs + m0 * kJpegLd,
                     [&](int ks, int j) { return __ldg(fd + (ks * 8 + j) * 32); });
  // quantise with the differentiable round and dequantise, in the fragments
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = 8 * (nt0 + j) + 2 * q4;
      float2 v = make_float2(0.f, 0.f);
      if (live[i]) {
        const float2 qt = make_float2(__ldg(qrow[i] + u), __ldg(qrow[i] + u + 1));
        const float y0 = acc[j][2 * i] / qt.x, y1 = acc[j][2 * i + 1] / qt.y;
        const float r0 = rintf(y0), r1 = rintf(y1);
        const float d0 = y0 - r0, d1 = y1 - r1;
        v = make_float2((r0 + d0 * d0 * d0) * qt.x, (r1 + d1 * d1 * d1) * qt.y);
      }
      *reinterpret_cast<float2*>(ds + (m0 + g + 8 * i) * kJpegLd + u) = v;
    }
  __syncthreads();  // the dequantised rows whole; every read of the input tile done

  if constexpr (HOLD)
    jpeg_product<NT>(acc, ds + m0 * kJpegLd, [&](int ks, int j) { return held[1][ks][j]; });
  else
    jpeg_product<NT>(acc, ds + m0 * kJpegLd,
                     [&](int ks, int j) { return __ldg(fi + (ks * 8 + j) * 32); });
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(xs + (m0 + g + 8 * i) * kJpegLd + 8 * (nt0 + j) + 2 * q4) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  __syncthreads();  // the output tile whole
  float4* dst = reinterpret_cast<float4*>(pl.out + (size_t)first * 64);
  for (int e = threadIdx.x; e < nb * 16; e += kJpegThreads)
    dst[e] = *reinterpret_cast<const float4*>(xs + (e / 16) * kJpegLd + 4 * (e % 16));
}

__global__ void empty_kernel() {}

}  // namespace trr

extern "C" {

// Planes i < count: x_i and out_i (total_i, 64) fp32, the B * n_i flattened
// blocks of (B, n_i, 64), 16-byte aligned; qtab_i (total_i / n_i, 64) fp32;
// total_i * 64 < 2^31. frags: the split DCT and IDCT in B-fragment order
// (jpeg_tc_kernel). One launch for all of them.
int trr_jpeg_planes(const float* frags, int count, const float* x0, const float* q0, float* o0,
                    int total0, int n0, const float* x1, const float* q1, float* o1, int total1,
                    int n1, const float* x2, const float* q2, float* o2, int total2, int n2,
                    cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (count < 1 || count > trr::kJpegPlanes) return (int)cudaErrorInvalidValue;
  trr::JpegPlanes planes = {{{x0, q0, o0, total0, n0, 0},
                             {x1, q1, o1, total1, n1, 0},
                             {x2, q2, o2, total2, n2, 0}}};
  long long blocks = 0;
  for (int i = 0; i < count; ++i) blocks += planes.p[i].total;
  // tiles of 32 from two of them for each SM, else tiles of 16
  const bool large = (blocks + 31) / 32 >= 2LL * sms;
  const int rows = large ? 32 : 16;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    planes.p[i].tile0 = tiles;
    tiles += (planes.p[i].total + rows - 1) / rows;
  }
  for (int i = count; i < trr::kJpegPlanes; ++i) planes.p[i].tile0 = tiles;  // never taken
  if (tiles == 0) return 0;
  const float4* f = reinterpret_cast<const float4*>(frags);
  if (large)
    trr::jpeg_tc_kernel<2, false><<<tiles, trr::kJpegThreads, 0, stream>>>(planes, f);
  else
    trr::jpeg_tc_kernel<4, true><<<tiles, trr::kJpegThreads, 0, stream>>>(planes, f);
  return (int)cudaGetLastError();
}

// An empty kernel of one warp: the launch floor that #15's times at the
// path's planes are read against.
int trr_empty_launch(cudaStream_t stream) {
  trr::empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
