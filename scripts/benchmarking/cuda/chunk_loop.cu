// The per-token product loop (dy = A W^T, K = 540, C = 180 in a 192-column
// tile, 128 tokens a block) with parts left out, to see what a chunk costs.
// The loop here waits for each chunk's wgmmas before the next chunk (one
// group in flight at a time, two split buffers). Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o chunk_loop scripts/benchmarking/cuda/chunk_loop.cu && ./chunk_loop
#include <cstdio>
#include "../../../trainner_redux_tpu_torch/csrc/tc_gemm.cuh"
using namespace trr;
constexpr int KC = 16, LD = 20, BN = 192;
constexpr int SF = 128 * LD + BN * LD;
constexpr int CONV = 2 * 2 * BN * KC;

// MODE bits: 1 split B, 2 A fragments, 4 barrier, 8 wgmma
template <int MODE>
__global__ void __launch_bounds__(256, 1) bench(const float* A, const float* W, long long T, int K, float* out) {
  extern __shared__ __align__(16) float smem[];
  float* conv = smem;
  Ring<> ring;
  ring.init(smem + CONV, SF);
  const long long t0 = (long long)blockIdx.x * 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, ar = 16 * (threadIdx.x / 32);
  float acc[BN / 2];
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring.run((K + KC - 1) / KC,
      [&](int j, float* st) {
        load_tile<128, KC>(st, LD, A, K, t0, T, j * KC, K);
        load_tile<BN, KC>(st + 128 * LD, LD, W, K, 0, 180, j * KC, K);
      },
      [&](int j, const float* st) {
        float* cb = conv + (j & 1) * 2 * BN * KC;
        if (MODE & 1) split_to_core<BN, KC, true>(st + 128 * LD, LD, cb);
        uint32_t ah[KC / 8][4], al[KC / 8][4];
        for (int s = 0; s < KC / 8; ++s) {
          if (MODE & 2) {
            const float* a = st + (ar + g) * LD + 8 * s + q;
            const float v[4] = {a[0], a[8 * LD], a[4], a[8 * LD + 4]};
            for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[s][e], al[s][e]);
          } else {
            for (int e = 0; e < 4; ++e) { ah[s][e] = __float_as_uint(1.f); al[s][e] = 0; }
          }
        }
        if (MODE & 4) { fence_proxy_async(); __syncthreads(); }
        if (MODE & 8) {
          wgmma_fence();
          for (int s = 0; s < KC / 8; ++s) {
            const uint64_t dh = wgmma_desc(cb + 64 * s, 128, KC * 32);
            const uint64_t dl = wgmma_desc(cb + BN * KC + 64 * s, 128, KC * 32);
            Wgmma<BN>::mma(acc, al[s], dh);
            Wgmma<BN>::mma(acc, ah[s], dl);
            Wgmma<BN>::mma(acc, ah[s], dh);
          }
          wgmma_commit();
          wgmma_wait_all();
        } else {
          acc[0] += __uint_as_float(ah[0][0] ^ al[KC / 8 - 1][3]);
        }
      });
  float s = 0;
  for (int i = 0; i < BN / 2; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int MODE>
void run(const float* A, const float* W, long long T, int K, float* out) {
  const int smem = CONV * 4 + Ring<>::bytes(SF);
  cudaFuncSetAttribute(bench<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const unsigned blocks = (unsigned)((T + 127) / 128);
  bench<MODE><<<blocks, 256, smem>>>(A, W, T, K, out);
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) { printf("mode %d: %s\n", MODE, cudaGetErrorString(e)); exit(1); }
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 10; ++r) bench<MODE><<<blocks, 256, smem>>>(A, W, T, K, out);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  printf("mode %2d (split B %d, A frags %d, barrier %d, wgmma %d): %.4f ms\n", MODE, MODE & 1, (MODE >> 1) & 1,
         (MODE >> 2) & 1, (MODE >> 3) & 1, ms / 10);
}

int main() {
  setvbuf(stdout, NULL, _IONBF, 0);
  const long long T = 32768;
  const int K = 540;
  float *A, *W, *out;
  cudaMalloc(&A, T * K * 4); cudaMalloc(&W, 256 * 576 * 4); cudaMalloc(&out, 1024 * 256 * 4);
  cudaMemset(A, 0, T * K * 4); cudaMemset(W, 0, 256 * 576 * 4);
  run<0>(A, W, T, K, out);
  run<1>(A, W, T, K, out);
  run<2>(A, W, T, K, out);
  run<4>(A, W, T, K, out);
  run<8>(A, W, T, K, out);
  run<12>(A, W, T, K, out);
  run<7>(A, W, T, K, out);
  run<15>(A, W, T, K, out);
  return 0;
}
