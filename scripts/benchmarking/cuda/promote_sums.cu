// linear_kernel (trainner_redux_tpu_torch/csrc/tc_rows.cuh), out = A W + b,
// with its promoted product adding the partial sums to the fp32 accumulator
// every 1, 2 (the engine's kPromoteChunks) or 4 chunks, or never (one wgmma
// accumulator over the whole depth). scripts/benchmarking/chip_promote_sums.py
// builds it as a shared library and calls `promote_linear`:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//     -Xcompiler -fPIC -o libpromote_sums.so scripts/benchmarking/cuda/promote_sums.cu
#include "../../../trainner_redux_tpu_torch/csrc/tc_rows.cuh"

using namespace trr;

template <int PROMOTE>
static int launch(const float* A, const float* W, const float* b, float* out, long long T, int K,
                  int N, cudaStream_t stream) {
  const int smem = linear_smem_bytes();
  const cudaError_t err =
      cudaFuncSetAttribute(linear_kernel<kColTile, true, kLinearBias, PROMOTE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)((T + kTcRows - 1) / kTcRows) * (unsigned)((N + kColTile - 1) / kColTile);
  linear_kernel<kColTile, true, kLinearBias, PROMOTE>
      <<<grid, kThreads, smem, stream>>>(A, W, b, nullptr, nullptr, out, T, 1, K, N);
  return (int)cudaGetLastError();
}

// out (T, N) = A (T, K) W (K, N) + b, K and N multiples of 4; `every` 1, 2
// or 4 chunks, else never.
extern "C" int promote_linear(int every, const float* A, const float* W, const float* b,
                              float* out, long long T, int K, int N, cudaStream_t stream) {
  switch (every) {
    case 1:
      return launch<1>(A, W, b, out, T, K, N, stream);
    case 2:
      return launch<2>(A, W, b, out, T, K, N, stream);
    case 4:
      return launch<4>(A, W, b, out, T, K, N, stream);
    default:
      return launch<1 << 20>(A, W, b, out, T, K, N, stream);
  }
}
