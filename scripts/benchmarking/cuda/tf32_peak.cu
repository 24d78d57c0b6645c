// wgmma tf32 with A from registers and B (K-major, no swizzle) from shared
// memory: descriptor check and throughput; and mma.sync tf32 peak.
// Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o tf32_peak scripts/benchmarking/cuda/tf32_peak.cu && ./tf32_peak
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// d (64 x 16 over the warpgroup: 8 floats a thread) += a (regs) b (desc)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1));
}

// B: K = 8, N = 16, K-major core matrices: [n/8][k/4][8 rows][4] floats
__global__ void check(const float* A, const float* B, float* D, int lbo, int sbo) {
  __shared__ __align__(128) float Bs[16 * 8];
  const int t = threadIdx.x;
  for (int e = t; e < 128; e += 128) {
    const int n = e / 8, k = e % 8;
    Bs[((n / 8) * 2 + k / 4) * 32 + (n % 8) * 4 + k % 4] = B[k * 16 + n];
  }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  const int r = warp * 16 + g;
  uint32_t a[4] = {__float_as_uint(A[r * 8 + q]), __float_as_uint(A[(r + 8) * 8 + q]),
                   __float_as_uint(A[r * 8 + q + 4]), __float_as_uint(A[(r + 8) * 8 + q + 4])};
  float d[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  wg_fence();
  wgmma_n16(d, a, make_desc(Bs, lbo, sbo));
  wg_commit();
  wg_wait0();
  for (int j = 0; j < 2; ++j) {
    D[r * 16 + 8 * j + 2 * q] = d[4 * j];
    D[r * 16 + 8 * j + 2 * q + 1] = d[4 * j + 1];
    D[(r + 8) * 16 + 8 * j + 2 * q] = d[4 * j + 2];
    D[(r + 8) * 16 + 8 * j + 2 * q + 1] = d[4 * j + 3];
  }
}

// throughput: m64n192k8 repeated, B fixed in shared memory
__device__ __forceinline__ void wgmma_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,"
      "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,"
      "%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,"
      "%90,%91,%92,%93,%94,%95}, {%96,%97,%98,%99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1));
}

__global__ void __launch_bounds__(256, 1) wg_peak(float* out, int iters) {
  __shared__ __align__(128) float Bs[192 * 8];
  for (int e = threadIdx.x; e < 192 * 8; e += 256) Bs[e] = 0.001f * (e % 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[96];
  for (int i = 0; i < 96; ++i) d[i] = 0.f;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  const uint64_t bd = make_desc(Bs, 128, 256);
  for (int it = 0; it < iters; ++it) {
    wg_fence();
    wgmma_n192(d, a, bd);
    wgmma_n192(d, a, bd);
    wgmma_n192(d, a, bd);
    wg_commit();
    wg_wait0();
  }
  float s = 0;
  for (int i = 0; i < 96; ++i) s += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void __launch_bounds__(256) ms_peak(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) mma_tf32(acc[j], a, b);
  }
  float s = 0;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  // descriptor check
  float hA[64 * 8], hB[8 * 16], hD[64 * 16], ref[64 * 16];
  for (int i = 0; i < 64 * 8; ++i) hA[i] = (float)((i * 37) % 11) - 5.f;
  for (int i = 0; i < 8 * 16; ++i) hB[i] = (float)((i * 13) % 7) - 3.f;
  for (int r = 0; r < 64; ++r)
    for (int n = 0; n < 16; ++n) {
      float s = 0;
      for (int k = 0; k < 8; ++k) s += hA[r * 8 + k] * hB[k * 16 + n];
      ref[r * 16 + n] = s;
    }
  float *A, *B, *D;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&D, sizeof hD);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  const int variants[2][2] = {{128, 256}, {256, 128}};
  for (auto& v : variants) {
    cudaMemset(D, 0, sizeof hD);
    check<<<1, 128>>>(A, B, D, v[0], v[1]);
    cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(hD, D, sizeof hD, cudaMemcpyDeviceToHost);
    double err = 0;
    for (int i = 0; i < 64 * 16; ++i) err = fmax(err, fabs(hD[i] - ref[i]));
    printf("desc lbo %d sbo %d: max err %g (%s)\n", v[0], v[1], err, cudaGetErrorString(e));
  }
  float* out; cudaMalloc(&out, 264 * 256 * 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    const int iters = 2048;
    wg_peak<<<132, 256>>>(out, iters);
    cudaEventRecord(e0);
    wg_peak<<<132, 256>>>(out, iters);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("wgmma m64n192k8 tf32 (RS): %.1f TFLOP/s (%s)\n",
           2.0 * 64 * 192 * 8 * 3 * iters * 2 * 132 / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
    ms_peak<<<264, 256>>>(out, 4096);
    cudaEventRecord(e0);
    ms_peak<<<264, 256>>>(out, 4096);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("mma.sync m16n8k8 tf32: %.1f TFLOP/s (%s)\n", 2.0 * 16 * 8 * 8 * 16 * 4096 * 8 * 264 / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
