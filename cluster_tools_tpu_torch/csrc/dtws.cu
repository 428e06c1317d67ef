// C entry point of kernel 2 (fused per-slice DT-watershed), loaded with
// ctypes by cluster_tools_tpu_torch/ops/cuda_dtws.py.  See dtws.cuh.
#include "dtws.cuh"

extern "C" int ctt_dtws_slices(
    const float* x, const int* mask, const int* valid, int* labels, int* roots,
    float* hmap, float* dt, float* tmp, float* alt, int* dist,
    unsigned char* flags, int n, int z, int h, int w, float threshold,
    float alpha, float beta, int invert, const float* seed_taps, int n_seed,
    const float* weight_taps, int n_weight, int* rounds, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const size_t smem = (size_t)(w + 2 * threads) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ctt_dtws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ctt_dtws_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      x, mask, valid, labels, roots, hmap, dt, tmp, alt, dist, flags, z, h, w,
      threshold, alpha, beta, invert, seed_taps, n_seed, weight_taps, n_weight,
      rounds);
  return (int)cudaGetLastError();
}
