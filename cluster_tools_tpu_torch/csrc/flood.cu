// C entry point of kernel 1 (per-slice seeded flood), loaded with ctypes by
// cluster_tools_tpu_torch/ops/cuda_flood.py.  See flood.cuh for the design.
#include "flood.cuh"

extern "C" int ctt_flood_slices(const float* hmap, const int* seeds,
                                const int* mask, int* out, float* alt,
                                int* dist, int n, int h, int w, int* rounds,
                                void* stream) {
  if (n <= 0) return 0;
  ctt_flood_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(hmap, seeds, mask, out,
                                                        alt, dist, h, w, rounds);
  return (int)cudaGetLastError();
}
