// C entry points of kernels 4 (per-slice CC) and 5 (per-tile CC), loaded
// with ctypes by cluster_tools_tpu_torch/ops/cuda_cc.py.  See cc.cuh for the
// design.
#include "cc.cuh"

extern "C" int ctt_cc_slices(const unsigned char* mask, int* out, int n,
                             int depth, int h, int w, int* rounds,
                             void* stream) {
  if (n <= 0) return 0;
  ctt_cc_slices_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(mask, out, depth,
                                                           h, w, rounds);
  return (int)cudaGetLastError();
}

extern "C" int ctt_cc_tiles(const unsigned char* mask, int* out, int n,
                            int depth, int h, int w, int th, int tw,
                            int* rounds, void* stream) {
  if (n <= 0) return 0;
  const int gh = (h + th - 1) / th, gw = (w + tw - 1) / tw;
  const size_t smem = (size_t)th * (tw + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ctt_cc_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctt_cc_tiles_kernel<<<(unsigned)((size_t)n * gh * gw), 128, smem,
                        (cudaStream_t)stream>>>(mask, out, depth, h, w, th, tw,
                                                gh, gw, rounds);
  return (int)cudaGetLastError();
}
