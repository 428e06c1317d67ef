// C entry point of kernel 1 (per-slice seeded flood), loaded with ctypes by
// cluster_tools_tpu_torch/ops/cuda_flood.py.  Two routes, chosen by the
// slice's size before launch: the cluster kernel (flood_cluster.cuh; the
// slice in shared memory) where ctt_flood_cluster_smem(h, w) is nonzero,
// else one thread block per slice over device scratch `alt`/`dist`
// (flood.cuh).  The size rule lives here alone.
#include "flood.cuh"
#include "flood_cluster.cuh"

static std::atomic<unsigned long long> ctt_flood_cluster_smem_set{0};

// Bytes of shared memory per CTA of the cluster route for (h, w) slices, or
// 0 when the slice does not fit and takes the global route.
extern "C" long long ctt_flood_cluster_smem(int h, int w) {
  const size_t smem = ctt_flood_cluster_bytes(h, w);
  return smem <= CTT_SMEM_MAX ? (long long)smem : 0;
}

// Clusters of the cluster route the card runs at once for (h, w) slices
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int ctt_flood_cluster_occupancy(int h, int w) {
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_flood_cluster_kernel,
                                     &ctt_flood_cluster_smem_set);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ctt_cluster_config(1, ctt_flood_cluster_bytes(h, w), 0, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, ctt_flood_cluster_kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// `cluster` != 0 takes the cluster route, which the slice must fit
// (ctt_flood_cluster_smem); `alt` and `dist` are the global route's scratch.
extern "C" int ctt_flood_slices(const float* hmap, const int* seeds,
                                const int* mask, int* out, float* alt,
                                int* dist, int n, int h, int w, int* rounds,
                                long long* stamps, int cluster, void* stream) {
  if (n <= 0) return 0;
  if (!cluster) {
    ctt_flood_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(hmap, seeds, mask, out, alt, dist,
                                                          h, w, rounds, stamps);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)ctt_flood_cluster_smem(h, w);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_flood_cluster_kernel,
                                     &ctt_flood_cluster_smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ctt_cluster_config(n, smem, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, ctt_flood_cluster_kernel, hmap, seeds, mask, out, h, w, rounds,
                         stamps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
