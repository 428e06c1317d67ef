// C entry point of kernel 2 (fused per-slice DT-watershed), loaded with
// ctypes by cluster_tools_tpu_torch/ops/cuda_dtws.py.  Two routes, chosen by
// the slice's size before launch: the cluster kernel (dtws_cluster.cuh; the
// slice in shared memory) where ctt_dtws_cluster_smem(h, w, taps) is
// nonzero, else one thread block per slice over device scratch (dtws.cuh).
// The size rule lives here alone.
#include "dtws.cuh"
#include "dtws_cluster.cuh"

static std::atomic<unsigned long long> ctt_dtws_cluster_smem_set{0};
static std::atomic<unsigned long long> ctt_dtws_global_smem_set{0};

// Bytes of shared memory per CTA of the cluster route for (h, w) slices and
// gaussians of at most `n_taps` taps, or 0 when the slice does not fit and
// takes the global route.
extern "C" long long ctt_dtws_cluster_smem(int h, int w, int n_taps) {
  const size_t smem = ctt_dtws_cluster_bytes(h, w, n_taps < 1 ? 1 : n_taps);
  return smem <= CTT_SMEM_MAX ? (long long)smem : 0;
}

// Clusters of the cluster route the card runs at once for (h, w) slices
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int ctt_dtws_cluster_occupancy(int h, int w, int n_taps) {
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_dtws_cluster_kernel,
                                     &ctt_dtws_cluster_smem_set);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ctt_cluster_config(1, ctt_dtws_cluster_bytes(h, w, n_taps < 1 ? 1 : n_taps), 0, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, ctt_dtws_cluster_kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// `cluster` != 0 takes the cluster route, which the slice must fit
// (ctt_dtws_cluster_smem); dt, tmp, alt, dist and flags are the global
// route's scratch.
extern "C" int ctt_dtws_slices(
    const float* x, const int* mask, const int* valid, int* labels, int* roots,
    float* hmap, float* dt, float* tmp, float* alt, int* dist,
    unsigned char* flags, int n, int z, int h, int w, float threshold,
    float alpha, float beta, int invert, const float* seed_taps, int n_seed,
    const float* weight_taps, int n_weight, int* rounds, long long* stamps,
    int cluster, void* stream) {
  if (n <= 0) return 0;
  if (!cluster) {
    const int threads = 256;
    const size_t smem = (size_t)(w + 2 * threads) * sizeof(float);
    if (smem > CTT_SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = ctt_allow_smem_max((const void*)ctt_dtws_kernel, &ctt_dtws_global_smem_set);
    if (e != cudaSuccess) return (int)e;
    ctt_dtws_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        x, mask, valid, labels, roots, hmap, dt, tmp, alt, dist, flags, z, h, w,
        threshold, alpha, beta, invert, seed_taps, n_seed, weight_taps, n_weight,
        rounds, stamps);
    return (int)cudaGetLastError();
  }
  const int nt = n_seed > n_weight ? n_seed : n_weight;
  const size_t smem = (size_t)ctt_dtws_cluster_smem(h, w, nt);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_dtws_cluster_kernel,
                                     &ctt_dtws_cluster_smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ctt_cluster_config(n, smem, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, ctt_dtws_cluster_kernel, x, mask, valid, labels, roots, hmap, z,
                         h, w, threshold, alpha, beta, invert, seed_taps, n_seed, weight_taps,
                         n_weight, rounds, stamps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
