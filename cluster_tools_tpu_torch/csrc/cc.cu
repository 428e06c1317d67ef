// C entry points of kernels 4 (per-slice CC) and 5 (per-tile CC), loaded
// with ctypes by cluster_tools_tpu_torch/ops/cuda_cc.py.  See cc.cuh for the
// design.  Kernel 4 has two routes, chosen by the slice's size before
// launch: the cluster kernel (cc_cluster.cuh; the slice in shared memory)
// where ctt_cc_cluster_smem(h, w) is nonzero, else one thread block per
// slice over the output buffer (cc.cuh).  The size rules of kernel 4's
// routes and of kernel 5's tiles live here alone.
#include "cc.cuh"
#include "cc_cluster.cuh"

static std::atomic<unsigned long long> ctt_cc_cluster_smem_set{0};
static std::atomic<unsigned long long> ctt_cc_tiles_smem_set[2] = {{0}, {0}};

// Bytes of shared memory per CTA of kernel 4's cluster route for (h, w)
// slices, or 0 when the slice does not fit (or has 2^24 voxels or more:
// ctt_div) and takes the global route.
extern "C" long long ctt_cc_cluster_smem(int h, int w) {
  const size_t smem = ctt_cc_cluster_bytes(h, w);
  return smem <= CTT_SMEM_MAX && (long long)h * w < (1 << 24) ? (long long)smem : 0;
}

// Clusters of kernel 4's cluster route the card runs at once for (h, w)
// slices (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int ctt_cc_cluster_occupancy(int h, int w) {
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_cc_cluster_kernel,
                                     &ctt_cc_cluster_smem_set);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ctt_cluster_config(1, ctt_cc_cluster_bytes(h, w), 0, &attr, CTT_CC_CL_THREADS);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, ctt_cc_cluster_kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// `cluster` != 0 takes the cluster route, which the slice must fit
// (ctt_cc_cluster_smem).
extern "C" int ctt_cc_slices(const unsigned char* mask, int* out, int n,
                             int depth, int h, int w, int* rounds, int cluster,
                             void* stream) {
  if (n <= 0) return 0;
  if (!cluster) {
    ctt_cc_slices_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(mask, out, depth,
                                                             h, w, rounds);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)ctt_cc_cluster_smem(h, w);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = ctt_allow_smem_max((const void*)ctt_cc_cluster_kernel,
                                     &ctt_cc_cluster_smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ctt_cluster_config(n, smem, (cudaStream_t)stream, &attr, CTT_CC_CL_THREADS);
  e = cudaLaunchKernelEx(&cfg, ctt_cc_cluster_kernel, mask, out, depth, h, w, rounds);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory per CTA of kernel 5 for (th, tw) tiles, or
// 0 when the tile does not fit.
extern "C" long long ctt_cc_tiles_smem(int th, int tw) {
  if (th <= 0 || tw <= 0) return 0;
  const size_t smem = ctt_cc_tiles_bytes(th, tw);
  return smem <= CTT_SMEM_MAX ? (long long)smem : 0;
}

// Kernel 5 over an (n, h, w) stack in (th, tw) tiles.  rounds (one int per
// tile) and stamps (CTT_TILE_STAMPS int64 per tile: ns of the load, the row
// and column phases and pointer jumps of all rounds, and the store) are
// device buffers or null.  Returns a CUDA error code.
extern "C" int ctt_cc_tiles(const unsigned char* mask, int* out, int n,
                            int depth, int h, int w, int th, int tw,
                            int* rounds, long long* stamps, void* stream) {
  if (n <= 0) return 0;
  const int gh = (h + th - 1) / th, gw = (w + tw - 1) / tw;
  const size_t smem = (size_t)ctt_cc_tiles_smem(th, tw);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const bool timed = stamps != nullptr;
  cudaError_t err = ctt_allow_smem_max(timed ? (const void*)ctt_cc_tiles_kernel<true>
                                             : (const void*)ctt_cc_tiles_kernel<false>,
                                       &ctt_cc_tiles_smem_set[timed]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((size_t)n * gh * gw));
  if (timed)
    ctt_cc_tiles_kernel<true><<<grid, CTT_K5_THREADS, smem, (cudaStream_t)stream>>>(
        mask, out, depth, h, w, th, tw, gh, gw, rounds, stamps);
  else
    ctt_cc_tiles_kernel<false><<<grid, CTT_K5_THREADS, smem, (cudaStream_t)stream>>>(
        mask, out, depth, h, w, th, tw, gh, gw, rounds, nullptr);
  return (int)cudaGetLastError();
}
