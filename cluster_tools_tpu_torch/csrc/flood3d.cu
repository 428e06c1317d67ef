// C entry points of kernel 3 (tile-local altitude warm start) and the 3d
// sweep flood, loaded with ctypes by cluster_tools_tpu_torch/ops/cuda_flood.py.
// See flood3d.cuh for the design.
#include "flood3d.cuh"

extern "C" int ctt_flood_tiles_warm(const float* hmap, const int* seeds,
                                    const unsigned char* mask, float* out,
                                    int n, int h, int w, int th, int tw,
                                    int* rounds, void* stream) {
  if (n <= 0) return 0;
  const int gh = (h + th - 1) / th, gw = (w + tw - 1) / tw;
  const size_t smem = 2 * (size_t)th * (tw + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ctt_flood_tiles_warm_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctt_flood_tiles_warm_kernel<<<(unsigned)((size_t)n * gh * gw), 128, smem,
                                (cudaStream_t)stream>>>(
      hmap, seeds, mask, out, h, w, th, tw, gh, gw, rounds);
  return (int)cudaGetLastError();
}

// One phase of the 3d flood to its fixpoint: rounds of six sweeps (z, y, x,
// each forward and backward) until a round changes nothing.  The flag is
// read back once per round.  Returns a CUDA error code; *rounds receives the
// round count (the last, unchanged round included).
static int ctt_flood3d_phase(int phase, const float* hm, float* alt, int* dist,
                             int* lab, int* flag, Ctt3dLines g, int b,
                             cudaStream_t st, int* rounds) {
  const long long nlines[3] = {(long long)b * g.H * g.W,
                               (long long)b * g.Z * g.W,
                               (long long)b * g.Z * g.H};
  const int threads = 128;
  int r = 0;
  for (;;) {
    cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    for (int axis = 0; axis < 3; ++axis) {
      const unsigned blocks = (unsigned)((nlines[axis] + threads - 1) / threads);
      for (int rev = 0; rev < 2; ++rev) {
        if (phase == 1)
          ctt_alt_sweep3d_kernel<<<blocks, threads, 0, st>>>(
              hm, alt, g, axis, rev, nlines[axis], flag);
        else
          ctt_assign_sweep3d_kernel<<<blocks, threads, 0, st>>>(
              hm, alt, dist, lab, g, axis, rev, nlines[axis], flag);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
    }
    int changed = 0;
    err = cudaMemcpyAsync(&changed, flag, sizeof(int), cudaMemcpyDeviceToHost, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamSynchronize(st);
    if (err != cudaSuccess) return (int)err;
    ++r;
    if (!changed) break;
  }
  *rounds = r;
  return 0;
}

// The 3d seeded flood of a (b, z, h, w) batch.  hm, alt and dist are
// scratch of the batch's size, lab receives the labels (0 off the mask),
// flag is one device int, warm is null or the phase-1 warm altitudes.
// rounds (host, 2 ints) receives the rounds of each phase, or is null.
extern "C" int ctt_flood3d(const float* hmap, const int* seeds,
                           const unsigned char* mask, const float* warm,
                           float* hm, float* alt, int* dist, int* lab,
                           int* flag, int b, int z, int h, int w, int* rounds,
                           void* stream) {
  const long long n = (long long)b * z * h * w;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long want = (n + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  ctt_flood3d_init_kernel<<<blocks, 256, 0, st>>>(hmap, seeds, mask, warm, hm,
                                                  alt, dist, lab, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Ctt3dLines g{z, h, w};
  int r1 = 0, r2 = 0;
  int rc = ctt_flood3d_phase(1, hm, alt, dist, lab, flag, g, b, st, &r1);
  if (rc != 0) return rc;
  rc = ctt_flood3d_phase(2, hm, alt, dist, lab, flag, g, b, st, &r2);
  if (rc != 0) return rc;
  if (rounds != nullptr) {
    rounds[0] = r1;
    rounds[1] = r2;
  }
  return 0;
}
