// C entry points of kernel 3 (tile-local altitude warm start) and the 3d
// flood, loaded with ctypes by cluster_tools_tpu_torch/ops/cuda_flood.py.
// See flood3d.cuh and tile_scan.cuh for the design.
#include "flood3d.cuh"

static std::atomic<unsigned long long> ctt_flood_tiles_smem_set[2] = {{0}, {0}};
static std::atomic<unsigned long long> ctt_flood3d_smem_set[2] = {{0}, {0}};

// Bytes of dynamic shared memory per CTA of kernel 3 for (th, tw) tiles, or
// 0 when the tile does not fit: the size rule, here alone.
extern "C" long long ctt_flood_tiles_smem(int th, int tw) {
  if (th <= 0 || tw <= 0) return 0;
  const size_t smem = ctt_flood_tiles_bytes(th, tw);
  return smem <= CTT_SMEM_MAX ? (long long)smem : 0;
}

// Kernel 3 over an (n, h, w) stack in (th, tw) tiles.  rounds (one int per
// tile) and stamps (CTT_TILE_STAMPS int64 per tile: ns of the load, the row
// and column phases of all rounds and the store) are device buffers or
// null.  Returns a CUDA error code.
extern "C" int ctt_flood_tiles_warm(const float* hmap, const int* seeds,
                                    const unsigned char* mask, float* out,
                                    int n, int h, int w, int th, int tw,
                                    int* rounds, long long* stamps, void* stream) {
  if (n <= 0) return 0;
  const int gh = (h + th - 1) / th, gw = (w + tw - 1) / tw;
  const size_t smem = (size_t)ctt_flood_tiles_smem(th, tw);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const bool timed = stamps != nullptr;
  cudaError_t err = ctt_allow_smem_max(
      timed ? (const void*)ctt_flood_tiles_warm_kernel<true>
            : (const void*)ctt_flood_tiles_warm_kernel<false>,
      &ctt_flood_tiles_smem_set[timed]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((size_t)n * gh * gw));
  if (timed)
    ctt_flood_tiles_warm_kernel<true><<<grid, CTT_K3_THREADS, smem, (cudaStream_t)stream>>>(
        hmap, seeds, mask, out, h, w, th, tw, gh, gw, rounds, stamps);
  else
    ctt_flood_tiles_warm_kernel<false><<<grid, CTT_K3_THREADS, smem, (cudaStream_t)stream>>>(
        hmap, seeds, mask, out, h, w, th, tw, gh, gw, rounds, nullptr);
  return (int)cudaGetLastError();
}

// Blocks per SM of the 3d flood for a batch of n voxels.  One block per SM
// keeps a thread's state in 128 registers; two give twice the warps with
// 64 registers and spills.  Measured on an H100 (PERF.md): one 36 x 272 x
// 272 block (2.7 M voxels) runs faster with one, a batch of 8 (21 M) with
// two; the cut lies between.
static int ctt_flood3d_blocks(long long n) { return n < (8ll << 20) ? 1 : 2; }

static const void* ctt_flood3d_fn(int blocks) {
  return blocks == 1 ? (const void*)ctt_flood3d_kernel<1> : (const void*)ctt_flood3d_kernel<2>;
}

// Blocks of the 3d flood's cooperative grid on the current device for a
// batch of n voxels: as many as are co-resident (one wave), or minus a
// CUDA error code.
extern "C" int ctt_flood3d_grid(long long n) {
  const int blocks = ctt_flood3d_blocks(n);
  const void* fn = ctt_flood3d_fn(blocks);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = ctt_allow_smem_max(fn, &ctt_flood3d_smem_set[blocks - 1]);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, CTT_F3_THREADS, CTT_F3_SMEM);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// The 3d seeded flood of a (b, z, h, w) batch (z * h * w < 2^31): one
// cooperative launch, then one host sync to read the round counts.  hm,
// alt, dist and eb are scratch of the batch's size, flags scratch of
// b * (z * h + z * w + h * w) bytes, lab receives the labels
// (0 off the mask), state is 3 device ints, warm is null or the phase-1 warm
// altitudes, stamps null or CTT_F3_STAMPS device int64 (ctt_flood3d_kernel).
// rounds (host, 2 ints) receives the rounds of each phase, or is null.
// Returns a CUDA error code.
extern "C" int ctt_flood3d(const float* hmap, const int* seeds,
                           const unsigned char* mask, const float* warm,
                           float* hm, float* alt, int* dist, int* lab,
                           unsigned char* eb, unsigned char* flags, int* state,
                           long long* stamps, int b,
                           int z, int h, int w, int* rounds, void* stream) {
  const long long n = (long long)b * z * h * w;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = ctt_flood3d_grid(n);
  if (grid <= 0) return grid < 0 ? -grid : (int)cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err = cudaMemsetAsync(state, 0, 3 * sizeof(int), st);
  if (err == cudaSuccess && stamps != nullptr)
    err = cudaMemsetAsync(stamps, 0, CTT_F3_STAMPS * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  Ctt3dGeom g{b, z, h, w};
  void* args[] = {&hmap, &seeds, &mask, &warm, &hm,    &alt,    &dist,
                  &lab,  &eb,    &flags, &state, &stamps, &g};
  err = cudaLaunchCooperativeKernel(ctt_flood3d_fn(ctt_flood3d_blocks(n)), dim3(grid),
                                    dim3(CTT_F3_THREADS), args, CTT_F3_SMEM, st);
  if (err != cudaSuccess) return (int)err;
  int r[2];
  err = cudaMemcpyAsync(r, state + 1, sizeof(r), cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return (int)err;
  if (rounds != nullptr) {
    rounds[0] = r[0];
    rounds[1] = r[1];
  }
  return 0;
}
