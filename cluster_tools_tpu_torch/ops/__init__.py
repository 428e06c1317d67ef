"""Block operators in PyTorch; the two hand-written CUDA kernels live in
``cuda_flood`` and ``cuda_dtws`` (sources under ``../csrc``)."""
