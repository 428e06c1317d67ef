"""Block operators in PyTorch; the hand-written CUDA kernels live in
``cuda_flood``, ``cuda_dtws`` and ``cuda_cc`` (sources under ``../csrc``)."""
