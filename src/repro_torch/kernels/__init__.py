"""Hand-written CUDA kernels of the search path, each beside its plain
PyTorch version.

  distance_topk   — fused truncated-L2 scan + top-k (stage 0)
  gather_rescore  — candidate gather + rescore + top-k (each ladder step)

Search code calls the `ops` entry points, which send CUDA tensors to the
kernels and CPU tensors to the plain versions.  The kernels are compiled
from ``csrc/`` with nvcc at first use (`repro_torch.kernels._build`).
"""
