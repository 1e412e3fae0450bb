"""Hand-written CUDA kernels of the search path, the LM, the recsys models
and EGNN, each beside its plain PyTorch version.

  distance_topk   — fused truncated-L2 scan + top-k (stage 0)
  gather_rescore  — candidate gather + rescore + top-k (each ladder step)
  ivf_scan        — IVF stage 0 over float32 / int8 list-major slabs
  pq_scan         — PQ ADC stage 0, flat and over list-major code slabs
  flash_attention — fused online-softmax attention (LM prefill and decode)
  embedding_bag   — per-bag gather + sum / mean over stacked field tables
                    (every recsys lookup)
  segment_sum     — sum over receiver-sorted rows by CSR pointer (every
                    EGNN aggregation)

Search, LM, recsys and GNN code call the `ops` entry points, which send
CUDA tensors to the kernels and CPU tensors to the plain versions.  The
kernels are compiled from ``csrc/`` with nvcc at first use
(`repro_torch.kernels._build`).
"""
