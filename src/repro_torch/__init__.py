"""PyTorch / CUDA port of progressive retrieval and its serving engine.

Beside the JAX package ``repro`` (the reference), this package runs the
progressive-search serving path and the RAG generation path on an NVIDIA
H100: stage 0, every rescore step and the LM's attention are hand-written
CUDA kernels (``csrc/``), and the engine, driver, batching and
observability layers are the same host code.

  repro_torch.core            — schedules, prefix-norm index, plain search
  repro_torch.kernels         — CUDA kernels + device dispatch (``ops``)
  repro_torch.index_backends  — flat, IVF and quantized backends
  repro_torch.engine          — DocStore, RetrievalEngine, EngineDriver,
                                the mutation WAL, recovery, supervision
                                and WAL-shipped replication
  repro_torch.serve           — HTTP front end, tenant quotas and the
                                replica router (the JAX package's wire
                                protocol)
  repro_torch.checkpoint      — checkpoints in the JAX package's format
                                (npz + msgpack manifest, own codec)
  repro_torch.obs             — metrics registry and request traces
  repro_torch.configs         — the architecture registry (five LM
                                families, recsys, EGNN)
  repro_torch.layers          — norms, FFN, RoPE, GQA attention (windows,
                                ring caches), MoE, MLA
  repro_torch.models          — the LM (dense GQA, local:global, MoE,
                                MLA; prefill, decode), recsys, EGNN
  repro_torch.rag             — RAGPipeline: retrieve, assemble, generate
  repro_torch.sharding        — logical-axis rules over a named
                                ``DeviceMesh`` and the collectives of the
                                multi-device paths (``torch.distributed``)
  repro_torch.launch          — the serving launcher (closed-loop demo,
                                HTTP server, router and client modes) and
                                the paper's experiment driver

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
