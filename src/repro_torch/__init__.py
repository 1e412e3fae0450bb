"""PyTorch / CUDA port of progressive retrieval and its serving engine.

Beside the JAX package ``repro`` (the reference), this package runs the
flat progressive-search serving path on an NVIDIA H100: stage 0 and every
rescore step are hand-written CUDA kernels (``csrc/``), and the engine,
driver, batching and observability layers are the same host code.

  repro_torch.core            — schedules, prefix-norm index, plain search
  repro_torch.kernels         — CUDA kernels + device dispatch (``ops``)
  repro_torch.index_backends  — the flat backend behind the engine
  repro_torch.engine          — DocStore, RetrievalEngine, EngineDriver
  repro_torch.obs             — metrics registry and request traces

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
