"""The RAG pipeline: retrieval on the engine, generation on the LM."""

from repro_torch.rag.pipeline import RAGPipeline, mean_pool_embedder

__all__ = ["RAGPipeline", "mean_pool_embedder"]
