"""The RAG pipeline (retrieval on the engine, generation on the LM) and the
paper's synthetic corpora."""

from repro_torch.rag.corpus import (SyntheticCorpus, make_clustered_corpus,
                                    make_corpus, to_device)
from repro_torch.rag.pipeline import RAGPipeline, mean_pool_embedder

__all__ = ["RAGPipeline", "SyntheticCorpus", "make_clustered_corpus",
           "make_corpus", "mean_pool_embedder", "to_device"]
