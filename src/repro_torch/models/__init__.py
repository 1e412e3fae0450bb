"""Models of the RAG path: the dense GQA LM (``repro_torch.models.lm``)."""
