"""Models: the LM of the RAG path (``repro_torch.models.lm``: dense GQA,
local:global, MoE and MLA families), the recsys models and EGNN."""
