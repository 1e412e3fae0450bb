"""Transformer layers of the LM (norms, FFN, RoPE, GQA attention)."""
