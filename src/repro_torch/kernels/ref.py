"""Plain-PyTorch oracles for the port's kernels.

Each function is the mathematical specification a kernel must match — no
tiling, no masking tricks, just the math — mirroring the JAX package's
oracles of the same names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def l2_topk_ref(
    q: Tensor, db: Tensor, k: int, db_sq: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Exact top-k by rank-equivalent L2 score ``||x||^2 - 2 q.x``.

    Returns ((Q, k) scores ascending, (Q, k) int32 indices); equal scores
    keep the lower row index.
    """
    db = db.to(torch.float32)
    if db_sq is None:
        db_sq = (db * db).sum(dim=-1)
    s = db_sq[None, :] - 2.0 * (q.to(torch.float32) @ db.T)
    top_s, idx = torch.sort(s, dim=1, stable=True)
    return top_s[:, :k], idx[:, :k].to(torch.int32)


def gather_rescore_ref(q: Tensor, db: Tensor, cand: Tensor) -> Tensor:
    """Distances of each query to its own candidate rows at full dims.

    Args:
      q:    (Q, D); db: (N, D); cand: (Q, C) int32, -1 = padding.
    Returns:
      (Q, C) float32 scores, +inf at padded slots.
    """
    rows = db[torch.clamp(cand, min=0).long()].to(torch.float32)  # (Q, C, D)
    sq = (rows * rows).sum(dim=-1)
    ip = torch.einsum("qd,qcd->qc", q.to(torch.float32), rows)
    s = sq - 2.0 * ip
    return s.masked_fill(cand < 0, float("inf"))


def _smallest(s: Tensor, cand: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k smallest of each row of ``s`` (ties to the earlier column),
    their ids from ``cand`` and -1 where the score is not finite."""
    top_s, pos = torch.sort(s, dim=1, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    idx = torch.gather(cand, 1, pos)
    idx = torch.where(torch.isfinite(top_s), idx, torch.full_like(idx, -1))
    return top_s, idx.to(torch.int32)


def ivf_scan_ref(
    q: Tensor, db: Tensor, member_ids: Tensor, probe: Tensor, *, dim: int,
    k: int,
) -> Tuple[Tensor, Tensor]:
    """Fused IVF stage-0 oracle: exact top-k over each query's probed lists.

    Args:
      q:          (Q, D) queries; db: (N, D) corpus.
      member_ids: (n_lists, max_len) int32 global ids, -1 = masked/padding.
      probe:      (Q, n_probe) int32 probed list indices (distinct per row).
      dim:        stage-0 truncation; k: neighbours kept (k <= C).
    Returns:
      ((Q, k) scores ascending, +inf empties; (Q, k) int32 ids, -1 empties).
    """
    cand = member_ids[probe.long()].reshape(q.shape[0], -1)
    s = gather_rescore_ref(q[:, :dim], db[:, :dim], cand)
    return _smallest(s, cand, k)


def pq_adc_ref(lut: Tensor, codes: Tensor) -> Tensor:
    """ADC scores of every query against every coded row.

    Args:
      lut:   (Q, M, C) per-query lookup tables (rank-equivalent distances).
      codes: (N, M) uint8 PQ codes.
    Returns:
      (Q, N) float32: ``sum_m lut[q, m, codes[n, m]]``, summed over m in
      order.
    """
    idx = codes.long()
    acc = lut[:, 0, :][:, idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + lut[:, j, :][:, idx[:, j]]
    return acc


def pq_scan_ref(
    lut: Tensor, codes: Tensor, ids: Tensor, *, k: int
) -> Tuple[Tensor, Tensor]:
    """Fused flat PQ scan oracle: exact ADC top-k over masked rows.

    Args:
      lut:   (Q, M, C) per-query lookup tables.
      codes: (N, M) uint8 codes.
      ids:   (N,) int32 ids, -1 = masked (tombstoned / uncoded).
      k:     neighbours kept (k <= N).
    Returns:
      ((Q, k) scores ascending, +inf empties; (Q, k) int32 ids, -1 empties).
    """
    s = pq_adc_ref(lut, codes)
    s = s.masked_fill(ids[None, :] < 0, float("inf"))
    return _smallest(s, ids[None, :].expand(s.shape[0], -1), k)


def pq_ivf_scan_ref(
    lut: Tensor, codes: Tensor, member_ids: Tensor, probe: Tensor, *, k: int
) -> Tuple[Tensor, Tensor]:
    """Fused IVF-PQ stage-0 oracle: ADC top-k over each query's probed lists.

    Args:
      lut:        (Q, M, C) per-query lookup tables.
      codes:      (N, M) uint8 codes indexed by *global* doc id.
      member_ids: (n_lists, max_len) int32 global ids, -1 = masked/padding.
      probe:      (Q, n_probe) int32 probed lists (distinct per row).
      k:          neighbours kept (k <= C).
    Returns:
      ((Q, k) scores ascending, +inf empties; (Q, k) int32 ids, -1 empties).
    """
    cand = member_ids[probe.long()].reshape(lut.shape[0], -1)
    idx = codes.long()[torch.clamp(cand, min=0).long()]     # (Q, C, M)
    acc = torch.gather(lut[:, 0, :], 1, idx[:, :, 0])
    for j in range(1, idx.shape[2]):
        acc = acc + torch.gather(lut[:, j, :], 1, idx[:, :, j])
    acc = acc.masked_fill(cand < 0, float("inf"))
    return _smallest(acc, cand, k)


def flash_attention_ref(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
    window: Optional[int] = None, scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Dense softmax attention with the flash kernel's rules.

    Args:
      q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh), Hq a multiple of Hkv
         (q head h reads kv head ``h // (Hq / Hkv)``).
      causal / window: the mask, queries aligned to the end of kv (query
         row i sits at position ``i + Skv - Sq``); key j is kept when
         ``j <= pos`` (causal) and ``j > pos - window`` (window given).
      scale: ``Dh ** -0.5`` unless given.

    Masked scores are -1e30 and their weights exactly 0; the weights are
    rounded to v's dtype before the product with V and the row sum is taken
    over the unrounded weights; the output is ``(p V) / max(l, 1e-30)`` in
    q's dtype, so a row with nothing to attend gives 0 (the JAX package's
    ``flash_attention_ref`` uses -inf and gives NaN there).  With
    ``return_lse``, (out, lse): lse the float32 (B, Hq, Sq) log-sum-exp of
    each row's kept scores from the same scores, -inf on a row with none.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if skv == 0:                                  # nothing to attend
        out = torch.zeros_like(q)
        if return_lse:
            return out, torch.full((b, hq, sq), float("-inf"),
                                   device=q.device)
        return out
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    lse = (torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
           if return_lse else None)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    out = (pv / torch.clamp(l, min=1e-30)).to(q.dtype)
    return (out, lse) if return_lse else out


def embedding_bag_ref(
    table: Tensor, indices: Tensor, *, mode: str = "sum",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """EmbeddingBag: reduce table rows per bag.

    Args:
      table:   (V, D) embedding table, or stacked (F, V, D) per-field tables.
      indices: (B, L) int ids for a (V, D) table, (B, F, L) for stacked
               tables; negative = padding; ids >= V read row V - 1 (the JAX
               package's gather clamps them so).
      mode:    'sum' | 'mean' | 'max'.
      weights: optional per-sample weights of the shape of ``indices``
               (sum / mean only).
    Returns:
      (B, D) or (B, F, D) float32; an all-padding bag gives 0.  Sums are
      taken over the bag in id order, one row at a time (the kernel's
      order, so the two agree bit for bit).
    """
    v = table.shape[-2]
    safe = indices.clamp(0, v - 1).long()
    if table.dim() == 3:
        field = torch.arange(table.shape[0], device=table.device)[None, :, None]
        rows = table[field, safe].to(torch.float32)       # (B, F, L, D)
    else:
        rows = table[safe].to(torch.float32)              # (B, L, D)
    valid = (indices >= 0)[..., None].to(torch.float32)
    if weights is not None:
        rows = rows * weights[..., None]
    if mode in ("sum", "mean"):
        acc = rows.new_zeros(rows.shape[:-2] + rows.shape[-1:])
        for l in range(rows.shape[-2]):
            acc = acc + rows[..., l, :] * valid[..., l, :]
        if mode == "sum":
            return acc
        return acc / valid.sum(dim=-2).clamp(min=1.0)
    if mode == "max":
        neg = torch.where(valid > 0, rows, torch.full_like(rows, -float("inf")))
        out = neg.amax(dim=-2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown mode {mode}")


def segment_sum_ref(data: Tensor, segment_ids: Tensor,
                    num_segments: int) -> Tensor:
    """Scatter-add rows of ``data`` into ``num_segments`` buckets
    (``index_add_``); ids outside [0, num_segments) are dropped, as in
    ``jax.ops.segment_sum``.  Returns data's dtype."""
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    seg = torch.where(keep, seg, torch.full_like(seg, num_segments))
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out.index_add_(0, seg, data)
    return out[:num_segments]
