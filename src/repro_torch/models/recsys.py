"""RecSys serving: two-tower retrieval, DIN, AutoInt, DLRM-RM2 — the port of
``src/repro/models/recsys.py``.

Parameters are a dict with the keys of the JAX package's pytree: stacked
(F, V, D) embedding tables as tensors, MLP towers as
`repro_torch.layers.common.MLP` modules, AutoInt's attention layers as a
list of dicts of (d_in, d_out) weights.  Every lookup into stacked tables
(`embed_fields`) goes through ``ops.embedding_bag``: on the card one
launch of the CUDA embedding-bag kernel for all fields, on the CPU its
plain version.

The two-tower model is where the paper's technique serves: `retrieval_serve`
scores the user tower's output against the item tower's (C, d) embedding DB
with progressive search (``core.progressive_search``: the stage-0 scan and
rescore kernels on the card).

Entry points
  recsys_init(cfg, seed=, device=)              -> params (random weights)
  load_jax_params(np_params, cfg, device=)      -> params (the JAX package's
                                                   ``recsys_init`` pytree)
  tower_user / tower_item, retrieval_serve      -> two-tower serving
  recsys_forward (din / autoint / dlrm)         -> (B,) logits
  serve_candidates                              -> (B, C) scores

Training: ``two_tower_loss`` (in-batch sampled softmax with the
Matryoshka losses on embedding prefixes), ``ctr_loss`` and their dispatch
``recsys_loss`` run the same forwards with gradients enabled; the tables'
gradient comes from the embedding bag's backward kernel on the card
(``ops.embedding_bag`` takes it only when gradients are asked for).  They
take the params as ``recsys_init`` / ``load_jax_params`` make them or as
``param_tree(params)``, the JAX package's pytree (MLPs as lists of ``{"w",
"b"}``) whose leaves share the weights' storage: the tree an optimizer
and a checkpoint walk.  The sharding annotations wait for the multi-device
slice; the port trains and serves on one card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.progressive import progressive_search
from repro_torch.core.schedule import ProgressiveSchedule, make_schedule
from repro_torch.kernels import ops
from repro_torch.layers.common import (MLP, dense_init, dtype_of, mlp_apply,
                                       mlp_init, mlp_tree, resolve_device,
                                       seeded_generator)

Tensor = torch.Tensor
Params = Dict[str, object]

# the pytree keys of each family, as the JAX package's recsys_init makes them
_KEYS = {
    "two_tower": {"user_tables", "item_tables", "user_mlp", "item_mlp"},
    "din": {"item_table", "attn_mlp", "mlp"},
    "autoint": {"tables", "attn", "out"},
    "dlrm": {"tables", "bot_mlp", "top_mlp"},
}


# ------------------------------------------------------------ embedding --

def embed_tables_init(generator: torch.Generator, n_fields: int, vocab: int,
                      d: int, dtype, *, device=None) -> Tensor:
    """(F, V, D) stacked per-field tables, N(0, 1) * d**-0.5, filled one
    field at a time (no full-size float32 temporary)."""
    out = torch.empty((n_fields, vocab, d), dtype=dtype, device=device)
    for f in range(n_fields):
        if dtype == torch.float32:
            out[f].normal_(0.0, d ** -0.5, generator=generator)
        else:
            out[f].copy_(torch.empty((vocab, d), device=device).normal_(
                0.0, d ** -0.5, generator=generator))
    return out


def embed_fields(tables: Tensor, ids: Tensor) -> Tensor:
    """EmbeddingBag-sum per field.  tables (F, V, D); ids (B, F, H) ->
    (B, F, D) in the tables' dtype.  Negative ids are padding; ids >= V read
    row V - 1 (the JAX package's clamped gather)."""
    out = ops.embedding_bag(tables, ids.to(torch.int32).contiguous(),
                            mode="sum")
    return out.to(tables.dtype)


# --------------------------------------------------------------- models --

@torch.no_grad()
def recsys_init(cfg: RecsysConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights from a seeded generator on ``device`` (the JAX
    package's initialisers; other numbers than its ``jax.random`` draws)."""
    device = resolve_device(device)
    gen = seeded_generator(device, seed)
    dt = dtype_of(cfg.param_dtype)
    d = cfg.embed_dim

    def tables(n):
        return embed_tables_init(gen, n, cfg.vocab_per_field, d, dt,
                                 device=device)

    def mlp(dims):
        return mlp_init(gen, dims, dt, device=device)

    if cfg.family == "two_tower":
        nf = max(cfg.n_sparse // 2, 1)
        return {"user_tables": tables(nf), "item_tables": tables(nf),
                "user_mlp": mlp((nf * d,) + cfg.tower_mlp),
                "item_mlp": mlp((nf * d,) + cfg.tower_mlp)}
    if cfg.family == "din":
        return {"item_table": tables(1)[0],
                "attn_mlp": mlp((4 * d,) + cfg.attn_mlp + (1,)),
                "mlp": mlp((3 * d,) + cfg.mlp + (1,))}
    if cfg.family == "autoint":
        width = cfg.n_attn_heads * cfg.d_attn
        layers = []
        for l in range(cfg.n_attn_layers):
            d_in = d if l == 0 else width
            layers.append({name: dense_init(gen, d_in, width, dt, device=device)
                           for name in ("wq", "wk", "wv", "w_res")})
        return {"tables": tables(cfg.n_sparse), "attn": layers,
                "out": mlp((cfg.n_sparse * width, 1))}
    if cfg.family == "dlrm":
        n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        return {"tables": tables(cfg.n_sparse),
                "bot_mlp": mlp((cfg.n_dense,) + cfg.bot_mlp),
                "top_mlp": mlp((n_pairs + cfg.bot_mlp[-1],) + cfg.top_mlp)}
    raise ValueError(cfg.family)


def load_jax_params(np_params: Dict, cfg: RecsysConfig,
                    device="cuda") -> Params:
    """The JAX package's ``recsys_init`` pytree, as numpy arrays, as the
    port's params: tables as tensors, MLP layer lists as ``MLP`` modules,
    AutoInt's attention layers as dicts of tensors, in ``cfg.param_dtype``
    (bfloat16 arrays go through float32, which holds them exactly)."""
    device = resolve_device(device)
    if set(np_params) != _KEYS[cfg.family]:
        raise ValueError(f"{cfg.family} params need keys "
                         f"{sorted(_KEYS[cfg.family])}, got {sorted(np_params)}")
    dt = dtype_of(cfg.param_dtype)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                            dtype=dt)

    def conv(v):
        if isinstance(v, (list, tuple)):
            if v and "w" in v[0]:
                return MLP.from_numpy(v, dt, device=device)
            return [{k: t(a) for k, a in layer.items()} for layer in v]
        return t(v)

    return {k: conv(v) for k, v in np_params.items()}


# ------------------------------------------------------------ two-tower --

def _normalize(v: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / n.clamp(min=1e-6)


def tower_user(params: Params, user_ids: Tensor) -> Tensor:
    """(B, F, H) user ids -> (B, d) unit user embeddings."""
    e = embed_fields(params["user_tables"], user_ids)        # (B, F, D)
    return _normalize(mlp_apply(params["user_mlp"],
                                e.reshape(e.shape[0], -1), act=F.relu))


def tower_item(params: Params, item_ids: Tensor) -> Tensor:
    """(C, F, H) item ids -> (C, d) unit item embeddings."""
    e = embed_fields(params["item_tables"], item_ids)
    return _normalize(mlp_apply(params["item_mlp"],
                                e.reshape(e.shape[0], -1), act=F.relu))


def retrieval_serve(
    params: Params, user_ids: Tensor, item_db: Tensor, cfg: RecsysConfig,
    *, sched: Optional[ProgressiveSchedule] = None, k: int = 10,
) -> Tuple[Tensor, Tensor]:
    """Progressive-search retrieval over a precomputed item-embedding DB.

    Queries are the user tower's output; the DB is the (C, d) item tower's
    output; the search runs the paper's multi-stage truncated schedule
    (``make_schedule(cfg.retrieval_d_start, d, cfg.retrieval_k0,
    final_k=k)`` unless given) instead of a full-dim scan.

    Returns ((B, k) float32 scores ascending, (B, k) int32 item indices).
    """
    q = tower_user(params, user_ids)
    if sched is None:
        sched = make_schedule(cfg.retrieval_d_start, item_db.shape[1],
                              cfg.retrieval_k0, final_k=k)
    return progressive_search(q.to(torch.float32),
                              item_db.to(torch.float32), sched)


# ------------------------------------------------------------------ DIN --

def din_forward(params: Params, batch: Dict[str, Tensor],
                cfg: RecsysConfig) -> Tensor:
    """batch: hist (B, S) int (-1 pad), target (B,) int -> logits (B,).

    The history is pooled by attention weights, a weighted gather the
    embedding-bag kernel does not take: plain indexing (ids clamped to the
    table, as the JAX package's gather clamps them)."""
    tab = params["item_table"]                              # (V, D)
    v = tab.shape[0]
    hist, target = batch["hist"], batch["target"]
    h = tab[hist.clamp(0, v - 1).long()]                    # (B, S, D)
    t = tab[target.clamp(0, v - 1).long()]                  # (B, D)
    mask = (hist >= 0).to(h.dtype)[..., None]
    tb = t[:, None].expand_as(h)
    att_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    w = mlp_apply(params["attn_mlp"], att_in, act=torch.sigmoid) * mask
    user = (w * h).sum(dim=1)                               # (B, D)
    x = torch.cat([user, t, user * t], dim=-1)
    return mlp_apply(params["mlp"], x, act=F.relu)[:, 0]


# -------------------------------------------------------------- AutoInt --

def autoint_forward(params: Params, batch: Dict[str, Tensor],
                    cfg: RecsysConfig) -> Tensor:
    """batch: ids (B, F, H) int -> logits (B,)."""
    x = embed_fields(params["tables"], batch["ids"])        # (B, F, D)
    h, da = cfg.n_attn_heads, cfg.d_attn
    for p in params["attn"]:
        b, f, _ = x.shape
        q = (x @ p["wq"]).reshape(b, f, h, da).transpose(1, 2)
        k = (x @ p["wk"]).reshape(b, f, h, da).transpose(1, 2)
        v = (x @ p["wv"]).reshape(b, f, h, da).transpose(1, 2)
        s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
             * da ** -0.5)
        a = torch.softmax(s, dim=-1)
        o = (a.to(v.dtype) @ v).transpose(1, 2).reshape(b, f, h * da)
        x = F.relu(o + x @ p["w_res"])
    return mlp_apply(params["out"], x.reshape(x.shape[0], -1))[:, 0]


# ----------------------------------------------------------------- DLRM --

def dlrm_forward(params: Params, batch: Dict[str, Tensor],
                 cfg: RecsysConfig) -> Tensor:
    """batch: dense (B, n_dense) float, ids (B, F, H) int -> logits (B,)."""
    z = mlp_apply(params["bot_mlp"], batch["dense"], act=F.relu,
                  final_act=True)                           # (B, d)
    e = embed_fields(params["tables"], batch["ids"])        # (B, F, D)
    feats = torch.cat([z[:, None, :], e], dim=1)            # (B, F+1, D)
    # pairwise dot interaction, upper triangle without the diagonal
    gram = (feats.to(torch.float32)
            @ feats.to(torch.float32).transpose(1, 2))       # (B, F+1, F+1)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    pairs = gram[:, iu, ju]
    x = torch.cat([z.to(torch.float32), pairs], dim=-1)
    return mlp_apply(params["top_mlp"], x.to(z.dtype), act=F.relu)[:, 0]


_FORWARDS = {"din": din_forward, "autoint": autoint_forward,
             "dlrm": dlrm_forward}


def recsys_forward(params: Params, batch: Dict[str, Tensor],
                   cfg: RecsysConfig) -> Tensor:
    return _FORWARDS[cfg.family](params, batch, cfg)


# -------------------------------------------------------------- training --

def param_tree(params: Params) -> Dict:
    """The JAX package's ``recsys_init`` pytree of ``params``: tables and
    AutoInt's attention weights as tensors, each MLP as a list of ``{"w",
    "b"}``; the leaves share the weights' storage (detached)."""
    def conv(v):
        if isinstance(v, MLP):
            return mlp_tree(v)
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v.detach()

    return {k: conv(v) for k, v in params.items()}


def recsys_param_logical(cfg: RecsysConfig, params) -> Dict:
    """Logical axes mirroring a `param_tree`'s structure (the JAX
    package's ``recsys_param_logical``)."""
    table_log = ("fields", "rows", None)

    def mlp_log(layers):
        return [{"w": ("embed", "mlp"), **({"b": ("mlp",)} if "b" in l else {})}
                for l in layers]

    if cfg.family == "two_tower":
        return {"user_tables": table_log, "item_tables": table_log,
                "user_mlp": mlp_log(params["user_mlp"]),
                "item_mlp": mlp_log(params["item_mlp"])}
    if cfg.family == "din":
        return {"item_table": ("rows", None),
                "attn_mlp": mlp_log(params["attn_mlp"]),
                "mlp": mlp_log(params["mlp"])}
    if cfg.family == "autoint":
        return {"tables": table_log,
                "attn": [{k: ("embed", "mlp") for k in l}
                         for l in params["attn"]],
                "out": mlp_log(params["out"])}
    if cfg.family == "dlrm":
        return {"tables": table_log,
                "bot_mlp": mlp_log(params["bot_mlp"]),
                "top_mlp": mlp_log(params["top_mlp"])}
    raise ValueError(cfg.family)


def _inbatch_softmax(u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """(mean in-batch softmax loss at temperature 1 / 20, top-1 accuracy):
    row i's positive is column i."""
    logits = (u @ v.T) * 20.0
    lf = logits.to(torch.float32)
    labels = torch.arange(u.shape[0], device=u.device)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.diagonal(lf)
    loss = torch.mean(lse - gold)
    acc = torch.mean((logits.argmax(-1) == labels).to(torch.float32))
    return loss, acc


def two_tower_loss(params: Params, batch: Dict[str, Tensor],
                   cfg: RecsysConfig):
    """In-batch sampled-softmax retrieval loss (RecSys'19), plus the
    Matryoshka losses on the embeddings' first ``cfg.matryoshka_dims``
    dims (renormalised), averaged over them, so the item index serves
    progressive search."""
    u = tower_user(params, batch["user_ids"])
    v = tower_item(params, batch["item_ids"])
    loss, acc = _inbatch_softmax(u, v)
    for d in cfg.matryoshka_dims:
        l_d, _ = _inbatch_softmax(_normalize(u[:, :d]), _normalize(v[:, :d]))
        loss = loss + l_d / max(len(cfg.matryoshka_dims), 1)
    return loss, {"loss": loss, "acc": acc}


def ctr_loss(params: Params, batch: Dict[str, Tensor], cfg: RecsysConfig):
    """Binary logistic loss of the CTR models (DIN, AutoInt, DLRM)."""
    logits = recsys_forward(params, batch, cfg).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"loss": loss, "acc": acc}


def recsys_loss(params: Params, batch: Dict[str, Tensor],
                cfg: RecsysConfig):
    """The family's training loss: (loss, {"loss", "acc"})."""
    with torch.enable_grad():
        if cfg.family == "two_tower":
            return two_tower_loss(params, batch, cfg)
        return ctr_loss(params, batch, cfg)


# --------------------------------------------------- candidate scoring --

def serve_candidates(params: Params, batch: Dict[str, Tensor],
                     cand_ids: Tensor, cfg: RecsysConfig) -> Tensor:
    """Score ``C`` candidate items for each of B user contexts (bulk
    ranking).  Two-tower: the user tower against the item tower over the
    candidates.  CTR models: the item field (field 0 / DIN's target) swept
    over the candidates with each user's context repeated, all (user,
    candidate) pairs in one batch.  Returns (B, C) scores."""
    c = cand_ids.shape[0]
    if cfg.family == "two_tower":
        nf = params["item_tables"].shape[0]
        item_ids = cand_ids.to(torch.int32)[:, None, None].expand(c, nf, 1)
        db = tower_item(params, item_ids)                    # (C, d)
        q = tower_user(params, batch["user_ids"])            # (B, d)
        return q @ db.T

    if cfg.family == "din":
        hist = batch["hist"]
        b, s = hist.shape
        pairs = {"hist": hist[:, None].expand(b, c, s).reshape(b * c, s),
                 "target": cand_ids[None].expand(b, c).reshape(b * c)}
        return din_forward(params, pairs, cfg).reshape(b, c)

    ids = batch["ids"]
    b = ids.shape[0]
    swept = ids[:, None].expand(b, c, *ids.shape[1:]).clone()
    swept[:, :, 0, 0] = cand_ids.to(ids.dtype)
    pairs = {"ids": swept.reshape(b * c, *ids.shape[1:])}
    if cfg.family == "dlrm":
        dense = batch["dense"]
        pairs["dense"] = dense[:, None].expand(b, c, dense.shape[1]).reshape(
            b * c, -1)
    return recsys_forward(params, pairs, cfg).reshape(b, c)
