"""Static stage schedule for Progressive Retrieval.

The paper (§III.D) parameterizes progressive search by

  * ``initial K``      — neighbours retrieved per query in the first stage,
  * ``starting dim``   — truncated dimensionality of the first (full-DB) scan,
  * ``max dim``        — dimensionality of the final 1-NN pass.

The loop doubles the dimension each stage and halves K (minimum 1) while the
doubled dimension is still below the max dimension; the final stage runs at
the max dimension on the surviving candidates.

Everything about the schedule is *static* (a function of the three parameters
only), which is what keeps every stage's shapes fixed: each (schedule, DB
shape) pair launches the same kernels at the same sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of progressive search.

    Attributes:
      dim:        number of leading embedding dimensions scored this stage.
      k:          number of candidates kept per query after this stage.
      pool:       number of candidate rows scored this stage (the *input*
                  candidate count; ``-1`` means the whole database).
    """

    dim: int
    k: int
    pool: int


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    """Fully static description of a progressive search run."""

    stages: Tuple[Stage, ...]
    d_start: int
    d_max: int
    k0: int
    final_k: int

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def describe(self) -> str:
        parts = [
            f"stage{i}[dim={s.dim:>5} pool={'N' if s.pool < 0 else s.pool:>6} -> k={s.k}]"
            for i, s in enumerate(self.stages)
        ]
        return " ; ".join(parts)


def make_schedule(
    d_start: int,
    d_max: int,
    k0: int,
    *,
    final_k: int = 1,
    k_min: int = 1,
) -> ProgressiveSchedule:
    """Build the paper's schedule: dim doubles, K halves (min ``k_min``).

    Stage 0 scans the full database at ``d_start`` dims keeping ``k0``
    candidates per query.  While ``2*dim < d_max`` the dim doubles and K
    halves; the last stage runs at exactly ``d_max`` keeping ``final_k``.

    Args:
      d_start: starting (lowest) dimensionality; must be >= 1.
      d_max:   target dimensionality (the embedding model's output size, or
               any truncation of it); must be >= d_start.
      k0:      initial K for the full-DB scan.
      final_k: neighbours returned by the final stage (paper uses 1).
      k_min:   lower bound on intermediate K (paper uses 1).

    Returns:
      A ProgressiveSchedule whose stages have strictly increasing dims.
    """
    if d_start < 1:
        raise ValueError(f"d_start must be >= 1, got {d_start}")
    if d_max < d_start:
        raise ValueError(f"d_max ({d_max}) must be >= d_start ({d_start})")
    if k0 < max(final_k, 1):
        raise ValueError(f"k0 ({k0}) must be >= final_k ({final_k})")

    stages = [Stage(dim=d_start, k=k0, pool=-1)]
    dim, k = d_start, k0
    if d_max > d_start:
        while dim * 2 < d_max:
            dim *= 2
            # never halve below the final stage's k (keeps ks non-increasing
            # when final_k > 1, e.g. recall@10 serving)
            k = max(k // 2, k_min, final_k)
            stages.append(Stage(dim=dim, k=k, pool=stages[-1].k))
        stages.append(Stage(dim=d_max, k=min(final_k, stages[-1].k),
                            pool=stages[-1].k))
    return ProgressiveSchedule(
        stages=tuple(stages), d_start=d_start, d_max=d_max, k0=k0, final_k=final_k
    )


def validate_schedule(sched: ProgressiveSchedule, n_db: int, d_emb: int) -> None:
    """Raise if a schedule is inconsistent with a database of shape (n_db, d_emb)."""
    if sched.d_max > d_emb:
        raise ValueError(
            f"schedule d_max={sched.d_max} exceeds database dim {d_emb}"
        )
    if sched.k0 > n_db:
        raise ValueError(f"schedule k0={sched.k0} exceeds database size {n_db}")
    dims = [s.dim for s in sched.stages]
    if dims != sorted(dims) or len(set(dims)) != len(dims):
        raise ValueError(f"stage dims must be strictly increasing, got {dims}")
    ks = [s.k for s in sched.stages]
    for a, b in zip(ks, ks[1:]):
        if b > a:
            raise ValueError(f"stage K must be non-increasing, got {ks}")
