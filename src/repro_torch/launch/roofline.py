"""Roofline terms of a dry-run cell on H100 ranks: the port's counterpart
of ``src/repro/launch/hlo_analysis.py``, whose constants are a TPU v5e's.

There is no HLO to parse: the dry run (`repro_torch.launch.dryrun`) counts
FLOPs with ``torch.utils.flop_counter.FlopCounterMode``, the bytes every
operator reads and writes, and each collective where the port calls it
(its kind, its bytes and the ranks of its group).  This module turns those
counts into seconds on one rank.

Constants (NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit):

  PEAK_FLOPS  989e12 FLOP/s   bf16 tensor cores
  HBM_BW      3.35e12 B/s     HBM3
  HBM_BYTES   80e9 B          device memory a rank
  NVLINK_BW   450e9 B/s       NVLink 4, each way, among the 8 GPUs of a
                              node (900 GB/s both ways)
  NET_BW      50e9 B/s        one 400 Gb/s NDR InfiniBand port a GPU,
                              between nodes
  NODE_SIZE   8               GPUs a node (an HGX H100 board)

A collective whose group lies within one node moves its bytes at
``NVLINK_BW``, any other at ``NET_BW`` (the slowest link it crosses: a
conservative denominator, as the JAX package's one-link ICI figure is).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9
NET_BW = 50e9
NODE_SIZE = 8

COLLECTIVES = ("all-gather", "all-reduce", "all-to-all")


def link_bandwidth(ranks: Sequence[int]) -> float:
    """Bytes a second of a collective over ``ranks``: NVLink when they
    share a node, the network otherwise."""
    nodes = {r // NODE_SIZE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NET_BW


def collective_seconds(records: Iterable[Tuple[str, int, Sequence[int]]]
                       ) -> float:
    """Seconds of (kind, bytes, group ranks) collective records, each at
    its group's link rate."""
    return sum(b / link_bandwidth(ranks) for _, b, ranks in records)


def roofline(flops: float, hbm_bytes: float, coll_s: float,
             n_ranks: int) -> Dict[str, object]:
    """Per-rank roofline terms in seconds and the dominant one."""
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant, "n_ranks": n_ranks}
