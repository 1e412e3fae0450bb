"""Architecture registry: ``get_arch(id)`` -> module with CONFIG /
SMOKE_CONFIG (and SHAPES for the recsys and GNN families).

The port's own configs: the LM of the RAG path, the recsys family and
EGNN.  The JAX package's other LMs are not ported yet.
"""

import importlib
from typing import Dict, List

from repro_torch.configs.base import (EGNNConfig, LMConfig, MLAConfig,
                                      MoEConfig, RecsysConfig, ShapeSpec)

_ARCHS: Dict[str, str] = {
    # LM family
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    # GNN
    "egnn": "repro_torch.configs.egnn",
    # RecSys
    "two-tower-retrieval": "repro_torch.configs.two_tower",
    "din": "repro_torch.configs.din",
    "autoint": "repro_torch.configs.autoint",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}

LM_ARCHS = ["mistral-nemo-12b"]
GNN_ARCHS = ["egnn"]
RECSYS_ARCHS = ["two-tower-retrieval", "din", "autoint", "dlrm-rm2"]


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_arch(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_ARCHS)}")
    return importlib.import_module(_ARCHS[arch_id])


def family_of(arch_id: str) -> str:
    if arch_id in LM_ARCHS:
        return "lm"
    if arch_id in GNN_ARCHS:
        return "gnn"
    if arch_id in RECSYS_ARCHS:
        return "recsys"
    raise KeyError(arch_id)


__all__ = ["EGNNConfig", "LMConfig", "MLAConfig", "MoEConfig", "RecsysConfig",
           "ShapeSpec", "family_of", "get_arch", "list_archs"]
