"""Architecture registry: ``get_arch(id)`` -> module with CONFIG /
SMOKE_CONFIG / SHAPES.

The port's own copy of the JAX package's registry: the five LM families,
EGNN and the recsys family, under the same ids and in the same order.
"""

import importlib
from typing import Dict, List

from repro_torch.configs.base import (EGNNConfig, LMConfig, MLAConfig,
                                      MoEConfig, RecsysConfig, ShapeSpec)

_ARCHS: Dict[str, str] = {
    # LM family
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    # GNN
    "egnn": "repro_torch.configs.egnn",
    # RecSys
    "two-tower-retrieval": "repro_torch.configs.two_tower",
    "din": "repro_torch.configs.din",
    "autoint": "repro_torch.configs.autoint",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}

LM_ARCHS = ["starcoder2-3b", "gemma3-4b", "mistral-nemo-12b",
            "deepseek-v2-236b", "qwen3-moe-235b-a22b"]
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
