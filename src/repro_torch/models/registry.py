"""Model registry: config -> LM instance.

Port of ``repro.models.registry``; the input specs and sharding rules
wait for the launch and dry-run slice (ROADMAP A10).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from .transformer import LM

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def get_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
