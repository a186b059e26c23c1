"""Assigned architecture configs (exact numbers from the assignment table).

Each module exports CONFIG (full-scale) and SMOKE (reduced, CPU-runnable).
``get_config(name)`` resolves either by arch id.
"""
from .base import ModelConfig, ShapeSpec, SHAPES  # noqa: F401

from . import (seamless_m4t_large_v2, xlstm_1_3b, command_r_plus_104b,
               llama3_405b, starcoder2_7b, granite_3_2b, qwen2_vl_72b,
               olmoe_1b_7b, kimi_k2_1t_a32b, jamba_1_5_large_398b,
               volt_paper_native)

ARCHS = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "xlstm-1.3b": xlstm_1_3b,
    "command-r-plus-104b": command_r_plus_104b,
    "llama3-405b": llama3_405b,
    "starcoder2-7b": starcoder2_7b,
    "granite-3-2b": granite_3_2b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.CONFIG
