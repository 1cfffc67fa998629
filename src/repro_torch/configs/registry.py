"""Architecture registry + reduced (smoke) config factory.

The port runs all ten of the JAX package's architectures.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_NAMES = ["qwen2-1.5b", "falcon-mamba-7b", "recurrentgemma-9b",
              "granite-moe-3b-a800m", "deepseek-v2-236b", "qwen1.5-0.5b",
              "stablelm-12b", "gemma3-27b", "qwen2-vl-7b", "whisper-large-v3"]

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "stablelm-12b": "stablelm_12b",
    "gemma3-27b": "gemma3_27b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cut_depth(cfg: ModelConfig, max_repeats: int) -> ModelConfig:
    """`cfg` with every layer group's repeats capped at `max_repeats`;
    every width stays (deepseek-v2-236b at 4: 1 dense + 4 MoE layers)."""
    if max_repeats < 1:
        raise ValueError(f"max_repeats must be at least 1; got {max_repeats}")
    return dataclasses.replace(
        cfg, blocks=tuple((p, min(r, max_repeats)) for p, r in cfg.blocks))


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving family structure.

    Keeps the layer-pattern shape (every block group survives with 1 repeat)
    but layers become tiny.
    """
    blocks = tuple((pattern, 1) for pattern, _ in cfg.blocks)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    d_head = 16
    d_model = 64
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2), expert_ff=32, group_size=64,
            n_shared=min(cfg.moe.n_shared, 1),
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=8, dt_rank=8, chunk=16)
    rglru = None
    if cfg.rglru is not None:
        rglru = dataclasses.replace(cfg.rglru, lru_width=64, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        blocks=blocks,
        moe=moe,
        ssm=ssm,
        rglru=rglru,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_frames=8 if cfg.enc_dec else cfg.enc_frames,
        mla_q_lora=32 if cfg.mla_q_lora else 0,
        mla_kv_lora=32 if cfg.mla_kv_lora else 0,
        mla_rope_dim=8 if cfg.mla_kv_lora else 64,
        mla_nope_dim=16 if cfg.mla_kv_lora else 128,
        mla_v_dim=16 if cfg.mla_kv_lora else 128,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else (),
        loss_chunk=64,
        attn_q_block=32,
        attn_kv_block=32,
        compute_dtype="float32",
    )


def smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))
