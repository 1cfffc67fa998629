"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA + QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

DENSE = LayerSpec(mixer="attn", ffn="dense")

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    blocks=(((DENSE,), 28),),
    qkv_bias=True,
    tie_embeddings=True,
)
