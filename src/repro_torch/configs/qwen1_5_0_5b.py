"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H d_ff=2816 vocab=151936, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

DENSE = LayerSpec(mixer="attn", ffn="dense")

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    blocks=(((DENSE,), 24),),
    qkv_bias=True,
    tie_embeddings=True,
)
