"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.

5 local : 1 global attention pattern, window 1024, qk-norm, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
62 = 10 x (5 local + 1 global) + 2 local remainder.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

LOCAL = LayerSpec(mixer="attn", window=1024)
GLOBAL = LayerSpec(mixer="attn", window=0)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262144,
    blocks=(((LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL), 10), ((LOCAL, LOCAL), 1)),
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
)
