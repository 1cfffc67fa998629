"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window=2048.
[arXiv:2402.19427; unverified]
38 = 12 x (rglru, rglru, local-attn) + 2 rglru remainder.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, RGLRUConfig

RGLRU = LayerSpec(mixer="rglru")
LOCAL = LayerSpec(mixer="attn", window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    blocks=(((RGLRU, RGLRU, LOCAL), 12), ((RGLRU,), 2)),
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4, c=8.0, chunk=256),
)
