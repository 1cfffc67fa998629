"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (3-section rotary: temporal/height/width), dynamic-resolution vision
frontend is a STUB — `input_specs()` supplies the token stream (precomputed
patch embeddings are merged upstream).  [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

DENSE = LayerSpec(mixer="attn", ffn="dense")

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    blocks=(((DENSE,), 28),),
    qkv_bias=True,
    tie_embeddings=False,
    mrope_sections=(16, 24, 24),   # half-dims per section; sums to head_dim/2
    rope_theta=1_000_000.0,
)
