"""whisper-large-v3 [audio] — enc-dec, 32+32L d_model=1280 20H d_ff=5120 vocab=51866.

Conv frontend is a STUB: `input_specs()` provides precomputed frame embeddings
(batch, 1500, d_model).  Sinusoidal positions, LayerNorm, ungated GELU FFN.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

DEC = LayerSpec(mixer="attn", ffn="dense", cross_attn=True)

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    blocks=(((DEC,), 32),),
    norm="layernorm",
    act="gelu",
    gated_ffn=False,
    qkv_bias=True,
    pos_embed="sinusoidal",
    tie_embeddings=True,
    enc_dec=True,
    n_enc_layers=32,
    enc_frames=1500,
)
