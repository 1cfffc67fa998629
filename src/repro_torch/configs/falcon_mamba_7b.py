"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free mamba1, state=16.

d_inner = 2*d_model = 8192, conv width 4, dt_rank = 256, vocab 65024.
[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

MAMBA = LayerSpec(mixer="mamba", ffn="none")

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    blocks=(((MAMBA,), 64),),
    tie_embeddings=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256, chunk=128),
)
