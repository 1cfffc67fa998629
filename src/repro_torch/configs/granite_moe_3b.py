"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

MOE = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    blocks=(((MOE,), 32),),
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=40,
        top_k=8,
        n_shared=0,
        expert_ff=512,
        capacity_factor=1.25,
        group_size=2048,
    ),
)
