"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + fine-grained MoE.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, 2 shared + 160 routed
top-6.  Layer 0 is dense (d_ff=12288) per the published model.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

MLA_DENSE = LayerSpec(mixer="mla", ffn="dense")
MLA_MOE = LayerSpec(mixer="mla", ffn="moe")

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12288,                    # dense layer-0 hidden
    vocab=102400,
    blocks=(((MLA_DENSE,), 1), ((MLA_MOE,), 59)),
    tie_embeddings=False,
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_rope_dim=64,
    mla_nope_dim=128,
    mla_v_dim=128,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        n_shared=2,
        expert_ff=1536,
        capacity_factor=1.25,
        group_size=2048,
    ),
)
