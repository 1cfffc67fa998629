"""ai21-jamba2-mini [hybrid] — one card's share of AI21-Jamba2-Mini.

The published model: 32 layers at d_model=4096 in blocks of 8, layer i
attention where i % 8 == 4 and Mamba-1 otherwise, its FFN a mixture of 16
experts (top-2, expert d_ff=14336) where i % 2 == 1 and a dense SwiGLU
(d_ff=14336) otherwise; 32 query and 8 kv heads of 128 with no positional
encoding; Mamba d_inner 8192, state 16, conv 4, dt_rank 256, with RMS
norms of dt, B and C; vocab 65536, untied.  The order of the layer types
is transformers' `JambaConfig` rule (attn_layer_period 8, offset 4;
expert_layer_period 2, offset 1).  [arXiv:2403.19887;
hf:ai21labs/AI21-Jamba2-Mini]

The whole model (51.6 B parameters) does not fit one card.  This config
is stage 0 of two pipeline stages (16 layers, two whole blocks) at expert
rank 0 of two: the router keeps its 16 outputs and its top-2, and the
card holds experts 0-7 of every MoE layer and computes their part of the
result (`MoEConfig.n_held`, dropless).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

BLOCK = tuple(LayerSpec(mixer="attn" if i % 8 == 4 else "mamba",
                        ffn="moe" if i % 2 == 1 else "dense") for i in range(8))

CONFIG = ModelConfig(
    name="ai21-jamba2-mini",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    blocks=((BLOCK, 2),),
    tie_embeddings=False,
    pos_embed="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256, chunk=128, inner_norms=True),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, expert_ff=14336, dispatch="dropless",
                  renormalize=False, n_held=8, first_held=0),
)
