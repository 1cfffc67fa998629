"""AI21-Jamba2-Mini (one card's share) handed to the port: the configuration
file's published keys set on the port's config of `arch`, with the kernels
on (`serve.served_config`), and the port's MoE counters read for the
benchmark's readers."""
from __future__ import annotations

import dataclasses
import math

# leading dims of one layer's weight that its product contracts (fan-in);
# the expert stacks (E, d, eff) and (E, eff, d) share their names with the
# dense FFN's and take their scale from `descriptors`
CONTRACTED = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w2": 1, "w3": 1,
              "in_proj": 1, "conv_w": 1, "x_proj": 1, "dt_proj": 1, "out_proj": 1}
EXPERT_LEAVES = ("w1", "w2", "w3")


def port_config(conf: dict):
    from repro_torch import serve
    cfg = serve.served_config(conf["arch"])
    (pattern, _), = cfg.blocks
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    ssm = dataclasses.replace(cfg.ssm, d_state=conf["mamba_d_state"],
                              d_conv=conf["mamba_d_conv"], expand=conf["mamba_expand"],
                              dt_rank=conf["mamba_dt_rank"], inner_norms=True)
    moe = dataclasses.replace(cfg.moe, n_experts=conf["published"]["num_experts"],
                              n_held=conf["num_experts"],
                              first_held=conf.get("first_held_expert", 0),
                              top_k=conf["num_experts_per_tok"],
                              expert_ff=conf["intermediate_size"], n_shared=0)
    return dataclasses.replace(
        cfg, d_model=d, n_heads=h, n_kv_heads=conf["num_key_value_heads"], d_head=d // h,
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"], ssm=ssm, moe=moe,
        blocks=((pattern, conf["num_hidden_layers"] // len(pattern)),),
        tie_embeddings=conf["tie_word_embeddings"], qkv_bias=False, pos_embed="none",
        compute_dtype=conf["torch_dtype"])


def descriptors(cfg):
    """The port's tree, the expert stacks drawn at 1/sqrt(fan-in) of one
    expert's product: d for w1 and w3, eff for w2."""
    from repro_torch.models import transformer as T
    tree = T.build_descriptors(cfg)
    d, eff = cfg.d_model, cfg.moe.expert_ff
    for group in tree["blocks"]:
        for lay in group.values():
            if "moe" in lay:
                moe = lay["moe"]
                for name in EXPERT_LEAVES:
                    fan_in = eff if name == "w2" else d
                    moe[name] = dataclasses.replace(moe[name], scale=1.0 / math.sqrt(fan_in))
    return tree


def reset_counters():
    """Clear the port's MoE counters (nothing where the port has none)."""
    from repro_torch.models import moe
    getattr(moe, "reset_counters", lambda: None)()


def counters():
    """The port's MoE counters since `reset_counters`, one dict a layer
    (`repro_torch.models.moe.counters`), or None where the port has none."""
    from repro_torch.models import moe
    read = getattr(moe, "counters", None)
    return None if read is None else read()
