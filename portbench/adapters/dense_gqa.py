"""A dense GQA decoder (qwen2-1.5b) handed to the port: the configuration
file's published keys set on the port's config of `arch`, with the kernels
on (`serve.served_config`)."""
from __future__ import annotations

import dataclasses

# leading dims of one layer's weight that its product contracts (fan-in)
CONTRACTED = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w2": 1, "w3": 1}


def port_config(conf: dict):
    from repro_torch import serve
    cfg = serve.served_config(conf["arch"])
    (pattern, _), = cfg.blocks
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return dataclasses.replace(
        cfg, d_model=d, n_heads=h, n_kv_heads=conf["num_key_value_heads"],
        d_head=conf.get("head_dim", d // h), d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"], blocks=((pattern, conf["num_hidden_layers"]),),
        rope_theta=float(conf["rope_theta"]), tie_embeddings=conf["tie_word_embeddings"],
        qkv_bias=conf.get("attention_bias", True), compute_dtype=conf["torch_dtype"])


def descriptors(cfg):
    from repro_torch.models import transformer as T
    return T.build_descriptors(cfg)
