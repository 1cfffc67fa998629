"""A Mamba-1 language model (falcon-mamba-7b) handed to the port: the
configuration file's published keys set on the port's config of `arch`,
with the kernels on (`serve.served_config`)."""
from __future__ import annotations

import dataclasses

# leading dims of one layer's weight that its product contracts (fan-in)
CONTRACTED = {"in_proj": 1, "conv_w": 1, "x_proj": 1, "dt_proj": 1, "out_proj": 1}


def port_config(conf: dict):
    from repro_torch import serve
    cfg = serve.served_config(conf["arch"])
    (pattern, _), = cfg.blocks
    d = conf["hidden_size"]
    if conf["intermediate_size"] % d:
        raise ValueError("the port's Mamba takes d_inner as a multiple of hidden_size")
    ssm = dataclasses.replace(cfg.ssm, d_state=conf["state_size"], d_conv=conf["conv_kernel"],
                              expand=conf["intermediate_size"] // d,
                              dt_rank=conf["time_step_rank"])
    return dataclasses.replace(
        cfg, d_model=d, vocab=conf["vocab_size"], ssm=ssm,
        blocks=((pattern, conf["num_hidden_layers"]),),
        tie_embeddings=conf["tie_word_embeddings"], compute_dtype=conf["torch_dtype"])


def descriptors(cfg):
    from repro_torch.models import transformer as T
    return T.build_descriptors(cfg)
