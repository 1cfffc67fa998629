"""Model configuration: the same dataclasses as the JAX package's configs.

`ModelConfig` keeps every field of the reference so that a configuration
reads the same in both packages.  The layer stack is described by `blocks`:
a tuple of (pattern, repeats) where pattern is a tuple of `LayerSpec`s.  Each
group's parameters are stacked along a leading `repeats` dimension, and the
port runs a group as a Python loop over that dimension.
"""
from __future__ import annotations

import dataclasses


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's static structure."""
    mixer: str = "attn"        # attn | mla | mamba | rglru
    window: int = 0            # 0 = global attention; >0 = local window
    ffn: str = "dense"         # dense | moe | none
    cross_attn: bool = False   # decoder cross-attention (enc-dec)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0
    expert_ff: int = 0          # per-expert hidden dim
    capacity_factor: float = 1.25
    group_size: int = 2048      # tokens per dispatch group
    aux_loss_weight: float = 0.01
    dispatch: str = "scatter"   # scatter | index | dropless
    # the port's own options (the JAX package has none of them); their
    # defaults keep its arithmetic
    renormalize: bool = True    # top-k gates divided by their sum
    n_held: int = 0             # experts held here, 0 -> all n_experts
    first_held: int = 0         # the router's index of the first held expert

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model/16)
    chunk: int = 128            # time-chunk for the scan
    # RMS norms of dt, B and C with learned scales (Jamba); the port's own
    # option, off as in the JAX package
    inner_norms: bool = False


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0          # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | hybrid | ssm | vlm | audio
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab: int = 32000
    blocks: tuple[tuple[tuple[LayerSpec, ...], int], ...] = ()
    # norms / misc
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu | gelu (ffn uses gated GLU unless gated=False)
    gated_ffn: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False   # gemma-style sqrt(d) embedding scaling
    rope_theta: float = 10000.0
    pos_embed: str = "rope"     # rope | sinusoidal (whisper) | none
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w) head_dim split
    # MLA (deepseek)
    mla_q_lora: int = 0
    mla_kv_lora: int = 0
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "nothing_saveable"   # nothing_saveable | dots_with_no_batch_dims | none
    loss_chunk: int = 512       # sequence chunk for cross-entropy
    attn_q_block: int = 512     # blocked-attention q tile
    attn_kv_block: int = 1024   # blocked-attention kv tile
    use_pallas: bool = False    # route prefill attention through the kernel
    logits_dtype: str = "float32"
    bf16_param_stack: bool = False
    cotangent_dtype: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.blocks)

    def layer_specs(self) -> list[LayerSpec]:
        out: list[LayerSpec] = []
        for pattern, r in self.blocks:
            out.extend(list(pattern) * r)
        return out

    def param_count(self) -> int:
        """Parameter count from the descriptor tree."""
        from repro_torch.models.params import count_params
        from repro_torch.models.transformer import build_descriptors
        return count_params(build_descriptors(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        d = self.d_model
        per_expert = 3 * d * m.expert_ff if self.gated_ffn else 2 * d * m.expert_ff
        n_moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        inactive = n_moe_layers * max(0, m.held - m.top_k) * per_expert
        return total - inactive


# the options of the port's own, which the JAX package's configs lack
PORT_OPTIONS = {"moe": ("renormalize", "n_held", "first_held"), "ssm": ("inner_norms",)}
_DEFAULTS = {"moe": MoEConfig(), "ssm": SSMConfig()}


def reference_dict(cfg: ModelConfig) -> dict:
    """`dataclasses.asdict(cfg)` less each option of `PORT_OPTIONS` that
    holds its default: the JAX package's config of the same arch reads the
    same where the port keeps that package's arithmetic."""
    out = dataclasses.asdict(cfg)
    for sub, names in PORT_OPTIONS.items():
        if out[sub] is not None:
            for name in names:
                if out[sub][name] == getattr(_DEFAULTS[sub], name):
                    del out[sub][name]
    return out


# ---------------------------------------------------------------------------
# Shape cells of the dry run (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic-capable; see DESIGN.md §4)
LONG_CONTEXT_ARCHS = {"recurrentgemma-9b", "falcon-mamba-7b", "gemma3-27b"}


def runnable_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import registry
    cells = []
    for arch in registry.ARCH_NAMES:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            cells.append((arch, shape))
    return cells
