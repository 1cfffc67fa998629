"""The tiny tree of `tiny.py` with a tiny Jamba configuration and a tiny
`decode_kv` mix added, as new files and entries, for the CPU tests of the
`decode_kv` driver and the Jamba family: two whole blocks of the layer
pattern, 4 of 8 experts held, every kind of layer present."""
from __future__ import annotations

import json
from pathlib import Path

import tiny

TINY_JAMBA = {
    "arch": "ai21-jamba2-mini", "family": "jamba", "source": "test",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 16,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_experts": 4,
    "first_held_expert": 0, "num_experts_per_tok": 2, "mamba_expand": 2,
    "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_dt_rank": 8,
    "attn_layer_period": 8, "attn_layer_offset": 4, "expert_layer_period": 2,
    "expert_layer_offset": 1, "vocab_size": 512, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "reduced": ["num_experts", "num_hidden_layers"],
    "published": {"num_experts": 8, "num_hidden_layers": 32}, "assumed": {},
    "init": {"A_log": {"rule": "log_arange"},
             "dt_bias": {"rule": "inv_softplus_log_uniform", "min": 0.001, "max": 0.1,
                         "floor": 0.0001}},
}
# 12 positions of room: the warm-up's 2, the slice's 3 and at most 7 window steps
TINY_KV = {"kind": "decode_kv", "sessions": 8, "prompt_length": 16, "prefill_sessions": 4,
           "grow": 12, "warm_steps": 2, "slice_steps": 3}
KV_CELLS = {"tiny-dense.tiny_decode_kv": "tiny-dense",
            "tiny-jamba.tiny_decode_kv": "tiny-jamba"}
# the limit a sound bf16 run stays under at these sizes, below what the
# float8 control reads (8 seeds each): tiny-dense serves the reference's
# argmax (0.0) and the control reads 0.0168 or more; in tiny-jamba bf16
# rounding can flip a near-tied expert of the top-2 (0.0446 at most) and
# the control reads 0.1515 or more.  A run's window ends when the room is
# used (`SECONDS` is never reached), so the tokens served, and the
# readings, are the same on any host.
KV_LIMITS = {"tiny-dense.tiny_decode_kv": 0.01, "tiny-jamba.tiny_decode_kv": 0.065}
SECONDS = 60.0


def make_tree(dst: Path) -> Path:
    """`tiny.make_tree(dst)` plus the tiny Jamba configuration, the
    `tiny_decode_kv` mix and its two cells, each cell appended to every
    metric that lists `ai21-jamba2-mini.decode_kv`."""
    tiny.make_tree(dst)
    pkg = dst / "portbench"
    (pkg / "configs" / "tiny-jamba.json").write_text(json.dumps(TINY_JAMBA))
    (pkg / "traffic" / "tiny_decode_kv.json").write_text(json.dumps(TINY_KV))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-jamba", "source": "test",
                             "file": "portbench/configs/tiny-jamba.json",
                             "reduced": TINY_JAMBA["reduced"], "why": "test"})
    for cell, conf in KV_CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": "tiny_decode_kv",
                                   "chips": 1, "why": "test"})
        (pkg / "limits" / f"{cell}.json").write_text(json.dumps(
            {"sample_sessions": 2, "limits": {"max_logit_gap": {"limit": KV_LIMITS[cell]}}}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "ai21-jamba2-mini.decode_kv" in m.get("workloads", []):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
