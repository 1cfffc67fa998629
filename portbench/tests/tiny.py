"""A copy of the benchmark with tiny cells added as new files and entries,
for the CPU tests: the same harness, drivers, references and readers, at
sizes a test run holds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny-dense": {
        "arch": "qwen2-1.5b", "family": "dense_gqa", "source": "test",
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 512, "hidden_act": "silu", "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
        "tie_word_embeddings": True, "attention_bias": True, "torch_dtype": "bfloat16",
        "reduced": [], "assumed": {}},
    "tiny-mamba": {
        "arch": "falcon-mamba-7b", "family": "mamba1", "source": "test",
        "hidden_size": 64, "intermediate_size": 128, "state_size": 16, "conv_kernel": 4,
        "time_step_rank": 8, "num_hidden_layers": 2, "vocab_size": 512, "rms_norm_eps": 1e-06,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "reduced": [], "assumed": {}},
}
TINY_TRAFFIC = {
    "tiny_prefill": {"kind": "prefill", "prompt_lengths": [16, 32, 64], "tokens_per_batch": 512},
    "tiny_decode": {"kind": "decode", "sessions": 8, "prompt_length": 16, "prefill_sessions": 4,
                    "warm_steps": 6, "slice_steps": 3},
}
# the limit a sound bf16 run stays under at these sizes, far below what a
# wrong token reads (a wrong token's gap is of the logits' own spread)
TINY_LIMIT = 0.02
TINY_CELLS = {
    "tiny-dense.tiny_prefill": ("tiny-dense", "tiny_prefill", {"sample_lengths": [64, 16]}),
    "tiny-mamba.tiny_prefill": ("tiny-mamba", "tiny_prefill", {"sample_lengths": [64, 16]}),
    "tiny-mamba.tiny_decode": ("tiny-mamba", "tiny_decode", {"sample_sessions": 2}),
}


def make_tree(dst: Path) -> Path:
    """dst/BENCHMARK.json and dst/portbench/, the repository's, plus the tiny
    cells as new files and new entries (no file of the copy edited but
    BENCHMARK.json's lists)."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, conf in TINY_CONFIGS.items():
        path = dst / "portbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test", "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name, mix in TINY_TRAFFIC.items():
        (dst / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (conf, mix, sample) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "test"})
        lim = dict(sample, limits={"max_logit_gap": {"limit": TINY_LIMIT}})
        (dst / "portbench" / "limits" / f"{cell}.json").write_text(json.dumps(lim))
        for m in bench["end_to_end"] + bench["per_layer"]:
            kind = TINY_TRAFFIC[mix]["kind"]
            if "workloads" in m and any(w.endswith(".long_prefill" if kind == "prefill" else
                                                  ".decode_256") for w in m["workloads"]):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
