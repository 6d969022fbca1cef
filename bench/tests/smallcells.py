"""The benchmark's files copied into a temporary root with the
configurations and mixes cut to sizes that a CPU test holds: the same
files, the same code paths, smaller numbers."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_CONFIGS = {
    # the published width keeps the tied head's logits at their spread
    "qwen3-0.6b": {"hidden_size": 1024, "intermediate_size": 256,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 32,
                   "vocab_size": 256},
    "rwkv6-3b": {"hidden_size": 128, "attention_hidden_size": 128,
                 "head_size": 32, "intermediate_size": 256,
                 "num_hidden_layers": 2, "vocab_size": 256},
}
# float32, and limits for that: a sound run reads rounding (under 1e-5,
# but the advantages of small groups of short responses, which magnify
# it: 4.4e-4 on the card), every planted fault reads 1e-2 or more
SMALL_DTYPES = {"dtype": {"rl_grpo": "float32", "genserve": "float32"}}
SMALL_LIMITS = {
    "qwen3-0.6b.rl_grpo": {"gen_logprob_gap": 1e-4, "inf_logprob_gap": 1e-4,
                           "advantage_gap": 1e-2, "loss_gap": 1e-4,
                           "grad1_leaf_gap": 1e-4, "change_leaf_gap": 1e-4},
    "rwkv6-3b.gen_prefill": {"max_logit_gap": 1e-3, "max_logprob_gap": 1e-3,
                             "short_requests": 0},
    "qwen3-0.6b.gen_decode": {"max_logit_gap": 1e-3, "max_logprob_gap": 1e-3,
                              "short_requests": 0},
}
SMALL_MIXES = {
    "rl_grpo": {"prompts": 2, "rollouts": 4, "prompt_len": 8,
                "max_new_tokens": 16},
    "gen_prefill": {"requests": 6, "wave": 4, "pad_to": 16,
                    "prompt_len": {"dist": "uniform", "lo": 8, "hi": 16},
                    "gen_len": {"dist": "uniform", "lo": 2, "hi": 8},
                    "check_requests": 6},
    "gen_decode": {"requests": 6, "wave": 4, "pad_to": 16,
                   "prompt_len": {"dist": "uniform", "lo": 8, "hi": 16},
                   "gen_len": {"dist": "loguniform", "lo": 2, "hi": 12},
                   "check_requests": 6},
}


def _update(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


def make_root(tmp: Path) -> Path:
    """A checkout root holding ``BENCHMARK.json`` and ``bench/`` at the
    small sizes."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, changes in SMALL_CONFIGS.items():
        _update(tmp / "bench" / "configs" / f"{name}.json",
                dict(changes, **SMALL_DTYPES))
    for name, limits in SMALL_LIMITS.items():
        _update(tmp / "bench" / "limits" / f"{name}.json", {"limits": limits})
    for name, changes in SMALL_MIXES.items():
        _update(tmp / "bench" / "traffic" / f"{name}.json", changes)
    return tmp
