"""RL workflow computational graphs G (§2.1, §3.1).

PPO: 6 tasks over 4 models — actor generation; reward / reference / critic
inference (parallel); actor / critic training (parallel).
GRPO: 4 tasks over 3 models — no critic.

Each task carries the LLM spec it runs, its kind (GEN/INF/TRAIN) and its
dependencies; the cost model consumes these to produce per-task costs, and
the end-to-end composition (Appendix B.4) aggregates them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig


class TaskKind(str, enum.Enum):
    GEN = "gen"
    INF = "inf"
    TRAIN = "train"


@dataclasses.dataclass(frozen=True)
class LLMSpec:
    """Coarse model description used by the scheduler's cost model."""

    name: str
    n_layers: int
    h1: int                 # hidden size
    h2: int                 # intermediate (ffn) size
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    n_experts: int = 0      # 0 = dense
    top_k: int = 0
    attention_free: bool = False

    @property
    def layer_weight_count(self) -> float:
        """Weights per layer. Dense: the paper's 4*h1^2 + 3*h1*h2."""
        attn = 0.0 if self.attention_free else 4.0 * self.h1 * self.h1
        ffn = 3.0 * self.h1 * self.h2
        if self.attention_free:
            # rwkv-style: 5 square projections + channel mix
            attn = 5.0 * self.h1 * self.h1
            ffn = 2.0 * self.h1 * self.h2 + self.h1 * self.h1
        if self.n_experts:
            ffn *= self.n_experts
        return attn + ffn

    @property
    def layer_active_count(self) -> float:
        """Weights touched per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.layer_weight_count
        dense = self.layer_weight_count
        ffn_all = 3.0 * self.h1 * self.h2 * self.n_experts
        ffn_act = 3.0 * self.h1 * self.h2 * self.top_k
        return dense - ffn_all + ffn_act

    @property
    def total_weight_count(self) -> float:
        return self.layer_weight_count * self.n_layers + \
            2.0 * self.vocab * self.h1

    @classmethod
    def from_model_config(cls, cfg: ModelConfig) -> "LLMSpec":
        return cls(
            name=cfg.name, n_layers=cfg.n_layers, h1=cfg.d_model,
            h2=cfg.d_ff, vocab=cfg.vocab_size, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            attention_free=cfg.attention_free)


# The paper's evaluated models (Qwen series, §5.1)
QWEN_4B = LLMSpec("qwen-4b", 36, 2560, 9728, 151936, 32, 8, 128)
QWEN_8B = LLMSpec("qwen-8b", 36, 4096, 12288, 151936, 32, 8, 128)
QWEN_14B = LLMSpec("qwen-14b", 40, 5120, 17408, 151936, 40, 8, 128)
QWEN_1_7B = LLMSpec("qwen3-1.7b", 28, 2048, 6144, 151936, 16, 8, 128)

QWEN = {"4b": QWEN_4B, "8b": QWEN_8B, "14b": QWEN_14B, "1.7b": QWEN_1_7B}


@dataclasses.dataclass(frozen=True)
class Task:
    id: int
    name: str
    kind: TaskKind
    model: LLMSpec
    depends_on: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RLWorkflow:
    algorithm: str              # "ppo" | "grpo"
    synchronous: bool
    tasks: Tuple[Task, ...]
    seq_in: int = 1024
    seq_out: int = 1024
    global_batch: int = 384
    n_rollouts: int = 8         # responses per prompt
    micro_batch: int = 4
    eta: float = 1.0            # task-parallelism coefficient (Φ)

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def samples_per_iter(self) -> int:
        return self.global_batch * self.n_rollouts

    def task(self, tid: int) -> Task:
        return self.tasks[tid]

    def stages(self) -> List[List[int]]:
        """Topological stages: groups of tasks with no mutual deps."""
        done: set = set()
        out = []
        remaining = list(range(self.n_tasks))
        while remaining:
            stage = [t for t in remaining
                     if all(d in done for d in self.tasks[t].depends_on)]
            assert stage, "dependency cycle"
            out.append(stage)
            done.update(stage)
            remaining = [t for t in remaining if t not in stage]
        return out


def make_ppo(model: LLMSpec, *, synchronous=True, seq_in=1024, seq_out=1024,
             global_batch=384, n_rollouts=8, micro_batch=4,
             critic: Optional[LLMSpec] = None,
             reward: Optional[LLMSpec] = None) -> RLWorkflow:
    critic = critic or model
    reward = reward or model
    tasks = (
        Task(0, "actor_generation", TaskKind.GEN, model),
        Task(1, "reward_inference", TaskKind.INF, reward, (0,)),
        Task(2, "reference_inference", TaskKind.INF, model, (0,)),
        Task(3, "critic_inference", TaskKind.INF, critic, (0,)),
        Task(4, "actor_training", TaskKind.TRAIN, model, (1, 2, 3)),
        Task(5, "critic_training", TaskKind.TRAIN, critic, (1, 2, 3)),
    )
    return RLWorkflow("ppo", synchronous, tasks, seq_in, seq_out,
                      global_batch, n_rollouts, micro_batch)


def make_grpo(model: LLMSpec, *, synchronous=True, seq_in=1024, seq_out=1024,
              global_batch=384, n_rollouts=8, micro_batch=4,
              reward: Optional[LLMSpec] = None) -> RLWorkflow:
    reward = reward or model
    tasks = (
        Task(0, "actor_generation", TaskKind.GEN, model),
        Task(1, "reward_inference", TaskKind.INF, reward, (0,)),
        Task(2, "reference_inference", TaskKind.INF, model, (0,)),
        Task(3, "actor_training", TaskKind.TRAIN, model, (1, 2)),
    )
    return RLWorkflow("grpo", synchronous, tasks, seq_in, seq_out,
                      global_batch, n_rollouts, micro_batch)


def make_workflow(algorithm: str, model: LLMSpec, **kw) -> RLWorkflow:
    if algorithm == "ppo":
        return make_ppo(model, **kw)
    if algorithm == "grpo":
        return make_grpo(model, **kw)
    raise ValueError(algorithm)
