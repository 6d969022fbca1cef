"""Per-device op counts of a step: FLOPs, bytes and collective bytes.

Counterpart of ``repro.launch.hlo_analysis``.  The reference parses the
optimized per-device HLO text of the jitted step; PyTorch runs eagerly
and lowers to no HLO, so here the step itself runs, on fake tensors
(``FakeTensorMode``: shapes, no memory), under ``OpCounter``, a
``TorchDispatchMode`` that sees every aten op and counts:

  * FLOPs       -- ``2*M*N*K`` for matmul-like ops (``torch.utils.
                   flop_counter``'s formulas: mm, bmm, addmm, convolution,
                   scaled-dot-product attention), plus FLOPs per output
                   element for the aten counterparts of the reference's
                   elementwise HLO ops (``_ELEMENTWISE``: one each for
                   add, multiply, exp, ...; a composite op counts the HLO
                   ops the JAX package's definition lowers to, e.g. silu
                   = logistic + multiply);
  * bytes       -- operand plus output bytes of every op that is not a
                   view (the reference's HBM-traffic proxy).  Every aten
                   op counts as if it were its own kernel: what XLA fuses
                   the reference charges once at the fusion's boundary,
                   so this count is an upper bound;
  * collectives -- operand bytes per kind, in the reference's five kinds
                   (a collective's start counts, its wait does not);
  * peak bytes  -- the most device memory live at once: the bytes of
                   every storage from the step's arguments and the ops'
                   outputs, each counted from its first appearance
                   until the last reference to it goes (XLA's
                   ``memory_analysis`` for an eager step; each storage
                   once, whatever views share it).

Per device: a step on DTensors runs each op on every rank's local shard
(DTensor unwraps them), and the mode counts those local ops, not the
DTensor-level ones: it defers (``NotImplemented``) on DTensor arguments,
so DTensor's own dispatch runs and its local ops come back through the
mode.  The ops DTensor's sharding propagation runs on fake global
shapes, to learn output shapes, are not the step's work and are
skipped.  On a fake process group (``launch.mesh``) the collectives move
nothing; their operands are what each device would send.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# FLOPs per output element: the reference counts one for each elementwise
# HLO op in its _ELEMENTWISE set (add, subtract, multiply, divide, maximum,
# minimum, exponential, tanh, rsqrt, sqrt, power, negate, abs, log,
# logistic, cosine, sine, expm1, log1p); a composite torch op counts the
# set's ops in the JAX package's definition of the same function
_ELEMENTWISE = {
    **dict.fromkeys(
        ("add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp",
         "tanh", "rsqrt", "sqrt", "pow", "neg", "abs", "log", "sigmoid",
         "cos", "sin", "expm1", "log1p", "reciprocal", "square",
         "relu",                          # jnp.maximum(x, 0)
         "clamp_min", "clamp_max"), 1),
    "silu": 2,                            # x * logistic(x)
    "addcmul": 2, "addcdiv": 2, "lerp": 3,
    "gelu": 9,                            # the tanh form: x**3 is 2 mults
    "softplus": 8,                        # jnp.logaddexp(x, 0)
    "_softmax": 3,                        # x - max, exp, / sum
    "_log_softmax": 3,                    # x - max, exp, - log(sum)
    "mean": 1,                            # the divide (per output element)
    # autograd's fused backward kernels, as the ops of JAX's derivative
    "sigmoid_backward": 3,                # g * y * (1 - y)
    "tanh_backward": 3,                   # g * (1 - y * y)
    "silu_backward": 6,
    "gelu_backward": 12,
    "softplus_backward": 3,
    "_softmax_backward_data": 3,          # y * (g - sum(g * y))
    "_log_softmax_backward_data": 3,      # g - exp(y) * sum(g)
}

# collectives: aten op name -> (kind, index of the operand argument)
_COLLECTIVE_OPS = {
    # functional collectives (DTensor's redistributions)
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("collective-permute", 0),
    # c10d's in-place ops (torch.distributed calls): outputs come first
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0),
}

# ops that move no bytes: metadata, views the schema does not mark as
# such, allocation without a write
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "device", "is_same_size", "wait_tensor",
         "detach", "lift_fresh", "_local_scalar_dense", "_unsafe_view",
         "_reshape_alias"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _tree_bytes(x) -> int:
    return sum(_nbytes(t) for t in tree_flatten(x)[0])


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation runs this op (on fake
    global shapes, to learn the output's metadata)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


@dataclasses.dataclass
class OpCost:
    """Per-device totals: ``flops``, ``bytes`` and ``collectives`` (operand
    bytes per kind), as ``hlo_analysis.HLOCost``; ``rows`` keeps them per
    (op, output shape) with a count, for ``op_profile``."""
    flops: float
    bytes: float
    collectives: Dict[str, float]
    rows: Dict[Tuple[str, str], List[float]] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0
    peak_op: int = 0            # ops run when the peak was first reached

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())


def local_tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` as this device holds them (a DTensor's
    local shard)."""
    return [t.to_local() if _is_dtensor(t) else t
            for t in tree_flatten(tree)[0] if torch.is_tensor(t)]


def storage_key(t) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """``with OpCounter(held) as c: step(*held)``; then ``c.cost()``.
    ``held``: the step's arguments, live from the start."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {c: 0.0 for c in _COLLECTIVES}
        # (op, output shape) -> [flops, bytes, collective bytes, count]
        self.rows = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
        self._dtensor = False
        self._live_keys = set()
        self.live = self.peak = self.peak_op = self.n_ops = 0
        for t in local_tensors(held):
            self._hold(t)

    def _hold(self, t) -> None:
        if t.device.type == "meta":         # no memory behind it
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live_keys:
            return
        n = st.nbytes()
        self._live_keys.add(key)
        self.live += n
        weakref.finalize(st, self._free, key, n)
        if self.live > self.peak:
            self.peak, self.peak_op = self.live, self.n_ops

    def _free(self, key: int, n: int) -> None:
        self._live_keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(_is_dtensor(a) for a in flat):
            self._dtensor = True
            return NotImplemented
        out = func(*args, **kwargs)
        if not (self._dtensor and _in_sharding_propagation()):
            self.n_ops += 1
            for t in tree_flatten(out)[0]:
                if torch.is_tensor(t):
                    self._hold(t)
            self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat, out) -> None:
        from torch.utils.flop_counter import flop_registry
        pk = func._overloadpacket
        name = pk.__name__
        if name in _FREE or func.is_view:
            return
        fl = coll = 0.0
        if pk in flop_registry:
            fl = float(flop_registry[pk](*args, out_val=out, **kwargs))
        else:
            base = name[:-1] if name.endswith("_") and \
                name[:-1] in _ELEMENTWISE else name
            per = _ELEMENTWISE.get(base, 0)
            if base == "clamp":
                per = sum(kwargs.get(k, a) is not None for k, a in
                          zip(("min", "max"), list(args[1:3]) + [None] * 2))
            if per:
                fl = per * float(sum(t.numel() for t in tree_flatten(out)[0]
                                     if torch.is_tensor(t)))
        by = float(sum(_nbytes(t) for t in flat) + _tree_bytes(out))
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None and func.namespace in ("_c10d_functional",
                                                   "c10d"):
            coll = float(_tree_bytes(args[kind[1]]))
            self.coll[kind[0]] += coll
        self.flops += fl
        self.bytes += by
        shape = next((tuple(t.shape) for t in tree_flatten(out)[0]
                      if torch.is_tensor(t)), ())
        row = self.rows[(name, str(list(shape)))]
        row[0] += fl
        row[1] += by
        row[2] += coll
        row[3] += 1

    def cost(self) -> OpCost:
        return OpCost(self.flops, self.bytes, dict(self.coll),
                      {k: list(v) for k, v in self.rows.items()},
                      int(self.peak), int(self.peak_op))


def analyze(fn, *args, **kwargs) -> Tuple[object, OpCost]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` that holds the
    arguments; returns (its output, the per-device ``OpCost``)."""
    with OpCounter((args, kwargs)) as c:
        out = fn(*args, **kwargs)
    return out, c.cost()
