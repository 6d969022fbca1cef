"""Sharding rules + activation sharding hints on DTensor.

Port of ``repro.parallel.sharding``.  Two pieces, as the reference:

1. ``hint(x, name)`` — models call this on named intermediate activations
   (residual stream, q/k/v heads, logits, ...).  Outside ``use_hints`` or
   on a plain tensor it is the identity, so every model runs unchanged on
   one device.  Inside ``use_hints(rules)`` a DTensor is redistributed to
   the named rule on its own mesh: the counterpart of
   ``with_sharding_constraint``.

2. ``param_tree_specs(params)`` — maps a parameter tree to partition specs
   by parameter-name pattern (TP over ``model``, FSDP over ``data``); the
   specs are the reference's, entry for entry.  ``placements`` turns a
   spec into DTensor placements on a ``("data", "model")`` mesh:
   ``Shard(dim)`` for each mesh dimension named in the spec,
   ``Replicate()`` for the others.  ``sanitize_spec`` drops the axes that
   do not divide a dimension, as the reference's jit shardings demand.

A ``PartitionSpec`` here is a small tuple (``P("data", None)``): entries
are an axis name, a tuple of axis names, or ``None``.

Beyond the reference (whose arrays are immutable): the in-place writers
of the decode caches take DTensors shard by shard.  ``local_view`` gives
a rank its block of an operand laid out as the DTensor it writes into
(rows of positions and masks, fresh k/v), ``gather_rows`` all-gathers a
rank's rows over the mesh dimensions that split them, and
``local_rows`` views one local row of every shard as a DTensor.

Heads that ``model`` does not divide: ``even_heads`` gathers a fused
head projection before its unflatten, and ``head_specs`` splits the
rows of an attention or scan call over ``model`` in place of the heads.
``grad_in_place`` returns a normed residual's gradient to its
placements (Megatron's ``f``).

Storage and use: a parameter is stored under its spec (FSDP over
``data`` as the reference), and a step redistributes it to its use
placements (``use_spec``: the spec without ``data``, the all-gather
that GSPMD inserts for an FSDP weight) before the forward; the backward
of that redistribution reduce-scatters the gradient back to storage.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

DATA, MODEL = "data", "model"
AXES = (DATA, MODEL)
POD = "pod"         # a multi-pod mesh's outer data axis (launch.mesh)


class P(tuple):
    """Partition spec: one entry per tensor dim (axis name, tuple of axis
    names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


_local = threading.local()


def _rules() -> Optional[Dict[str, P]]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_hints(rules: Dict[str, P]):
    prev = _rules()
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for plain
    tensors)."""
    return type(x).__name__ == "DTensor"


def _trim(spec, ndim: int) -> P:
    return P(*(list(spec) + [None] * ndim)[:ndim])


def hint(x, name: str):
    """Redistribute a DTensor to the named rule of the active hints (its
    spec trimmed to the rank and sanitized); identity otherwise."""
    rules = _rules()
    if rules is None or name not in rules or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = sanitize_spec(_trim(rules[name], x.ndim), tuple(x.shape), mesh)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Activation-sharding rule sets
# ---------------------------------------------------------------------------

def default_activation_rules(*, data_axes=(DATA,), model_axis=MODEL,
                             seq_shard: bool = True) -> Dict[str, P]:
    """Baseline schedule: batch over data axes, TP over model axis,
    sequence-parallel residual stream (S over model) when seq_shard."""
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    m = model_axis
    return {
        # [B, S, d]
        "residual": P(da, m, None) if seq_shard else P(da, None, None),
        # [B, S, H, hd] after qkv projection — heads over model
        "attn_q": P(da, None, m, None),
        "attn_kv": P(da, None, m, None),
        # [B, S, f]
        "ffn_hidden": P(da, None, m),
        # [B, S, di] mamba inner — channels over model
        "mamba_inner": P(da, None, m),
        # [B, S, H, N] rwkv heads over model
        "rwkv_heads": P(da, None, m, None),
        # [Gn, E, C, d] moe dispatch buffer — groups over data; experts
        # over model in EP mode
        "moe_buffer": P(da, None, None, None),
        "moe_buffer_ep": P(da, m, None, None),
        # expert weights at use time (EP: experts over model; TP: ffn dim)
        "moe_w_in_ep": P(m, None, None),   # [E, d, f]
        "moe_w_out_ep": P(m, None, None),  # [E, f, d]
        "moe_w_in": P(None, None, m),
        "moe_w_out": P(None, m, None),
        # [Gn, g, E, C] dispatch/combine one-hots in EP mode
        "moe_onehot_ep": P(da, None, m, None),
        # [Gn, E, C, f] expert hidden activations
        "moe_hidden": P(da, None, None, m),
        "moe_hidden_ep": P(da, m, None, None),
        # [B, S, V]
        "logits": P(da, None, m),
        # decode: [B, 1, d]
        "decode_residual": P(da, None, None),
        # [B, S_cache, KV, hd]
        "kv_cache": P(da, None, m, None),
        # long-context decode: cache sequence-sharded over data (batch=1)
        "kv_cache_seqshard": P(None, da, m, None),
    }


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# pattern -> spec builder keyed by array rank; leading stacked "repeats"
# dimension (from scan-over-blocks) is added automatically.
_PARAM_RULES = [
    # embeddings / unembedding
    (r"embed/tokens$", lambda r: P("model", "data")),
    (r"embed/lm_head$", lambda r: P("data", "model")),
    (r"embed/feature_proj$", lambda r: P(None, "model")),
    # attention
    (r"wq$|wkv$", lambda r: P("data", "model")),
    (r"wo$", lambda r: P("model", "data")),
    # dense ffn
    (r"w_gate$|w_up$|w_key$", lambda r: P("data", "model")),
    (r"w_down$|w_value$", lambda r: P("model", "data")),
    (r"w_recept$", lambda r: P("data", "model")),
    # moe experts: expert dim over data (expert parallelism), TP inside
    (r"experts/w_gate$|experts/w_up$|experts/w_key$",
     lambda r: P("data", None, "model")),
    (r"experts/w_down$|experts/w_value$", lambda r: P("data", "model", None)),
    (r"router$", lambda r: P(None, None)),
    # mamba
    (r"in_proj$", lambda r: P("data", "model")),
    (r"out_proj$", lambda r: P("model", "data")),
    (r"x_proj$", lambda r: P("model", None)),
    (r"dt_proj$", lambda r: P(None, "model")),
    (r"conv_w$", lambda r: P(None, "model")),
    (r"conv_b$|dt_bias$|D$", lambda r: P("model")),
    (r"A_log$", lambda r: P("model", None)),
    # rwkv time mix
    (r"w_r$|w_k$|w_v$|w_g$", lambda r: P("data", "model")),
    (r"w_o$", lambda r: P("model", "data")),
    (r"decay_w1$", lambda r: P("model", None)),
    (r"decay_w2$", lambda r: P(None, "model")),
]


def path_str(path: Sequence) -> str:
    """'/'-joined tree path: dict keys as themselves, sequence indices as
    ``[i]`` (``jax.tree_util``'s key strings)."""
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p)
                    for p in path)


def spec_for_param(path: str, arr, *, stacked: bool) -> P:
    """PartitionSpec for one parameter; `stacked` = leading scan-repeat dim."""
    rank = arr.ndim - (1 if stacked else 0)
    for pat, builder in _PARAM_RULES:
        if re.search(pat, path):
            spec = _trim(builder(rank), rank)
            break
    else:
        # default: replicate small params (norm scales, biases, mixes)
        spec = P(*([None] * rank))
    if stacked:
        spec = P(None, *spec)
    return spec


def map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_tree_specs(params):
    """PartitionSpec tree mirroring the param tree.  Leaves under
    'blocks/' carry a leading stacked repeat dim."""
    def fn(path, leaf):
        p = path_str(path)
        return spec_for_param(p, leaf, stacked=p.startswith("blocks/"))
    return map_with_path(fn, params)


def _mesh_sizes(mesh) -> Dict[str, int]:
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = (mesh.devices.shape if hasattr(mesh, "devices")
             else tuple(mesh.size(i) for i in range(len(names))))
    return dict(zip(names, shape))


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop axis assignments whose product does not divide the dimension
    (and axes the mesh lacks); for tuple entries keep the greedy prefix
    of axes that divides.
    ``mesh`` is a torch DeviceMesh or anything with ``axis_names`` and
    ``devices.shape``."""
    sizes = _mesh_sizes(mesh)
    out = []
    for d, entry in enumerate(list(spec)[:len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for a in axes:
            if a in sizes and shape[d] % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def even_heads(x, n_heads: int):
    """A DTensor ``x`` [..., n_heads * hd] (a fused head projection) with
    each mesh dimension that splits its last dim unevenly across the
    heads replicated (an all-gather), so that the head unflatten meets
    whole heads only; DTensor refuses an uneven one.  Plain tensors and
    splits that divide the heads pass through.  The heads then take the
    sanitized ``attn_q`` / ``attn_kv`` / ``rwkv_heads`` hint: replicated
    over ``model`` when it does not divide them."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    want, prod = [], 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            if n_heads % (prod * mesh.size(i)):
                p = Replicate()
            else:
                prod *= mesh.size(i)
        want.append(p)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, tuple(want))


def replicated_over(x, axis: str = MODEL):
    """DTensor ``x`` with mesh axis ``axis`` replicated (a partial sum
    all-reduced, a shard all-gathered), its other mesh dims as they are;
    plain tensors pass through.  For a small product that is a partial
    sum over ``model`` ahead of a nonlinearity: DTensor would otherwise
    reduce-scatter it along the flattened tokens, a strided shard it
    cannot multiply on fake tensors."""
    if not is_dtensor(x) or axis not in x.device_mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import Replicate
    i = x.device_mesh.mesh_dim_names.index(axis)
    want = tuple(Replicate() if j == i else p
                 for j, p in enumerate(x.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _GradInPlace(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    input's placements (a partial sum all-reduced or reduce-scattered)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_in_place(x):
    """``x`` unchanged, its gradient redistributed to ``x``'s placements
    (DTensor only; the identity on plain tensors).  Megatron's ``f``
    before the products that read a normed residual: the gradients of
    those products are partial sums over ``model``, and left partial
    they would reach every earlier layer's weight products, which then
    gather their activations over ``model`` (the reference's GSPMD
    reduces them there)."""
    return _GradInPlace.apply(x) if is_dtensor(x) else x


def use_spec(spec: P) -> P:
    """The spec a weight is used under: its storage spec without the FSDP
    ``data`` axis."""
    def drop(entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a is not None and a != DATA)
        return None if not kept else kept[0] if len(kept) == 1 else kept
    return P(*(drop(e) for e in spec))


# ---------------------------------------------------------------------------
# DTensor placements and trees
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> Tuple:
    """DTensor placements of ``spec`` on a ``("data", "model")`` mesh:
    ``Shard(d)`` on each mesh dimension that tensor dim ``d`` names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dim = None
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if axis in axes:
                dim = d
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def tensor_placements(spec: P, shape, mesh) -> Tuple:
    """``placements`` of ``spec`` sanitized for ``shape``."""
    return placements(sanitize_spec(_trim(spec, len(shape)), shape, mesh),
                      mesh)


def distribute(x, mesh, spec: P):
    """A full tensor present (identically) on every rank of ``mesh`` ->
    the DTensor of its local shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, tensor_placements(spec, x.shape, mesh),
                             src_data_rank=None)


def for_use(params):
    """A parameter tree with each DTensor leaf redistributed from its
    storage spec to its use spec (``use_spec``: the FSDP all-gather over
    ``data``); plain leaves unchanged.  Differentiable: the gradient of
    a used leaf reaches its storage leaf reduce-scattered.  A tuple of
    trees takes each tree's own specs."""
    if isinstance(params, tuple):
        return tuple(for_use(p) for p in params)
    from repro_torch.tree import tree_leaves
    if not any(is_dtensor(x) for x in tree_leaves(params)):
        return params
    specs = param_tree_specs(params)

    def use(path, x):
        if not is_dtensor(x):
            return x
        spec = specs
        for k in path:
            spec = spec[k]
        want = tensor_placements(use_spec(spec), tuple(x.shape),
                                 x.device_mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)
    return map_with_path(use, params)


def distribute_params(params, mesh):
    """A parameter tree committed to ``mesh`` by ``param_tree_specs``:
    each plain leaf (the same full tensor on every rank) becomes the
    DTensor of its shard, with no communication; DTensor leaves (already
    placed) come through as they are."""
    specs = param_tree_specs(params)

    def put(path, x):
        if x is None or is_dtensor(x):
            return x
        spec = specs
        for k in path:
            spec = spec[k]
        return distribute(x, mesh, spec)
    return map_with_path(put, params)


def mesh_size(mesh) -> int:
    """Devices in a torch DeviceMesh or in a placement's ``LocalMesh``."""
    if hasattr(mesh, "devices"):
        return int(mesh.devices.size)
    return int(mesh.size())


def full(x):
    """The full tensor of a DTensor (a collective over its mesh); plain
    tensors and other leaves unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# In-place writes into DTensor shards: each rank writes its own block
# ---------------------------------------------------------------------------

def row_placements(placements, row_dim: int) -> Tuple:
    """The placements of a per-row operand whose dim 0 is dim
    ``row_dim`` of a DTensor laid out by ``placements``: its rows split
    as that dim is, replicated over every other mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if isinstance(p, Shard) and p.dim == row_dim
                 else Replicate() for p in placements)


def local_block(x, mesh, placements):
    """This rank's block of ``x`` (every rank's same full tensor) under
    ``placements``: slices, no communication (``distribute``'s local
    shard, on whatever device ``x`` lies)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return x


def local_view(x, ref, row_dim: Optional[int] = None):
    """This rank's block of ``x`` as DTensor ``ref`` lays it out, for an
    in-place write into ``ref.to_local()``.  ``row_dim`` None: ``x`` has
    ``ref``'s dims (a DTensor is redistributed to ``ref``'s placements:
    nothing moves when they agree).  ``row_dim`` d: ``x`` is a per-row
    operand (positions, masks, block-table rows) whose dim 0 is
    ``ref``'s dim d.  A plain ``x`` is every rank's same full tensor and
    is sliced (no communication); None and non-tensors pass through."""
    if x is None or not torch.is_tensor(x):
        return x
    want = tuple(ref.placements) if row_dim is None \
        else row_placements(ref.placements, row_dim)
    if is_dtensor(x):
        return x.redistribute(ref.device_mesh, want).to_local()
    return local_block(x, ref.device_mesh, want)


def row_shards(ref, row_dim: int) -> int:
    """How many shards DTensor ``ref`` splits its dim ``row_dim`` into."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, p in enumerate(ref.placements):
        if isinstance(p, Shard) and p.dim == row_dim:
            n *= ref.device_mesh.size(i)
    return n


def gather_rows(local, ref, row_dim: int, dim: int):
    """``local`` (this rank's rows along ``dim``, laid out as DTensor
    ``ref`` splits its dim ``row_dim``) all-gathered over the mesh
    dimensions that split them, in mesh order: every rank then holds the
    rows of the whole mesh (its other dims stay this rank's).  The plain
    collective, which works wherever ranks share a card."""
    from torch.distributed.tensor import Shard
    mesh = ref.device_mesh
    out = local
    for i, p in enumerate(ref.placements):
        if not (isinstance(p, Shard) and p.dim == row_dim):
            continue
        n = mesh.size(i)
        x = out.movedim(dim, 0).contiguous()
        buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        tdist.all_gather_into_tensor(buf, x, group=mesh.get_group(i))
        out = buf.movedim(0, dim)
    return out


def local_rows(ref, dim: int, index: int):
    """The DTensor of local row ``index`` along ``dim`` on every rank of
    a mesh that splits ``dim``: a view of ``ref``'s local shards (writes
    land in ``ref``), whose global rows are each shard's ``index``-th."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(ref.to_local().narrow(dim, index, 1),
                              ref.device_mesh, ref.placements,
                              run_check=False)


def full_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(full, tree)


def redistribute_like(x, ref):
    """``x`` (a DTensor on ``ref``'s mesh) in ``ref``'s placements."""
    if tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


# ---------------------------------------------------------------------------
# Kernels on DTensors: each rank runs the kernel on its local shard
# ---------------------------------------------------------------------------

def _axis_if(mesh, axis: str, n: int):
    sizes = _mesh_sizes(mesh)
    return axis if axis in sizes and n % sizes[axis] == 0 else None


def local_call(fn, args: Sequence, in_specs: Sequence, out_specs: Sequence,
               in_grad: Optional[Sequence] = None, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local shards through
    ``local_map``: argument ``i`` is laid out by ``in_specs[i]`` (an arg
    with spec None passes through; a plain tensor with a spec is every
    rank's same full tensor), the outputs by ``out_specs`` (one spec, or
    a tuple of them).  Specs name mesh axes as partition specs do and
    must divide their dims (``kernel_specs`` makes sure).  In place of a
    spec, a tuple of DTensor placements (one with ``Partial()``: each
    rank holds a summand; ``in_grad``: the inputs' gradients)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = list(args)
    for i, (a, s) in enumerate(zip(args, in_specs)):
        if s is not None and torch.is_tensor(a) and not is_dtensor(a):
            args[i] = DTensor.from_local(
                a, mesh, [Replicate()] * mesh.ndim, run_check=False)
    def pl(s):
        return placements(s, mesh) if isinstance(s, P) else s
    in_pl = tuple(None if s is None else pl(s) for s in in_specs)
    single = isinstance(out_specs, P) or not isinstance(out_specs[0], tuple)
    outs = (out_specs,) if single else tuple(out_specs)
    out_pl = tuple(pl(s) for s in outs)
    grad_pl = None if in_grad is None else tuple(
        None if s is None else pl(s) for s in in_grad)
    def local(*a):
        return fn(*(x.contiguous() if torch.is_tensor(x) else x for x in a),
                  **kwargs)
    return local_map(local, out_placements=out_pl,
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def kernel_specs(mesh, batch: int, parts: int) -> Tuple:
    """(batch axes, part axis) of a kernel call on ``mesh``: the batch
    over the data axes (``data``, and ``pod`` first on a multi-pod mesh)
    and the independent parts (heads; channels) over ``model``, each
    only where it divides; ``parts`` is the gcd-style count that must
    divide (heads and kv heads alike)."""
    data = tuple(a for a in (POD, DATA) if a in _mesh_sizes(mesh))
    return (sanitize_spec(P(data), (batch,), mesh)[0],
            _axis_if(mesh, MODEL, parts))


def head_specs(mesh, batch: int, heads: int) -> Tuple:
    """``kernel_specs`` of an attention call: where ``model`` does not
    divide the heads, the rows split over it too (after the data axes,
    where it divides them), so that each rank attends its own rows with
    every head instead of every rank attending all of them."""
    b, m = kernel_specs(mesh, batch, heads)
    if m is not None or MODEL not in _mesh_sizes(mesh):
        return b, m
    axes = () if b is None else b if isinstance(b, tuple) else (b,)
    return sanitize_spec(P(axes + (MODEL,)), (batch,), mesh)[0], None


def _on(entry, axis: str) -> bool:
    """Whether spec entry ``entry`` names mesh axis ``axis``."""
    return axis in (entry if isinstance(entry, tuple) else (entry,))


def vocab_parallel_embedding(table, ids):
    """``table[ids]`` for a DTensor ``table`` [V, d]: each rank looks up
    its rows of ``ids`` (over ``data``) in its vocab shard (over
    ``model``), zero where a token lies in another shard, so the output
    is a sum over ``model`` (Megatron's vocab-parallel embedding; the
    next ``hint`` all-reduces it).  The table's gradient is a sum over
    ``data`` (each data rank saw its own rows).  ``local_map`` in place of
    DTensor's own embedding rules, whose backward some torch versions
    cannot redistribute."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    B, V = ids.shape[0], table.shape[0]
    b, m = kernel_specs(mesh, B, V)

    def lookup(ids, tab):
        if m is None:
            return tab[ids]
        lo = mesh.get_local_rank(MODEL) * tab.shape[0]
        local = ids - lo
        ok = (local >= 0) & (local < tab.shape[0])
        rows = tab[local.clamp(0, tab.shape[0] - 1)]
        return rows * ok[..., None].to(rows.dtype)
    # per mesh dim: the output is a sum over the vocab shards (``model``)
    # and split by rows over the data axes; the table's gradient is a sum
    # over the data axes
    names = mesh.mesh_dim_names
    out = tuple((Partial() if m else Replicate()) if a == MODEL
                else Shard(0) if _on(b, a) else Replicate() for a in names)
    grad = tuple((Shard(0) if m else Replicate()) if a == MODEL
                 else Partial() if _on(b, a) else Replicate()
                 for a in names)
    return local_call(lookup, (ids, table), (P(b), P(m, None)), out,
                      in_grad=(P(b), grad))


def vocab_parallel_pick(logits, labels):
    """``logits[..., labels]`` for DTensor ``logits`` [B, S, V]: each rank
    picks its rows' labels (rows over the data axes) in its vocab shard
    (over ``model``), zero where a label lies in another shard, so the
    output [B, S] is a sum over ``model``; the gradient reaches the
    logits in their own shards.  The counterpart of
    ``vocab_parallel_embedding`` for the loss: a gather over a split
    vocabulary would gather it whole, and its backward would allocate
    zeros at the global batch's shape on every device."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    B, V = logits.shape[0], logits.shape[-1]
    b, m = kernel_specs(mesh, B, V)

    def pick(x, ids):
        n = x.shape[-1]
        lo = mesh.get_local_rank(MODEL) * n if m else 0
        local = ids.long() - lo
        ok = (local >= 0) & (local < n)
        got = x.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        return got * ok.to(got.dtype)
    names = mesh.mesh_dim_names
    out = tuple((Partial() if m else Replicate()) if a == MODEL
                else Shard(0) if _on(b, a) else Replicate() for a in names)
    return local_call(pick, (logits, labels), (P(b, None, m), P(b, None)),
                      out)
