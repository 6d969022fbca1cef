"""Weight resharding / synchronization between training and generation
replicas (the C_reshard / C_sync terms of the cost model).

Port of ``repro.rl.sync``.  Without a target the handoff is zero-copy:
the generation params *are* the trained params (the optimizer is
functional, so the next step makes new tensors and never writes the
replica in place).  With a target placement (``ParamShardings``) the
weights move as the reference's ``device_put`` moves them, over
torch.distributed (``transfer``): onto the same ranks they are
redistributed in place of the copy; onto another rank set the source
group assembles each leaf, its lead rank broadcasts it, and the target
ranks distribute it onto their mesh.  Transfer volume is returned so the
caller can account the synchronization cost.  ``gather`` assembles a tree
whole on one rank (a checkpoint's writer), and ``OnRank`` names a tree
held whole on one rank as a source of ``transfer`` (a checkpoint read
there)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.parallel import dist
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_leaves, tree_unflatten


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def meta_tree(tree):
    """Shapes and dtypes of a tree as meta tensors (what a rank that
    holds none of the tree allocates a received leaf from)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


def transfer(tree, source, target, *, template, group=None):
    """``tree`` laid out on placement ``source`` -> the same values on
    ``target``'s shardings (a ``ParamShardings``).

    Every rank of the world calls it; ``tree`` is the source ranks' state
    (None elsewhere), ``template`` the tree's meta tensors, ``group`` a
    process group holding the source's lead rank and every target rank
    (the world when None).  Returns the target ranks' tree (DTensors when
    the target is sharded) and None on the other ranks.  Leaf by leaf, so
    at most one full leaf is held beside the trees."""
    dst = target.placement
    members = set(range(dist.world_size())) if group is None \
        else set(torch.distributed.get_process_group_ranks(group))
    same = set(source.ranks) == set(dst.ranks)
    src_leaves = tree_leaves(tree) if source.here else None
    metas = tree_leaves(template)
    specs = [None] * len(metas) if target.specs is None \
        else _spec_leaves(target.specs)
    out = []
    for i, (meta, spec) in enumerate(zip(metas, specs)):
        if same and dst.sharded and source.mesh is dst.mesh:
            # one mesh: a redistribution, no full leaf anywhere (and
            # nothing to do on a rank outside it)
            if dst.here:
                x = src_leaves[i]
                out.append(x.redistribute(dst.mesh, sh.tensor_placements(
                    spec, tuple(x.shape), dst.mesh)))
            continue
        full = sh.full(src_leaves[i]) if source.here else None
        if not same and dist.rank() in members:
            full = dist.broadcast_tensor(full, source.lead, meta.shape,
                                         meta.dtype, _device(dst), group)
        if dst.here:
            out.append(sh.distribute(full, dst.mesh, spec) if dst.sharded
                       else full)
    return tree_unflatten(template, out) if dst.here else None


@dataclasses.dataclass(frozen=True)
class OnRank:
    """A tree held whole on one rank (a checkpoint read there): the
    source placement ``transfer`` takes it from."""
    rank: int
    sharded = False
    mesh = None

    @property
    def ranks(self) -> Tuple[int, ...]:
        return (self.rank,)

    @property
    def lead(self) -> int:
        return self.rank

    @property
    def here(self) -> bool:
        return dist.rank() == self.rank


def gather(tree, source, dst: int, *, template):
    """``tree`` laid out on placement ``source`` -> the same values whole,
    as host tensors, on rank ``dst``: a checkpoint's writer.

    Every rank calls it; ``tree`` is the source ranks' state (None
    elsewhere), ``template`` the tree's meta tensors.  The source ranks
    assemble each leaf (``sh.full``: a collective over the source mesh)
    and the source's lead sends it to ``dst``.  Returns the tree on
    ``dst`` and None on the other ranks.  Leaf by leaf, so at most one
    full leaf is held beside the trees (and ``dst``'s growing copy)."""
    me = dist.rank()
    src_leaves = tree_leaves(tree) if source.here else None
    out = []
    for i, meta in enumerate(tree_leaves(template)):
        full = None
        if source.here:
            full = sh.full(src_leaves[i])
            if me == source.lead:
                full = full.detach().cpu()
        if source.lead != dst:
            if me == source.lead:
                torch.distributed.send(full.contiguous(), dst)
            elif me == dst:
                full = torch.empty(tuple(meta.shape), dtype=meta.dtype)
                torch.distributed.recv(full, source.lead)
        if me == dst:
            out.append(full)
    return tree_unflatten(template, out) if me == dst else None


def _device(placement) -> torch.device:
    me = dist.rank()
    for d in placement.local_devices:
        if isinstance(d, dist.RankDevice) and d.rank == me:
            return d.device
    first = placement.local_devices[0]
    return first.device if isinstance(first, dist.RankDevice) else first


def _spec_leaves(specs):
    from repro_torch.engine.placement import spec_leaves
    return spec_leaves(specs)


def sync_weights(train_params, target_shardings=None, *, source=None,
                 template=None, group=None) -> Tuple[object, int]:
    """Returns (generation_params, bytes_transferred).

    ``target_shardings`` (a ``ParamShardings``) names the generation
    placement; ``source`` is the training placement, ``template`` the
    actor's meta tree (needed on ranks that hold no actor) and ``group``
    the process group of ``transfer``.  Identity when there is no
    target, or when source and target are the same single rank."""
    nbytes = tree_bytes(template if template is not None else train_params)
    if target_shardings is None:
        return train_params, nbytes   # same device: zero-copy handoff
    dst = target_shardings.placement
    if source is not None and not dst.sharded and not source.sharded \
            and source.ranks == dst.ranks:
        return train_params, nbytes
    if source is None:
        raise ValueError("a sync onto a placement needs its source "
                         "placement")
    gen = transfer(train_params, source, target_shardings,
                   template=template if template is not None
                   else meta_tree(train_params), group=group)
    return gen, nbytes
