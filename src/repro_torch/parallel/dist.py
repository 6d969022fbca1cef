"""The process world of sharded execution: one process per device (SPMD).

XLA runs a multi-device program from one controller; PyTorch runs one
process per device, as ``torchrun`` starts them.  Every rank runs the
same launcher and engine; a task's state lives on the ranks of its
placement (``engine.placement``) as DTensors, and what another group
needs crosses over through the exchange helpers here: a host tree
broadcast from a group's lead rank, and all-gathered per-rank records.

- ``init_world`` joins the world ``torchrun`` describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
  Without them the world is one rank and nothing here communicates.
- ``spawn(fn, world, device)`` starts ``world`` ranks in fresh
  interpreters that meet through a ``FileStore`` in a temporary
  directory (no port, so concurrent runs never collide); it returns
  every rank's result.
- ``rank_devices(device)`` gives one ``RankDevice`` per rank: the
  handles ``engine.placement`` folds plans onto.

The backend: gloo on the CPU.  On CUDA, NCCL when every rank has a card
of its own; when ranks share a card (more ranks than cards: NCCL refuses
two ranks on one GPU) gloo carries the CUDA tensors too
(``"cpu:gloo,cuda:gloo"``).  There, the functional all-gather that
DTensor's redistributions call (``_functional_collectives.
all_gather_tensor``: the op, then ``wait_tensor``) kills the process
with a segmentation fault in torch 2.11 on the H100 while the plain
``all_gather_into_tensor`` works (ROADMAP.md §3), so
``use_sync_all_gather`` puts a synchronous all-gather over the plain
collective in its place for such a world.  The numbers are the same:
both gather the shards in rank order.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank of the world and its torch device."""
    rank: int
    device: torch.device

    @property
    def id(self) -> int:
        return self.rank


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def multi() -> bool:
    """Whether the world holds more than one rank."""
    return world_size() > 1


def quiet_dtensor_logs() -> None:
    """Silence DTensor's advice to flatten 2-D meshes and gloo's
    all-to-all fallback notice: they speak of speed, on every rank, at
    every redistribution."""
    import logging
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed._functional_collectives",
                 "torch.distributed.tensor._collective_utils"):
        logging.getLogger(name).setLevel(logging.ERROR)


def _sync_all_gather(self: torch.Tensor, gather_dim: int, group,
                     tag: str = "") -> torch.Tensor:
    """``_functional_collectives.all_gather_tensor`` over the plain,
    synchronous ``all_gather_into_tensor``: the shards stacked on dim 0
    in group rank order, then moved to ``gather_dim``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
    n = dist.get_world_size(pg)
    x = self.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def use_sync_all_gather() -> None:
    """Route DTensor's all-gathers through ``_sync_all_gather`` (ranks
    sharing a card over gloo; see the module docstring)."""
    import torch.distributed._functional_collectives as funcol
    for name in ("all_gather_tensor", "all_gather_single"):
        fn = getattr(funcol, name, None)
        if fn is not None:
            setattr(funcol, name, _sync_all_gather)


def _join(backend: str) -> None:
    """What a rank does after joining a world on ``backend``."""
    quiet_dtensor_logs()
    if backend == "cpu:gloo,cuda:gloo":
        use_sync_all_gather()


def backend_for(device: torch.device, world: int) -> str:
    if device.type != "cuda":
        return "gloo"
    if world > torch.cuda.device_count():
        return "cpu:gloo,cuda:gloo"
    return "cpu:gloo,cuda:nccl"


def local_device(device: torch.device, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` modulo the
    cards present (ranks share a card when there are more ranks)."""
    if device.type != "cuda":
        return torch.device("cpu")
    d = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(d)
    return d


def init_world(device) -> torch.device:
    """Join the world the environment describes (``torchrun``'s
    variables) and return this rank's device; with no such variables
    (or a world of one) nothing is initialized and ``device`` comes
    back as it was."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or initialized():
        if initialized():
            return local_device(device,
                                int(os.environ.get("LOCAL_RANK", rank())))
        return device
    dev = local_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend_for(dev, world)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    _join(backend)
    return dev


def rank_devices(device: torch.device) -> List[RankDevice]:
    """One handle per rank of the world, in rank order (each rank's
    device type is this rank's; the index is the rank's own)."""
    n = world_size()
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    return [RankDevice(r, torch.device("cuda", r % count) if count
                       else torch.device("cpu")) for r in range(n)]


def new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (collective: every rank of the
    world calls it, in the same order)."""
    return dist.new_group(sorted(int(r) for r in ranks))


# ---------------------------------------------------------------------------
# Exchange helpers
# ---------------------------------------------------------------------------

def to_host(tree):
    """Tensors -> CPU tensors (the picklable form a broadcast carries)."""
    from repro_torch.parallel.sharding import full
    from repro_torch.tree import tree_map
    return tree_map(lambda x: full(x).detach().cpu()
                    if torch.is_tensor(x) else x, tree)


def to_device(tree, device: torch.device):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)


def broadcast_object(obj: Any, src: int, group=None) -> Any:
    """``obj`` of global rank ``src`` on every rank of ``group`` (the
    world when None); ``src`` must be in the group."""
    box = [obj if rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's ``obj``, in group rank order."""
    n = dist.get_world_size(group)
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_tensor(x: Optional[torch.Tensor], src: int, shape, dtype,
                     device: torch.device, group=None) -> torch.Tensor:
    """A tensor of global rank ``src`` on every rank of ``group``; the
    receivers allocate ``shape``/``dtype`` on ``device``."""
    if rank() != src:
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        x = x.contiguous()
    dist.broadcast(x, src=src, group=group)
    return x


# ---------------------------------------------------------------------------
# spawn: a world of fresh interpreters (tests, chip_smoke)
# ---------------------------------------------------------------------------

def _rank_main(fn, r: int, world: int, device: str, store_path: str,
               out_path: str, args) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world))
    try:
        dev = torch.device(device)
        dev = local_device(dev, r)
        store = dist.FileStore(store_path, world)
        backend = backend_for(dev, world)
        dist.init_process_group(backend, store=store, rank=r,
                                world_size=world, timeout=TIMEOUT)
        _join(backend)
        try:
            result = ("ok", fn(dev, *args))
        finally:
            dist.destroy_process_group()
    except BaseException as e:          # carried back to the parent
        result = ("error", f"rank {r}: {e!r}\n{traceback.format_exc()}")
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world: int, device: str = "cpu", *args,
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world`` ranks, each in a fresh
    interpreter (``fn`` must be importable by name), and return the ranks'
    results in rank order.  Raises if any rank failed or the ranks did
    not end within ``timeout`` seconds; every rank process is ended
    before it returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, device, store, outs[r],
                                   args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = _now() + timeout
            for p in procs:
                p.join(max(deadline - _now(), 0.0))
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            if alive:
                raise TimeoutError(f"ranks {alive} did not end within "
                                   f"{timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                errors.append(f"rank {r}: exited with code "
                              f"{procs[r].exitcode} and no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            (results if status == "ok" else errors).append(value)
        if errors:
            raise RuntimeError("spawned world failed:\n" + "\n".join(errors))
        return results


def _now() -> float:
    import time
    return time.monotonic()


# ---------------------------------------------------------------------------
# probe: can ranks that share one card run the collectives DTensor uses?
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast",
               # what DTensor's redistributions call: the functional
               # collectives (an op, then ``wait_tensor``) ...
               "funcol.all_reduce", "funcol.reduce_scatter_tensor",
               # ... and a DTensor gathered through this world's
               # all-gather (``use_sync_all_gather`` where ranks share a
               # card)
               "dtensor.full_tensor")


def _probe_rank(device: torch.device) -> dict:
    """Each collective of ``COLLECTIVES`` once on this rank's device:
    {name: "ok" | "wrong result" | the error}."""
    n = world_size()
    checks = {
        "all_reduce": lambda: _reduced(device, n),
        "all_gather_into_tensor": lambda: _gathered(device, n),
        "reduce_scatter_tensor": lambda: _scattered(device, n),
        "broadcast": lambda: _broadcast(device),
        "funcol.all_reduce": lambda: _funcol(device, n, "all_reduce"),
        "funcol.reduce_scatter_tensor": lambda: _funcol(device, n,
                                                        "reduce_scatter"),
        "dtensor.full_tensor": lambda: _dtensor_full(device, n),
    }
    out = {"backend": str(dist.get_backend()), "device": str(device)}
    for name in COLLECTIVES:
        try:
            out[name] = "ok" if checks[name]() else "wrong result"
        except Exception as e:           # the probe reports, not raises
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _reduced(device, n):
    y = torch.full((4,), float(rank() + 1), device=device)
    dist.all_reduce(y)
    return bool(torch.all(y == n * (n + 1) / 2))


def _gathered(device, n):
    x = torch.full((4,), float(rank() + 1), device=device)
    y = torch.empty(4 * n, device=device)
    dist.all_gather_into_tensor(y, x)
    want = torch.arange(1, n + 1, device=device,
                        dtype=torch.float32).repeat_interleave(4)
    return bool(torch.equal(y, want))


def _scattered(device, n):
    y = torch.empty(4, device=device)
    dist.reduce_scatter_tensor(y, torch.ones(4 * n, device=device))
    return bool(torch.all(y == n))


def _broadcast(device):
    y = torch.full((4,), float(rank() + 7), device=device)
    dist.broadcast(y, src=0)
    return bool(torch.all(y == 7))


def _dtensor_full(device, n) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = DeviceMesh(device.type, torch.arange(n))
    x = torch.arange(8 * n, dtype=torch.float32, device=device).reshape(
        2 * n, 4)
    d = distribute_tensor(x, mesh, [Shard(1 if n <= 4 else 0)],
                          src_data_rank=None)
    return bool(torch.equal(d.full_tensor(), x))


def _funcol(device, n, which: str) -> bool:
    import torch.distributed._functional_collectives as funcol
    group = dist.group.WORLD
    if which == "all_reduce":
        x = torch.full((4,), float(rank() + 1), device=device)
        y = funcol.all_reduce(x, "sum", group)
        return bool(torch.all(y == n * (n + 1) / 2))
    y = funcol.reduce_scatter_tensor(torch.ones(4 * n, device=device), "sum",
                                     0, group)
    return bool(torch.all(y == n))


def probe_collectives(device: str = "cuda", world: int = 2,
                      timeout: float = 120.0) -> List[dict]:
    """Spawn ``world`` ranks on ``device`` (sharing a card when there are
    more ranks than cards) and run each collective of ``COLLECTIVES``;
    every rank's {collective: "ok" | "wrong result" | the error}.  A rank
    that dies makes ``spawn`` raise."""
    return spawn(_probe_rank, world, device, timeout=timeout)


def probe_ok(results: List[dict]) -> bool:
    """Whether every rank ran every collective sharded execution needs."""
    return all(r[c] == "ok" for r in results for c in COLLECTIVES)
