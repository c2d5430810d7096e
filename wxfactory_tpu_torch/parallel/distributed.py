"""Multi-process runs: process group, primary-only effects, gathers and
distributed checkpoints.

Counterpart of ``wxfactory_tpu/parallel/distributed.py`` (:38-196). The
reference runs one MPI rank per cubed-sphere tile and gates host-side
effects on rank 0; the JAX package runs multi-controller JAX. The port runs
one process per rank through ``torch.distributed``, initialised from the
CLI's ``--coordinator/--num-processes/--process-id`` or from torchrun's
environment. Two groups serve it:

* the halo group (the default group), for the tile step's halo exchange:
  NCCL when every rank has a card of its own, so halos stay on the device;
  gloo otherwise — on the CPU, and when ranks share a card (NCCL refuses
  two ranks on one device), where halos are staged through host memory;
* a gloo group for host-side collectives (gathers to the primary,
  manifests, barriers, the NaN flag).

The rendezvous store (a TCP store that rank 0 serves, or torchrun's agent
store) is made here and kept past the process group, so that a run that
finished can leave in order: every rank counts itself out on it after
``destroy_process_group``, and rank 0, whose process serves it, waits for
all of them before it exits (``shutdown``).

Checkpoints keep the JAX package's formats: below 256 MB the primary
gathers the state and writes the reference's single file; above, every
rank writes its tiles as ``<path>.shard<rank>_<tile>.npy`` and the primary
writes ``<path>`` as a JSON manifest. ``load_state_distributed`` reads
either at any process count.
"""

import datetime
import json
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common.device import to_host
from .mesh import TileMesh, tile_view

_SMALL_STATE_BYTES = 1 << 28  # 256 MB: gather-and-single-file below this
_TIMEOUT = datetime.timedelta(seconds=600)
# How long rank 0 waits, after a clean run, for the other ranks to count out.
_EXIT_DEADLINE_S = 60.0
_EXITED_KEY = "wxfactory_tpu_torch/exited"

# The rendezvous store, the host group and the halo group's backend, set by
# init_distributed.
_store = None
_host_group = None
halo_backend: Optional[str] = None


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda") -> Tuple[int, int, int]:
    """Join the process group of a multi-process run; returns (rank, world
    size, local rank). The address, world size and rank come from the
    arguments (``coordinator`` "host:port") or, where they are absent, from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK). A world of one process initialises nothing. The halo
    group's backend follows ``device``: NCCL for CUDA when there are at
    least as many cards as ranks, gloo otherwise; rank 0 prints the choice."""
    global _store, _host_group, halo_backend
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    local_rank = int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else rank
    if world <= 1:
        return 0, 1, 0
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local_rank
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    if cuda and cards >= world:
        halo_backend, why = "nccl", f"{world} ranks on {cards} cards: halos stay on the device"
    elif cuda:
        halo_backend, why = "gloo", (f"{world} ranks share {cards} card(s) and NCCL refuses two ranks on one "
                                     "device: halos are staged through host memory")
    else:
        halo_backend, why = "gloo", "ranks on the CPU"
    if cuda:
        torch.cuda.set_device(local_rank % cards)
    # The store init_process_group would make from init_method, made here so
    # that it outlives the process group (shutdown's count).
    _store, rank, world = next(dist.rendezvous(init_method, rank, world, timeout=_TIMEOUT))
    _store.set_timeout(_TIMEOUT)
    dist.init_process_group(halo_backend, store=_store, world_size=world, rank=rank, timeout=_TIMEOUT)
    _host_group = dist.new_group(backend="gloo", timeout=_TIMEOUT) if halo_backend != "gloo" else dist.group.WORLD
    primary_print(f"distributed: {world} ranks, halo exchange over {halo_backend} ({why})", flush=True)
    return rank, world, local_rank


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side effects (rank 0)."""
    return rank() == 0


def primary_print(*args, **kwargs) -> None:
    if is_primary():
        print(*args, **kwargs)


def halo_staged(device) -> bool:
    """Whether the halo exchange must stage device tensors through host
    memory (a gloo halo group with CUDA tensors)."""
    return halo_backend == "gloo" and torch.device(device).type == "cuda"


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier(group=_host_group)


def shutdown(clean: bool = True) -> None:
    """Leave the process group. After a run that finished (``clean``) every
    rank first meets the others at a barrier on the host group, then
    destroys the group, then counts itself out on the rendezvous store;
    rank 0, whose process serves that store, returns only once every rank
    has counted out (or after ``_EXIT_DEADLINE_S``), so no rank is still
    tearing its group down when the store goes away. After a failure it
    leaves at once: a rank that failed must not wait on ranks that died."""
    global _store, _host_group
    if not dist.is_initialized():
        return
    me, world = dist.get_rank(), dist.get_world_size()
    if clean:
        barrier()
    _host_group = None  # no reference of ours keeps the destroyed group alive
    dist.destroy_process_group()
    store, _store = _store, None
    if clean and store is not None:
        _count_out(store, me, world)


def _count_out(store, me: int, world: int) -> None:
    """Count this rank out on ``store``; on rank 0 wait until all ``world``
    ranks have."""
    count = store.add(_EXITED_KEY, 1)
    if me != 0:
        return
    deadline = time.monotonic() + _EXIT_DEADLINE_S
    while count < world and time.monotonic() < deadline:
        time.sleep(0.01)
        count = store.add(_EXITED_KEY, 0)
    if count < world:
        print(f"distributed: {world - count} of {world} ranks did not leave within {_EXIT_DEADLINE_S:.0f} s",
              file=sys.stderr, flush=True)


def all_true(flag: bool) -> bool:
    """``flag`` and-reduced over every rank (itself in one process)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_host_group)
    return bool(t.item())


def _owned_tiles(q: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """This rank's tiles of the global-layout state, stacked on the host:
    (tiles, nvar, 1, [nk,] nt, nt, nodes)."""
    nt = q.shape[-2] // mesh.n
    tiles = mesh.tiles()
    return torch.stack([tile_view(q, *tiles[t], nt) for t in mesh.owned()]).cpu()


def gather_global(q: torch.Tensor, mesh: Optional[TileMesh]) -> Optional[np.ndarray]:
    """The global state as host numpy on the primary (None on the other
    ranks): each rank's own tiles gathered to rank 0 over the host group,
    the reference's ``gather_cube`` (process_topology.py:444 there). A run
    in one process returns ``q`` on the host."""
    if mesh is None or mesh.owns_all or not dist.is_initialized():
        return to_host(q)
    mine = _owned_tiles(q, mesh)
    parts = [torch.empty_like(mine) for _ in range(mesh.world)] if is_primary() else None
    dist.gather(mine, parts, dst=0, group=_host_group)
    if not is_primary():
        return None
    out = np.empty(tuple(q.shape), dtype=mine.numpy().dtype)
    nt = q.shape[-2] // mesh.n
    tiles = mesh.tiles()
    for r, part in enumerate(parts):
        for k, t in enumerate(range(r * mesh.per_rank, (r + 1) * mesh.per_rank)):
            tile_view(out, *tiles[t], nt)[...] = part[k].numpy()
    return out


# ----------------------------------------------------------------------
# Checkpoint / restart across ranks


def save_state_distributed(q: torch.Tensor, mesh: Optional[TileMesh], config, path: str,
                           small_bytes: int = _SMALL_STATE_BYTES) -> None:
    """Checkpoint the global state of a tile-parallel run.

    Small states (< 256 MB): gathered to the primary, which writes the
    reference-format single file (output/state.py). Large states: every rank
    writes one ``<path>.shard<rank>_<tile>.npy`` per tile it owns (memory
    layout), and the primary writes ``<path>`` as a JSON manifest with the
    global shape and dtype, each shard's index and the configuration text."""
    from ..output.state import save_state

    nbytes = q.numel() * q.element_size()
    if mesh is None or mesh.owns_all or not dist.is_initialized() or nbytes < small_bytes:
        state = gather_global(q, mesh)
        if state is not None:
            save_state(state, config, path)
        barrier()
        return
    nt = q.shape[-2] // mesh.n
    tiles = mesh.tiles()
    shards = []
    for t in mesh.owned():
        p, ty, tx = tiles[t]
        fname = f"{path}.shard{mesh.rank}_{t}.npy"
        np.save(fname, to_host(tile_view(q, p, ty, tx, nt)))
        index = [[0, q.shape[0]], [p, p + 1]] + [[0, n] for n in q.shape[2:-3]]
        index += [[ty * nt, (ty + 1) * nt], [tx * nt, (tx + 1) * nt], [0, q.shape[-1]]]
        shards.append({"file": os.path.basename(fname), "index": index})
    groups = [None] * mesh.world
    dist.all_gather_object(groups, shards, group=_host_group)
    if is_primary():
        manifest = {
            "format": "wxfactory_tpu-sharded-state", "version": "1.0", "global_shape": list(q.shape),
            "dtype": str(np.dtype(str(q.dtype).replace("torch.", ""))), "panel_major_file": False,
            "shards": [s for group in groups for s in group], "config": getattr(config, "raw_text", ""),
        }
        with open(path, "w") as fh:
            json.dump(manifest, fh)
    barrier()


def load_state_distributed(path: str) -> Tuple[np.ndarray, Optional[str]]:
    """A checkpoint written by ``save_state_distributed`` (either form) as
    the global host array (nvar, 6, ...); returns (state, configuration
    text or None). Works at any process count: every rank reads the whole
    file or manifest and every shard."""
    with open(path, "rb") as fh:
        head = fh.read(32)
    if head.startswith(b"{"):
        with open(path) as fh:
            manifest = json.load(fh)
        out = np.empty(manifest["global_shape"], dtype=np.dtype(manifest["dtype"]))
        d = os.path.dirname(path)
        for s in manifest["shards"]:
            out[tuple(slice(a, b) for a, b in s["index"])] = np.load(os.path.join(d, s["file"]))
        return out, manifest.get("config") or None

    from ..output.state import load_state

    state, config, _version = load_state(path, parse_config=False)
    return state, config
