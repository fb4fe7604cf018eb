"""L6 — device mesh construction and sharding helpers.

The reference is a single-node, single-process C++ program (SURVEY.md §3.2:
no distributed backend exists).  This build distributes every stage
over a `jax.sharding.Mesh`:

* axis "data": reads / candidate pairs / alignment tiles are sharded
  data-parallel across all chips (the dominant axis for this workload).
* cross-shard merges (k-mer spectra, overlap edge lists) ride XLA collectives
  (psum / all_gather / all_to_all); the cards of one host are joined all to
  all, so the mesh is one flat axis — see hga_tpu/parallel/collectives.py.

Multi-host entry: call `init_distributed()` (wraps
`jax.distributed.initialize`) before `make_mesh()`; single-process runs and
the 8-device virtual-CPU test mesh need no init.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize multi-process JAX (no-op when single-process env vars
    absent).

    Each process binds to its own card: JAX reserves most of a card's
    memory when a process first touches it, so processes sharing a machine
    must not all open every card.  local_device_ids defaults to
    local_card(process_id).
    """
    if coordinator is None and "JAX_COORDINATOR" in os.environ:
        coordinator = os.environ["JAX_COORDINATOR"]
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator is None:
        return
    if local_device_ids is None:
        local_device_ids = local_card(process_id or 0)
    jax.distributed.initialize(coordinator, num_processes, process_id,
                               local_device_ids=local_device_ids)


def local_card(process_id: int) -> Optional[Sequence[int]]:
    """The one card a process owns on a CUDA machine — card process_id
    modulo the machine's card count (nvidia-smi -L) — or None elsewhere,
    which keeps JAX's default devices."""
    if (os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"
            or shutil.which("nvidia-smi") is None):
        return None
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True).stdout
    n = sum(1 for line in out.splitlines() if line.startswith("GPU "))
    return [process_id % n] if n else None


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over all (global) devices; default one flat 'data' axis."""
    devs = list(devices) if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axes)


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """The production mesh: all local devices on one 'data' axis, or None
    when only one device exists (single-chip path, no collectives)."""
    devs = jax.devices()
    if len(devs) < min_devices:
        return None
    return make_mesh(devices=devs)


def shard_batch_fn(mesh: Optional[Mesh], inner, n_in: int, out_axes):
    """Wrap a leading-axis-batched device fn for data-parallel execution.

    `inner(*arrays)` maps a batch to same-leading-axis outputs with NO
    cross-batch interaction (DP sweeps, edit-distance gates...).  With a
    mesh, the batch is split over the 'data' axis via shard_map — each chip
    runs `inner` on its shard; XLA inserts no collectives because none are
    needed.  Batches not divisible by the mesh size (tiny tails) fall back
    to single-device execution.

    out_axes: a pytree-structure callable/class (e.g. a NamedTuple class)
    taking P('data') leaves, or None for a single-array output.
    """
    if mesh is None or mesh.devices.size <= 1:
        return inner
    from hga_tpu.parallel.compat import shard_map

    ndev = mesh.devices.size
    if out_axes is None:
        out_specs = P("data")
    else:
        n_leaves = len(getattr(out_axes, "_fields", ())) or 1
        out_specs = out_axes(*([P("data")] * n_leaves))
    sharded = jax.jit(shard_map(
        inner, mesh=mesh,
        in_specs=(P("data"),) * n_in,
        out_specs=out_specs,
        check_rep=False,
    ))

    def f(*arrays):
        if arrays[0].shape[0] % ndev:
            return inner(*arrays)
        return sharded(*arrays)

    return f


def data_sharding(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Shard leading axis over 'data', replicate the rest."""
    spec = P("data", *([None] * (rank - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
