"""The shard mesh: where the shards of a distributed transform live.

The port of the JAX package's 1-D ``"fft"`` mesh and its 2-D ``("fft",
"fft2")`` pencil mesh (``spfft_tpu/parallel/mesh.py``).
A :class:`ShardMesh` is what one process contributes: one ``torch.device``
that holds this process's shards stacked on axis 0, and optionally a
``torch.distributed`` process group joining the processes. The shard ids are
global: process ``rank`` holds shards ``rank * num_local ... + num_local - 1``.

* No group: one process holds every shard, and the exchange between them is
  a data movement on its device (no collective).
* A group (of any size, 1 included): the exchange is
  ``torch.distributed.all_to_all_single`` over it, NCCL on the card and gloo
  on the CPU; each process supplies and receives only its own shards.

A pencil mesh (:func:`make_fft_mesh2`) has a ``shape`` ``(P1, P2)``: shard
``s`` is ``(a, b) = (s // P2, s % P2)``, ``a`` on the ``"fft"`` axis (x-groups
and y-slabs), ``b`` on ``"fft2"`` (z-slabs); a 1-D mesh has no shape.
"""
from __future__ import annotations

import dataclasses

import torch

from ..errors import GPUNoDeviceError, InvalidParameterError, MPIError

FFT_AXIS = "fft"
FFT_AXIS2 = "fft2"


def _ask_group(query: str, group) -> int:
    """``torch.distributed.<query>(group)``; a group that cannot answer is
    an :class:`MPIError`, the exchange layer's failure."""
    import torch.distributed as dist

    try:
        return getattr(dist, query)(group)
    except (RuntimeError, ValueError) as e:
        raise MPIError(f"the exchange's process group failed {query}: {e}") from e


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMesh:
    """``num_local`` shards of a transform stacked on ``device``, and the
    process group (None: this process holds every shard)."""

    device: torch.device
    num_local: int
    group: object = None
    shape: tuple | None = None  # (P1, P2) on a pencil mesh

    @property
    def world(self) -> int:
        """Processes in the mesh (1 without a group)."""
        return 1 if self.group is None else _ask_group("get_world_size", self.group)

    @property
    def rank(self) -> int:
        """This process's place in the group (0 without a group)."""
        return 0 if self.group is None else _ask_group("get_rank", self.group)

    @property
    def num_shards(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.num_local * self.world

    @property
    def local_shards(self) -> range:
        """The global ids of this process's shards, in their stacking order."""
        return range(self.rank * self.num_local, (self.rank + 1) * self.num_local)


def _mesh_device(device, what: str) -> torch.device:
    """``device`` None is the current CUDA device, and raises
    :class:`GPUNoDeviceError` where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise GPUNoDeviceError(f"{what}: no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_group(group, what: str) -> None:
    if group is not None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise InvalidParameterError(
                f"{what}: a process group needs torch.distributed initialised "
                "(init_distributed)")


def make_fft_mesh(num_shards: int, device=None, group=None) -> ShardMesh:
    """A mesh of ``num_shards`` shards on this process's ``device``, joined
    to the other processes of ``group`` (their shards follow this one's in
    rank order; every process passes the same ``num_shards``).

    ``device`` None is the current CUDA device, and raises
    :class:`GPUNoDeviceError` where there is none: nothing falls back to the
    CPU. Tests pass ``device="cpu"``.
    """
    num_shards = int(num_shards)
    if num_shards < 1:
        raise InvalidParameterError(f"a mesh holds at least one shard, got {num_shards}")
    device = _mesh_device(device, "make_fft_mesh")
    _check_group(group, "make_fft_mesh")
    return ShardMesh(device, num_shards, group)


def make_fft_mesh2(p1: int, p2: int, device=None, group=None) -> ShardMesh:
    """A 2-D ``(p1, p2)`` pencil mesh (axes ``"fft"`` x ``"fft2"``): space is
    cut into z-slabs over ``"fft2"`` and y-slabs over ``"fft"``, which lifts
    the slab decomposition's ``P <= dim_z`` cap to ``p1 * p2 <= dim_z *
    dim_y`` (:mod:`~spfft_tpu_torch.parallel.pencil2`). The ``p1 * p2``
    shards are split evenly over the processes of ``group`` in rank order
    (all of them on this process without one); ``device`` as in
    :func:`make_fft_mesh`."""
    try:
        p1, p2 = int(p1), int(p2)
    except (TypeError, ValueError):
        raise InvalidParameterError(f"mesh factors must be integers, got {p1!r}, {p2!r}") from None
    if p1 < 1 or p2 < 1:
        raise InvalidParameterError(f"mesh factors must be positive, got ({p1}, {p2})")
    device = _mesh_device(device, "make_fft_mesh2")
    _check_group(group, "make_fft_mesh2")
    world = 1 if group is None else _ask_group("get_world_size", group)
    if (p1 * p2) % world:
        raise InvalidParameterError(
            f"make_fft_mesh2({p1}, {p2}): {p1 * p2} shards do not split evenly over "
            f"{world} processes")
    return ShardMesh(device, p1 * p2 // world, group, (p1, p2))


def is_pencil2_mesh(mesh) -> bool:
    """True for a 2-D pencil mesh (:func:`make_fft_mesh2`)."""
    return isinstance(mesh, ShardMesh) and mesh.shape is not None


def fft_mesh_size(mesh: ShardMesh) -> int:
    """Shards of the whole mesh, over every process."""
    if not isinstance(mesh, ShardMesh):
        raise InvalidParameterError(
            f"expected a ShardMesh (make_fft_mesh), got {type(mesh).__name__}")
    return mesh.num_shards


def validate_distributed_args(coordinator_address, num_processes, process_id) -> None:
    """Typed up-front validation of :func:`init_distributed`'s arguments, as
    in the JAX package: the coordinator is ``host:port`` with a port in
    [1, 65535], ``num_processes >= 1``, ``0 <= process_id < num_processes``;
    all three may be None together (``env://`` initialisation)."""
    if coordinator_address is not None:
        addr = str(coordinator_address)
        host, sep, port_s = addr.rpartition(":")
        if not sep or not host:
            raise InvalidParameterError(
                f"malformed coordinator_address {addr!r}: expected 'host:port' "
                "(e.g. 'localhost:29500')")
        try:
            port = int(port_s)
        except ValueError:
            raise InvalidParameterError(
                f"malformed coordinator_address {addr!r}: port {port_s!r} is not an "
                "integer") from None
        if not 1 <= port <= 65535:
            raise InvalidParameterError(
                f"coordinator_address {addr!r}: port {port} out of range [1, 65535]")
    if num_processes is not None:
        try:
            n = int(num_processes)
        except (TypeError, ValueError):
            raise InvalidParameterError(
                f"invalid num_processes {num_processes!r}: expected an integer >= 1") from None
        if n < 1:
            raise InvalidParameterError(f"invalid num_processes {num_processes}: expected >= 1")
    if process_id is not None:
        try:
            pid = int(process_id)
        except (TypeError, ValueError):
            raise InvalidParameterError(
                f"invalid process_id {process_id!r}: expected an integer") from None
        if pid < 0:
            raise InvalidParameterError(f"invalid process_id {pid}: expected >= 0")
        if num_processes is None:
            raise InvalidParameterError(
                "process_id given without num_processes: a rank cannot join a run of "
                "unknown size")
        if pid >= int(num_processes):
            raise InvalidParameterError(
                f"process_id {pid} out of range for num_processes {int(num_processes)}")


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, **kwargs):
    """Join a multi-process run: a thin wrapper over
    ``torch.distributed.init_process_group`` (the reference's ``MPI_Init``
    requirement, src/mpi_util/mpi_init_handle.hpp:43-48). ``backend`` None
    is ``"nccl"`` where CUDA is available, else ``"gloo"``; the coordinator
    becomes ``tcp://host:port``. Returns the default process group, which
    :func:`make_fft_mesh` takes as ``group``.

    A fused plan over an NCCL group captures its collectives in each
    direction's CUDA graph. No setting of NCCL or torch is changed for that:
    it relies on NCCL's default ``NCCL_GRAPH_MIXING_SUPPORT=1`` (eager
    collectives on the communicator, such as guard's and verify's
    all-reduces, mix with captured ones) and on ``TORCH_NCCL_BLOCKING_WAIT``
    being off (a blocking wait cannot be captured). A replay that waits on
    a lost peer is not the watchdog's: ``SPFFT_TPU_FENCE_BUDGET_S`` bounds
    it (``docs/torch/details.md``). Leave with :func:`shutdown_distributed`:
    NCCL's communicator cannot be destroyed while such a graph lives."""
    import torch.distributed as dist

    validate_distributed_args(coordinator_address, num_processes, process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = None if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init, rank=-1 if process_id is None else int(process_id),
        world_size=-1 if num_processes is None else int(num_processes), **kwargs)
    return dist.group.WORLD


def shutdown_distributed() -> None:
    """Leave a multi-process run: drop the CUDA graph of every fused plan
    that captured a collective (those plans' later calls raise
    :class:`MPIError`), then ``torch.distributed.destroy_process_group``.
    NCCL's communicator cannot be destroyed while a graph holds its kernels:
    ``destroy_process_group`` called with such a plan alive waits forever."""
    import torch.distributed as dist

    from ..ir.compile import release_collective_graphs

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    release_collective_graphs()
    if dist.is_initialized():
        dist.destroy_process_group()
