"""Device meshes: the counterpart of the JAX package's ``parallel/mesh.py``.

The framework's two parallel axes (the reference's per-GPU byte-range
split, encode.cu:368-380, plus the wide stripe):

* ``cols``: the chunk-column axis.  Every device holds a column slice of
  all stripe rows; no communication ever.
* ``stripe``: the k (stripe-row) axis, for wide stripes (the k=128
  configurations) where one device should not hold all k rows.  The XOR
  across devices becomes an integer sum of bit-plane partials
  (:mod:`.sharded`).

A :class:`Mesh` is a (stripe, cols) array of ``torch.device``, with the
index of the process that holds each position.  One device may be listed
several times: the port's counterpart of the JAX package's virtual CPU
devices.  ``cpu`` listed 8 times is the CPU tests' mesh, ``cuda:0`` listed
S times the one-card machine's wide stripe; each position still gets its
own shard buffers and its own launches.
"""

from __future__ import annotations

import numpy as np
import torch

COLS, STRIPE = "cols", "stripe"


class Mesh:
    """A (stripe, cols) array of devices with axes ``(STRIPE, COLS)``.

    ``devices``: a 2-D nested sequence (or array) of ``torch.device`` or
    device strings.  ``processes``: the same shape of process indices (the
    rank that holds each position); default this process for all.
    """

    axis_names = (STRIPE, COLS)

    def __init__(self, devices, processes=None):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(row) != len(rows[0]) for row in rows):
            raise ValueError("a mesh is a non-empty (stripe, cols) array of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for s, row in enumerate(rows):
            for c, dev in enumerate(row):
                self.devices[s, c] = dev
        if processes is None:
            from .distributed import rank

            processes = np.full(self.devices.shape, rank(), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(self.devices.shape)
        self._groups = None  # the stripe reduction's process groups (sharded.py)

    @property
    def shape(self) -> dict:
        return {STRIPE: self.devices.shape[0], COLS: self.devices.shape[1]}

    def local_positions(self, rank: int | None = None) -> list[tuple[int, int]]:
        """The (stripe, col) positions process ``rank`` (default this one)
        holds, in row-major order."""
        if rank is None:
            from .distributed import rank as _rank

            rank = _rank()
        return [(int(s), int(c)) for s, c in zip(*np.nonzero(self.processes == rank))]

    @property
    def home(self) -> torch.device:
        """The device this process's results land on: its first position's."""
        pos = self.local_positions()
        if not pos:
            raise ValueError("this process holds no position of the mesh")
        return self.devices[pos[0]]

    def fingerprint(self) -> tuple:
        """Hashable identity: axes, shape, devices, the processes that hold
        them and the platform (the plan key's mesh part)."""
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(int(p) for p in self.processes.flat), self.devices.flat[0].type)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device_type(device) -> str:
    """``None`` means CUDA (raising with no GPU, as every entry point does);
    a named device is taken as given."""
    from ..utils.backend import resolve_device

    return resolve_device(device).type


def _global_devices(dev_type: str, n_devices: int | None) -> list[tuple[int, torch.device]]:
    """(process, device) for every device of the job, ordered by process.
    Single-process: every CUDA device, or ``cpu`` listed ``n_devices``
    times.  A multi-process job (``torch.distributed`` initialised): one
    card a process (``LOCAL_RANK``'s, torchrun's convention), or ``cpu``
    listed ``n_devices / world`` times a process."""
    from .distributed import local_rank, rank, world_size

    world, me = world_size(), rank()
    if dev_type == "cpu":
        n = n_devices or world
        if n % world:
            raise ValueError(f"{n} CPU devices do not split evenly over {world} processes")
        return [(r, torch.device("cpu")) for r in range(world) for _ in range(n // world)]
    count = torch.cuda.device_count()
    if world == 1:
        return [(0, torch.device("cuda", i)) for i in range(count)]
    own = torch.device("cuda", local_rank() % count)
    # Another process's card is named by type only: this process never
    # touches it.
    return [(r, own if r == me else torch.device("cuda")) for r in range(world)]


def make_mesh(n_devices: int | None = None, stripe: int = 1, device=None) -> Mesh:
    """Mesh over the first ``n_devices`` devices of the job, shaped
    ``(stripe, n_devices // stripe)`` with axes ``(STRIPE, COLS)``.

    ``device``: None builds over the CUDA devices (and raises with no GPU),
    ``"cpu"`` over ``cpu`` listed ``n_devices`` times (the counterpart of
    the JAX package's forced host devices).  More devices than there are,
    or a count ``stripe`` does not divide, is refused as in the JAX
    package.  A mesh that lists one card several times is built with
    :class:`Mesh` directly.
    """
    devs = _global_devices(_device_type(device), n_devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    if stripe < 1 or n % stripe:
        raise ValueError(f"{n} devices not divisible by stripe={stripe}")
    procs = np.array([p for p, _ in devs[:n]]).reshape(stripe, n // stripe)
    grid = [[devs[s * (n // stripe) + c][1] for c in range(n // stripe)] for s in range(stripe)]
    return Mesh(grid, procs)
