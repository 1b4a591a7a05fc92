"""Input pipeline: background prefetch and placement of host batches on
the device, each data-parallel rank taking its rows.

The port of :mod:`repro.data.pipeline`.  :class:`Prefetcher` is a copy.
:func:`shard_batch` is the reference's placement with one process per
rank: where the reference lays the global batch out over the mesh with
its batch dimension split over the data axes, each rank here keeps the
rows that would lie on it, and keeps the whole batch where the reference
replicates it (a 0-d leaf, no data axis, or a batch the data axes do not
divide).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.sharding import mesh_axis_sizes
from ..tree import tree_map

__all__ = ["Prefetcher", "shard_batch"]


def _data_index(mesh, batch_axes):
    """``(index, size)`` of this rank along the mesh's data axes (their
    row-major combination), ``(0, 1)`` without a mesh or data axis."""
    if mesh is None:
        return 0, 1
    sizes = mesh_axis_sizes(mesh)
    index, size = 0, 1
    for a in batch_axes:
        if a in sizes:
            index = index * sizes[a] + mesh.get_local_rank(a)
            size *= sizes[a]
    return index, size


def shard_batch(batch, mesh, device, batch_axes=("pod", "data")):
    """Host numpy batch -> tensors on ``device`` (through pinned memory
    on a CUDA device); on a mesh with data axes of size D > 1, this
    rank's 1/D of the rows of each leaf whose batch D divides."""
    device = torch.device(device)
    index, size = _data_index(mesh, batch_axes)

    def put(x):
        x = np.asarray(x)
        if size > 1 and x.ndim and x.shape[0] % size == 0:
            n = x.shape[0] // size
            x = x[index * n:(index + 1) * n]
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return tree_map(put, batch)


class Prefetcher:
    """Runs an iterator in a thread, keeping ``depth`` batches ready."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._transform = transform

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
