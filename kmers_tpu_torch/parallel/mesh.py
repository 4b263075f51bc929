"""Meshes: the ranks of a sharded pipeline and their transport.

Counterpart of ``kmers_tpu/parallel/mesh.py``.  A JAX mesh is a grid of
devices that one program spans; here a :class:`Mesh` is an ordered list of
ranks, each with a torch device, plus the transport between them.  Every
sharded function is written over per-rank tensors: it runs each of the
mesh's *local* ranks (those of this process) and meets the others only
through the mesh's collectives.

- **Local mode** (``Mesh(devices)``): every rank lives in this process, so
  one process can run any world size.  A device may repeat: 8 ranks on the
  CPU stand in for the JAX tests' forced host devices, and 4 ranks can share
  one GPU.  The collectives are copies between the ranks' tensors.
- **Process-group mode** (:func:`data_mesh` once ``torch.distributed`` is
  initialised): one rank a process, on ``cuda:{local rank}`` under NCCL or
  on the CPU under gloo.  ``all_to_all`` is ``dist.all_to_all_single`` of
  fixed-capacity buckets (every split is ``cap`` rows, so the split sizes
  agree without a handshake), the reductions are ``dist.all_reduce``, and a
  gather is ``dist.all_gather`` padded to the largest rank's rows, so every
  process gets the whole result (as ``process_allgather`` gives it in JAX).

A gather leaves the ranks' results on the device of this process's first
rank: the pipelines order the whole result there and download it once.

Nothing falls back quietly: a CUDA mesh without a GPU raises, and so does a
mesh whose device disagrees with the process group's backend.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import annotate, count

__all__ = ["Mesh", "data_mesh"]


class Mesh:
    """Ranks and their transport.

    ``devices`` are the devices of the local ranks, in rank order.  Without
    ``group`` the mesh is local: its ranks are ``0 .. len(devices) - 1``.
    With ``group`` (an initialised ``torch.distributed`` process group)
    this process is one rank of the group, on ``devices[0]``.
    """

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        for dev in self.devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"mesh rank on {dev}, but torch.cuda.is_available() is false")
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {dev}")
        self.group = group
        if group is None:
            self.size = len(self.devices)
            self.ranks = tuple(range(self.size))
        else:
            if len(self.devices) != 1:
                raise ValueError("a process-group mesh holds one rank a process")
            self.size = dist.get_world_size(group)
            self.ranks = (dist.get_rank(group),)

    def __repr__(self) -> str:
        mode = "local" if self.group is None else "process group"
        return f"Mesh(size={self.size}, ranks={list(self.ranks)}, {mode}, {list(map(str, self.devices))})"

    def put(self, rows: np.ndarray) -> list:
        """Each local rank's row of the host array ``rows`` (one row a rank
        of the whole mesh), uploaded to that rank's device (span
        ``kmers.upload``, counter ``upload_bytes``)."""
        if rows.shape[0] != self.size:
            raise ValueError(f"{rows.shape[0]} rows for a mesh of {self.size} ranks")
        with annotate("kmers.upload"):
            count("upload_bytes", sum(rows[r].nbytes for r in self.ranks))
            return [torch.from_numpy(np.ascontiguousarray(rows[r])).to(dev)
                    for r, dev in zip(self.ranks, self.devices)]

    def all_to_all(self, buckets: list) -> list:
        """Exchange per-rank buckets: local rank ``r`` gives a tensor of
        shape ``(size, cap, ...)`` whose row ``d`` goes to rank ``d``, and
        gets back the same shape whose row ``s`` came from rank ``s``."""
        if self.group is None:
            return [torch.stack([b[r].to(dev) for b in buckets])
                    for r, dev in zip(self.ranks, self.devices)]
        (send,) = buckets
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return [recv]

    def _reduce(self, values: list, op) -> list:
        with annotate("kmers.wait"):
            parts = [torch.as_tensor(v, dtype=torch.int64).reshape(-1) for v in values]
            if self.group is None:
                stacked = torch.stack([p.cpu() for p in parts])
                out = stacked.sum(0) if op == dist.ReduceOp.SUM else stacked.max(0).values
                return out.tolist()
            (part,) = parts
            part = part.to(self.devices[0]).clone()
            dist.all_reduce(part, op=op, group=self.group)
            return part.cpu().tolist()

    def sum(self, values: list) -> list:
        """Elementwise sum over all ranks of each local rank's 1-D int64
        values (JAX's ``psum``), as a list of ints on every process: a
        blocking read (span ``kmers.wait``)."""
        return self._reduce(values, dist.ReduceOp.SUM)

    def max(self, values: list) -> list:
        """Elementwise maximum over all ranks, as :meth:`sum`."""
        return self._reduce(values, dist.ReduceOp.MAX)

    def gather(self, parts: list) -> list:
        """Every rank's ``(n_r, ...)`` tensor, in rank order, on every
        process: on the device of this process's first rank, so that the
        caller can order the whole result there before one download."""
        if self.group is None:
            return [p.to(self.devices[0]) for p in parts]
        (part,) = parts
        dev = self.devices[0]
        part = part.to(dev)
        n = torch.tensor([part.shape[0]], dtype=torch.int64, device=dev)
        sizes = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(sizes, n, group=self.group)
        sizes = [int(s) for s in sizes]
        # pad to the largest rank's rows (at least one: no empty collective)
        padded = torch.zeros((max(max(sizes), 1), *part.shape[1:]), dtype=part.dtype, device=dev)
        padded[: part.shape[0]] = part
        outs = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(outs, padded, group=self.group)
        return [o[:s] for o, s in zip(outs, sizes)]


def _group_device(device: torch.device) -> torch.device:
    """This process's rank device under the initialised process group:
    ``cuda:{local rank}`` under NCCL, the CPU under gloo."""
    backend = str(dist.get_backend()).lower()
    if "nccl" in backend:
        want = "cuda"
    elif "gloo" in backend:
        want = "cpu"
    else:
        raise ValueError(f"unsupported process-group backend {backend!r} (NCCL or gloo)")
    if device.type != want:
        raise ValueError(f"a {backend} process group runs its ranks on {want}, not {device.type}")
    if want == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("NCCL process group, but torch.cuda.is_available() is false")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def data_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` ranks.

    Once ``torch.distributed`` is initialised: one rank a process over the
    whole default group (``n_devices`` must be None or the world size), on
    the device the backend implies (``device`` must agree: ``"cuda"`` for
    NCCL, ``"cpu"`` for gloo).  Otherwise a local mesh: on ``"cuda"`` the
    first ``n_devices`` GPUs (all by default; more than there are raises
    ``ValueError``, as the JAX ``data_mesh`` does), on ``"cpu"``
    ``n_devices`` ranks of the CPU (default 1).  For any other layout, such
    as several ranks on one GPU, build a :class:`Mesh` from a device list.
    """
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"requested {n_devices} ranks in a process group of {world}")
        return Mesh([_group_device(device)], group=dist.group.WORLD)
    if device.type == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError("a mesh needs at least one rank")
        return Mesh([device] * n)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA mesh requested but torch.cuda.is_available() is false")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} available")
    if n < 1:
        raise ValueError("a mesh needs at least one rank")
    return Mesh([torch.device("cuda", i) for i in range(n)])
