"""The ('dp', 'tp') device mesh (lidar_global_registration_tpu/parallel/mesh.py).

Axes:
  dp - data parallel over scan pairs (the reference's `tests:` loop,
       main.cpp:384-407, becomes a split of the pair batch);
  tp - tensor parallel inside one pair: each peer computes the products of
       its shard of the rows and of the matcher's train side, and the peers
       gather them (parallel/batch.py).

A torch.distributed DeviceMesh takes the place of jax.sharding.Mesh.  One
process is one mesh device.  The package names no backend: the caller
initialises the process group (torch.distributed.init_process_group, as
torchrun does) and the mesh takes the group that is there.  Two processes
may share one card over gloo (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over the processes of the initialised group, with
    the JAX package's defaults: n_devices every process of the group (it
    must be all of them), tp = 2 when n is even and at least 2, else 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: the mesh takes every process of the group ({world}), "
                         f"not {n}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp = {tp} does not divide {n} devices")
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


def pair_sharding(mesh: DeviceMesh):
    """This process's share of a [B, ...] batch of per-pair values (a
    tensor or a list) split over dp: a function x -> the B / dp pairs of
    this process's dp rank, in batch order."""
    dp, rank = mesh.size(0), mesh.get_local_rank("dp")

    def take(x):
        B = len(x)
        if B % dp:
            raise ValueError(f"a batch of {B} pairs does not split over dp = {dp}")
        b = B // dp
        return x[rank * b:(rank + 1) * b]

    return take


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's x [n, ...] (the same shape on every peer) concatenated
    along rows in rank order: [size * n, ...].  The port's one collective,
    all_gather_into_tensor on every backend: gloo takes CUDA tensors for it
    too (it copies them through host memory itself; checked on torch 2.11
    with CUDA 12.8), so nothing is staged here.  bool rows travel as
    uint8."""
    send = x.contiguous()
    if send.dtype == torch.bool:
        send = send.to(torch.uint8)
    out = send.new_empty((dist.get_world_size(group) * send.shape[0],) + tuple(send.shape[1:]))
    if out.numel():
        dist.all_gather_into_tensor(out, send, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out
