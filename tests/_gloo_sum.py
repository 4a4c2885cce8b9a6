"""A rank of the two-process check of ``compressed_psum_tree`` over a
``torch.distributed`` gloo group (``tests/test_torch_optimizer.py``);
imports no JAX, so the spawned processes start quickly."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll


def grads_of(rank):
    rng = np.random.default_rng(100 + rank)
    return {"w": torch.from_numpy(rng.standard_normal((64, 9)).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(300).astype(
            np.float32))]}


def worker(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        g = grads_of(rank)
        err = {"w": torch.zeros(64, 9), "b": [torch.zeros(300)]}
        summed, new_err = coll.compressed_psum_tree(g, err,
                                                    group=dist.group.WORLD)
        total = coll.global_batch_psum(torch.tensor([float(rank + 1)]),
                                       group=dist.group.WORLD)
        if rank == 0:
            torch.save({"summed": summed, "err": new_err, "total": total},
                       out)
    finally:
        dist.destroy_process_group()
