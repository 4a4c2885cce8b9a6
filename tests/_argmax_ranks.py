"""A rank of the two-process check of the argmax over a split vocab
(``tests/test_torch_cells.py``): a (1, 2) gloo mesh, the logits' last dim
split over "model".  Imports no JAX, so the spawned processes start
quickly."""
import pickle

import numpy as np
import torch
import torch.distributed as dist

# ties: row 0's maximum in both halves, row 1's twice in the second half,
# row 2's at the split, row 3 all equal
TIES = np.array([[0, 5, 1, 2, 5, 0, 5, 1],
                 [0, 1, 2, 3, 4, 7, 7, 1],
                 [1, 2, 3, 9, 9, 0, 0, 0],
                 [2, 2, 2, 2, 2, 2, 2, 2]], np.float32)


def ties():
    """(the split argmax, the whole argmax) of ``TIES``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import spmd
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    x = torch.from_numpy(TIES)
    got = spmd.argmax_last(distribute_tensor(x, mesh, (Replicate(),
                                                       Shard(1))))
    return got.full_tensor().numpy(), torch.argmax(x, -1).numpy()


def xlstm_decode(B=2, cache_len=16):
    """Reduced xlstm-350m's decode step on the (1, 2) mesh under the
    decode rules: (its token, torch.argmax of the step's logits made
    whole, the logits' placements)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.models import lm
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    rules = shd.rules_for(mesh, phase="decode")
    cfg = reduced_config("xlstm-350m")
    model, specs = lm.init(lm.build(cfg), torch.Generator().manual_seed(0),
                           dtype=cells.CDTYPE)
    shd.distribute_model(model, specs, mesh, rules)

    def states():
        return shd.distribute_tree(
            cells.concrete_states(model, B, cache_len, device="cpu"),
            shd.state_shardings(model, B, cache_len, mesh, rules), mesh)

    token = torch.tensor([[3], [cfg.vocab_size - 2]], dtype=torch.int32)
    cur = torch.zeros((B,), dtype=torch.int32)
    with cells.on_mesh(mesh):
        logits, _ = lm.decode_step(model, token, states(), cur,
                                   cells._ctx(mesh, rules))
    want = torch.argmax(shd.whole(logits)[:, -1], -1)
    step = cells.make_decode_step(model, mesh=mesh, rules=rules)
    got, _, _ = step(model, token, states(), cur)
    return (shd.whole(got)[:, 0].numpy(), want.numpy(),
            [str(p) for p in logits.placements])


def worker(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = {"ties": ties(), "xlstm": xlstm_decode()}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
