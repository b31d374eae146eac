"""Rank processes of `tests/test_torch_prior.py`'s data-parallel test: each
imports torch and the port only, joins a gloo process group through a
file, runs the port's prior step with `axis_name=DATA_AXIS` on its half of
the batches the test wrote, and saves its parameters and metrics after
every step.

Started by the test with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, workdir)`; `init` is the group's `file://` path.
"""

import os

import torch
import torch.distributed as dist

from medical_image_editing_tpu_torch.models.mingpt import GPT, GPTConfig
from medical_image_editing_tpu_torch.parallel import mesh
from medical_image_editing_tpu_torch.train.prior import (
    PriorTrainState,
    make_prior_optimizer,
    make_prior_train_step,
)


def run(rank, world, init, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        setup = torch.load(os.path.join(workdir, "setup.pt"), weights_only=True)
        gpt = GPT(GPTConfig(**setup["config"]))
        gpt.load_state_dict(setup["state_dict"], strict=True)
        state = PriorTrainState(gpt, make_prior_optimizer(gpt.parameters(), setup["lr"]),
                                torch.Generator().manual_seed(0))
        step = make_prior_train_step(sos_token=setup["sos"], axis_name=mesh.DATA_AXIS)
        out = {"params": [], "metrics": [], "all_reduces": 0}
        for ids in setup["ids"]:
            rows = ids.shape[0] // world
            mesh.collectives.clear()
            state, metrics = step(state, ids[rank * rows:(rank + 1) * rows])
            out["all_reduces"] += mesh.collectives["all_reduce"]
            out["params"].append({k: v.clone() for k, v in gpt.state_dict().items()})
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
    finally:
        mesh.destroy_distributed()
    torch.save(out, os.path.join(workdir, f"rank-{rank}.pt"))
