"""Seeding.

Counterpart of `medical_image_editing_tpu/utils/seed.py` (reference
`src/utils/init_seed.py`): the seed comes from `config.run.seed_list` (by
process rank) or is drawn at random, and seeds Python's `random`, numpy and
torch. Where the JAX function returns a PRNG key, this one returns the
integer seed: the trainer seeds its models' initialisation and its train
state's `torch.Generator` (on the device) with it.

Every process of a `torch.distributed` run derives the same seed, process
0's, so their replicated models start identical (DDP's rank-0 broadcast);
each process still seeds its host RNGs with its own list entry, as the
reference does.
"""

import random
from typing import List, Optional, Tuple

import numpy as np
import torch


def _rank_and_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_seed(seed_list: Optional[List[int]] = None) -> Tuple[int, List[int]]:
    """Returns (seed for the models and the generator, seed_list logged)."""
    rank, world = _rank_and_world()
    if seed_list:
        seed = int(seed_list[rank % len(seed_list)])
        logged = list(seed_list)
    else:
        seed = random.randint(1, 10000)
        logged = [seed]
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    model_seed = seed
    if world > 1:
        import torch.distributed as dist

        box = [seed]
        dist.broadcast_object_list(box, src=0)
        model_seed = int(box[0])
    print(f"Seed set to {seed} in process {rank} (model seed {model_seed})")
    return model_seed, logged
