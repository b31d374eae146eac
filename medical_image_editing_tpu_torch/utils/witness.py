"""A float64 CPU witness of a training step, for holding a step on the card
to the CPU.

A card's float32 step and the CPU's float32 step differ by their orders of
summation; neither is the right answer. The witness is the same step in
float64 on the CPU, fed the ids that the run under test quantized to (so a
code at a near tie keeps that run's choice). A run is held to it by its
relative distance, within 5× the larger of the two CPU float32 steps'
distances from it (oneDNN's convolutions and PyTorch's native ones), or a
minimum, and never above a fixed cap (`witness_limits`). Nothing the card
computes in the run moves the limit.

Used by `chip_smoke.py`'s card-vs-CPU parts and by the card's tests in
`tests/test_torch_port_gpu.py`; `recorded_vq_ids` and `assignment_of` also
by the ddp phase's serial references, which replay the ranks' ids. Imports
only torch.
"""

import contextlib
import hashlib


@contextlib.contextmanager
def recorded_vq_ids():
    """Inside the block every VQ assignment appends its ids (on the host,
    one tensor a call) to the list the block gets."""
    from ..ops import vq_fused

    seen, names, depth = [], ("vq_assign_fused", "vq_assign_fused_reference"), [0]
    real = {n: getattr(vq_fused, n) for n in names}

    def recording(fn):
        def assign(embed, flat):
            depth[0] += 1  # the kernel's wrapper calls its plain version on the CPU
            try:
                out = fn(embed, flat)
            finally:
                depth[0] -= 1
            if not depth[0]:
                seen.append(out[0].detach().cpu().clone())
            return out
        return assign

    for n, fn in real.items():
        setattr(vq_fused, n, recording(fn))
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(vq_fused, n, fn)


def assignment_of(ids, embed, flat):
    """What a VQ assignment (`vq_assign_fused`) returns for the given `ids`
    of the rows `flat` (N, C) against `embed` (K, C): the ids (int32), the
    codes, the per-code counts and sums, in `flat`'s dtype."""
    import torch
    import torch.nn.functional as F

    ids = ids.to(flat.device).long()
    if ids.shape != flat.shape[:1]:
        raise ValueError(f"{tuple(ids.shape)} ids for {flat.shape[0]} rows")
    onehot = F.one_hot(ids, embed.shape[0]).to(flat.dtype)
    return ids.to(torch.int32), embed[ids], onehot.sum(0), onehot.t() @ flat


@contextlib.contextmanager
def float64_step(ids_calls):
    """Inside the block a port step on float64 modules computes in float64
    on the CPU: `Tensor.float` gives float64 (the step's own f32 casts:
    losses, norms, the reconstructions), `torch.as_tensor(..., float32)`
    float64, and each VQ assignment returns the next of `ids_calls` (the
    run's own ids, one entry a call, so a code at a near tie keeps the
    run's choice) with its rows, counts and sums in float64. The
    augmented views and the cross-view id warps, inputs rather than the
    function held, are computed in float32 as the CPU step computes them.
    The spectral-norm power step runs in float64 from the modules' own
    vectors."""
    import torch

    from ..ops import vq_fused
    from ..train import first_stage

    calls = list(ids_calls)
    real_float = torch.Tensor.float
    own_float = "float" in torch.Tensor.__dict__
    real_as_tensor = torch.as_tensor
    names = ("vq_assign_fused", "vq_assign_fused_reference")
    real_assign = {n: getattr(vq_fused, n) for n in names}
    real_aug = {n: getattr(first_stage, n) for n in ("random_transform", "cross_view_transform")}

    def as_float64(self, *args, **kw):
        return self.double()

    def as_tensor(data, dtype=None, device=None):
        return real_as_tensor(data, dtype=torch.float64 if dtype == torch.float32 else dtype,
                              device=device)

    def replay(embed, flat):
        return assignment_of(calls.pop(0), embed.double(), flat.double())

    def in_float32(fn):
        def run(*args):
            torch.Tensor.float = real_float
            try:
                out = fn(*(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                           for a in args))
            finally:
                torch.Tensor.float = as_float64
            if torch.is_tensor(out):
                return out.double()
            return tuple(o.double() for o in out)
        return run

    torch.Tensor.float = as_float64
    torch.as_tensor = as_tensor
    for n in names:
        setattr(vq_fused, n, replay)
    for n, fn in real_aug.items():
        setattr(first_stage, n, in_float32(fn))
    try:
        yield
    finally:
        if own_float:
            torch.Tensor.float = real_float
        else:
            del torch.Tensor.float
        torch.as_tensor = real_as_tensor
        for n, fn in real_assign.items():
            setattr(vq_fused, n, fn)
        for n, fn in real_aug.items():
            setattr(first_stage, n, fn)
    if calls:
        raise RuntimeError(f"{len(calls)} recorded VQ assignments not replayed")


def to_float64(*modules):
    """Each module in float64 in place, with no compute dtype: its
    convolutions and its inputs in the promoted dtype."""
    for m in modules:
        for sub in m.double().modules():
            if hasattr(sub, "compute_dtype"):
                sub.compute_dtype = None


def first_moments(state, parts):
    """Adam's first moment of each of `parts` ((module, optimizer) field
    names), flattened in `parameters()` order, on the host."""
    import torch

    return {m: torch.cat([getattr(state, o).state[p]["exp_avg"].flatten().cpu()
                          for p in getattr(state, m).parameters()]) for m, o in parts}


def ids_key(vq_ids):
    """A digest of one run's sequence of VQ ids (its witness's key)."""
    return hashlib.sha1(b"".join(t.numpy().tobytes() for t in vq_ids)).hexdigest()


def witness_gaps(out, witness_fn, parts, known=None):
    """Each run's distance from the float64 witness of its own ids (one
    witness per distinct sequence of ids): {run: {module: relative
    Frobenius norm of its Adam first moment's difference}}, and the number
    of witnesses used. `out[run]` has `grads` and `vq_ids`; `known` holds
    witnesses already computed ({`ids_key`: moments}), and `witness_fn`
    computes any other."""
    witness, used, gaps = dict(known or {}), set(), {}
    for name, o in out.items():
        key = ids_key(o.vq_ids)
        if key not in witness:
            witness[key] = witness_fn(o.vq_ids)
        used.add(key)
        w = witness[key]
        gaps[name] = {m: float((o.grads[m].double() - w[m]).norm() / w[m].norm())
                      for m, _ in parts}
    return gaps, len(used)


def witness_limits(gaps, minimum, cap):
    """The card's limit against the witness, per module: 5× the larger of
    the two CPU float32 steps' distances (`gaps["cpu"]`, oneDNN's
    convolutions; `gaps["cpu_native"]`, PyTorch's native ones), or
    `minimum`, at most `cap[module]`. Returns (floor, limit)."""
    floor = {m: max(gaps["cpu"][m], gaps["cpu_native"][m]) for m in gaps["cpu"]}
    return floor, {m: min(max(5 * f, minimum), cap[m]) for m, f in floor.items()}
