"""The multi-window joint step, port vs JAX package, on the CPU at small
size, and the port's own memory and remat paths held to its plain step.

`train/multi_window.py::make_joint_step` against
`medical_image_editing_tpu/train/multi_window.py::make_joint_step` on the
joint config as shipped (`configs/lung_multiwindow_joint.json`: its
augmentation, losses, window weights and three Adams), with the sizes,
weights, codebook, draws and tolerances of
`tests/test_torch_port_multi_window.py` (its module docstring): losses
rtol 1e-4; gradients through Adam's first moment and the one-step
deltas of encoder, decoder and discriminator within 5× the port's own
f32 rounding floor or 1e-4; spectral-norm vectors,
BatchNorm stats and the VQ state after the step. The JAX step is compiled
once (module fixture; ~4 minutes on one core). Readings on this suite's
CPU host (the floor run's in brackets): losses ≤ 2.4e-6 relative;
gradients encoder 0.207 (0.212), decoder 1.3e-5 (9.1e-3), discriminator
1.1e-6 (1.8e-7); updates off by more than 1e-3·lr: encoder 6.9% (7.1%),
decoder 0.20% (0.52%), discriminator 0.0008% (0.0008%).

Port only:
* the discriminator pass's per-window backward against one backward of
  the summed loss: the same forwards, so the losses are bit-identical; the
  gradients differ only in f32 summation order, held to rtol 1e-6
  (relative Frobenius norm of Adam's first moment; measured: encoder and
  decoder 0, discriminator 1.2e-7).
* `use_remat` against the plain step: the losses rtol 2e-5 and the
  parameters rtol 1e-5, atol 1e-7 (the JAX package's own remat test,
  `tests/test_train_multi_window.py:100-122`), the spectral-norm vectors
  and Adam's first moments to the same limits (measured bit-identical);
  and a planted naive checkpoint, whose recompute advances the vectors a
  second time, must leave those limits (measured: the discriminator's
  parameters 9.9e-5 apart, the encoder's and decoder's 2.0e-2, against
  1e-5).
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from medical_image_editing_tpu_torch.train import multi_window as tmw
from test_torch_port_multi_window import (
    JOINT_METRICS,
    MODULES,
    check_buffers,
    delta_error,
    deltas_within,
    images,
    jax_init,
    limit,
    make_case,
    metric_within,
    moment_error,
    port_moments,
    port_state,
    port_step,
    run_port,
)

REMAT_RTOL = dict(metrics=2e-5, params=1e-5, params_atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    return make_case(jax_init(), "joint")


@pytest.mark.parametrize("name", JOINT_METRICS)
def test_joint_step_losses_match_jax(case, name):
    assert set(case.port.metrics) == set(case.jm) == set(JOINT_METRICS)
    assert metric_within(case, name, case.port.metrics), (
        name, case.port.metrics[name], case.jm[name])


@pytest.mark.parametrize("part", MODULES["joint"])
def test_joint_step_gradients_match_jax(case, part):
    err, floor = moment_error(case, part)
    assert err <= limit(floor), (part, err, floor)


@pytest.mark.parametrize("part", MODULES["joint"])
def test_joint_step_parameter_deltas_match_jax(case, part):
    assert deltas_within(case, part), (part, delta_error(case, part))


def test_joint_step_buffers_match_jax(case):
    """Spectral-norm vectors after 24 training forwards in the JAX order,
    the decoder's BatchNorm stats chained view 1 → view 2, the VQ EMA
    chained the same way."""
    check_buffers(case)
    assert case.port.state.step == 1


def _variant(case, **kw):
    return run_port(case.s0, "joint", case.image, case.draws, **kw)


def _state_gap(a, b):
    """Largest relative difference between two port runs: per module,
    parameters (with atol), spectral-norm vectors, Adam's first moments."""
    gap = {}
    for part in MODULES["joint"]:
        sa = getattr(a.state, part).state_dict()
        sb = getattr(b.state, part).state_dict()
        gap[part] = max(float((sa[k] - sb[k]).abs().max()
                              / (REMAT_RTOL["params_atol"] / REMAT_RTOL["params"]
                                 + sa[k].abs().max())) for k in sa)
        gap[f"{part}_moments"] = float((port_moments(a, part) - port_moments(b, part)).norm()
                                       / port_moments(a, part).norm())
    return gap


def _within_remat_limits(plain, other):
    metrics_ok = all(abs(other.metrics[k] - v) <= REMAT_RTOL["metrics"] * abs(v)
                     for k, v in plain.metrics.items())
    gap = _state_gap(plain, other)
    return metrics_ok and all(v <= REMAT_RTOL["params"] for v in gap.values()), gap


def test_per_window_backward_equals_one_backward(case):
    """The default path backpropagates each window's discriminator loss on
    its own; one backward of the summed loss gives the same step."""
    once = _variant(case, per_window_backward=False)
    assert once.metrics == case.port.metrics
    for part in MODULES["joint"]:
        a, b = port_moments(case.port, part), port_moments(once, part)
        assert float((a - b).norm() / b.norm()) <= 1e-6, part
    u = {k: v for k, v in case.port.state.discriminator.state_dict().items()
         if k.endswith(("u0", "sv0"))}
    for k, v in once.state.discriminator.state_dict().items():
        if k in u:
            assert torch.equal(v, u[k]), k


@pytest.fixture(scope="module")
def remat(case):
    return _variant(case, use_remat=True)


def test_remat_matches_plain(case, remat):
    ok, gap = _within_remat_limits(case.port, remat)
    assert ok, gap
    assert remat.state.discriminator.training


def _naive_checkpointed(dis):
    return lambda x: checkpoint(dis, x, use_reentrant=False)


def test_naive_checkpoint_is_caught(case, monkeypatch):
    """A checkpoint whose recompute starts from the advanced spectral-norm
    vectors (and advances them again) leaves the remat limits: its
    vectors, gradients and updates differ from the plain step's."""
    monkeypatch.setattr(tmw, "_checkpointed", _naive_checkpointed)
    naive = _variant(case, use_remat=True)
    ok, gap = _within_remat_limits(case.port, naive)
    assert not ok, gap
    assert gap["discriminator"] > REMAT_RTOL["params"]


def test_joint_step_draws_from_the_state_generator(case):
    """Without draws the joint step takes both views' augmentation draws
    and one (box, invert) per window from `state.generator`: two states
    seeded alike step alike, and the generator moves."""
    results = []
    for _ in range(2):
        cfg, state = port_state(case.s0, "joint")
        g0 = state.generator.get_state().clone()
        _, metrics = port_step(cfg, state, "joint")(state, images())
        assert not torch.equal(g0, state.generator.get_state())
        results.append({k: float(v) for k, v in metrics.items()})
    assert results[0] == results[1]
    assert set(results[0]) == set(JOINT_METRICS)
    assert all(np.isfinite(v) for v in results[0].values())
