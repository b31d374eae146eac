"""Data-parallel multi-window training (ROADMAP 15(ii)), the joint step:
two ranks of the port against the JAX package's `parallel.data_parallel`
of `make_joint_step` over two CPU devices on the concatenated batch
(encoder, decoder and discriminator in one step; the encoder's and
decoder's gradients, the VQ statistics, the SPADE BatchNorms, the
discriminator's gradients summed over the windows and then averaged once,
its buffers and the metrics over the ranks). The set-up, the widths and
every tolerance are `tests/test_torch_port_parallel_gan.py`'s (its module
docstring). The JAX step is compiled once, in the module fixture, while
the ranks run (a few minutes on one core, as the single-process joint
test's).
"""

from types import SimpleNamespace

import pytest

from test_torch_port_parallel_gan import (
    case_id,
    check_step,
    jax_steps,
    start_gan_ranks,
    step_cases,
)

KINDS = ("joint",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_joint_ranks")
    steps, setups, image = start_gan_ranks(root, KINDS)
    try:
        jax_out = jax_steps(setups, image)
    except BaseException:
        steps.kill()
        raise
    return SimpleNamespace(steps=steps, jax_steps=jax_out)


@pytest.mark.parametrize("case", step_cases(KINDS), ids=case_id)
def test_step_matches_jax_data_parallel(ranks, case):
    kind, what, name = case
    check_step([out[kind] for out in ranks.steps.results()], ranks.jax_steps[kind], kind,
               what, name)
