"""Data-parallel multi-window training (ROADMAP 15(ii)), its first and
second steps: two ranks of the port against the JAX package's
`parallel.data_parallel` of `make_multi_window_first_stage_step` and
`make_multi_window_second_stage_step` over two CPU devices on the
concatenated batch. The set-up, the widths and every tolerance are
`tests/test_torch_port_parallel_gan.py`'s (its module docstring); the joint
step is in `tests/test_torch_port_parallel_gan_joint.py`. Each JAX step is
compiled once, in the module fixture, while the ranks run.
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

KINDS = ("mw_first", "mw_second")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_mw_ranks")
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
