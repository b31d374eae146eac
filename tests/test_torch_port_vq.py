"""Port VQ (plain path, fused wrapper and its plain version) vs the JAX
package's `ops/vq.py` and `ops/vq_pallas.py` (the Pallas kernel runs in
interpret mode on the CPU, as the JAX package's own tests run it).

The CUDA kernel is held to its plain version on the card by
`test_torch_port_gpu.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.ops import vq as jvq
from medical_image_editing_tpu.ops import vq_pallas as jvqp
from medical_image_editing_tpu_torch.ops import vq as tvq
from medical_image_editing_tpu_torch.ops import vq_fused as tvqf


def _inputs(n, c, k, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(n, c)).astype(np.float32)
    embed = rng.normal(size=(k, c)).astype(np.float32)
    return flat, embed


@pytest.mark.parametrize("n,c,k", [(512, 16, 10), (128, 96, 12), (100, 16, 10)])
def test_fused_reference_matches_pallas(n, c, k):
    flat, embed = _inputs(n, c, k)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(a) for a in jvqp.vq_assign_fused(jnp.asarray(embed),
                                                           jnp.asarray(flat))]
    for fn in (tvqf.vq_assign_fused_reference, tvqf.vq_assign_fused):
        ids, quant, counts, sums = (t.numpy() for t in fn(torch.from_numpy(embed),
                                                          torch.from_numpy(flat)))
        assert ids.dtype == np.int32 and ids.shape == (n,)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_allclose(quant, want[1], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(counts, want[2])
        np.testing.assert_allclose(sums, want[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("train", [True, False])
def test_vq_apply_matches_jax(backend, train):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    embed = rng.normal(size=(10, 16)).astype(np.float32)
    size = rng.uniform(0, 50, size=10).astype(np.float32)
    avg = rng.normal(size=(10, 16)).astype(np.float32)
    jstate = jvq.VQState(jnp.asarray(embed), jnp.asarray(size), jnp.asarray(avg))
    tstate = tvq.VQState(torch.from_numpy(embed), torch.from_numpy(size),
                         torch.from_numpy(avg))
    with jax.default_matmul_precision("highest"):
        jq, jc, jids, js = jvq.vq_apply(jstate, jnp.asarray(x), momentum=0.9,
                                        train=train, backend=backend)
    tq, tc, tids, ts = tvq.vq_apply(tstate, torch.from_numpy(x), momentum=0.9,
                                    train=train, backend=backend)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for got, want in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if not train:
        assert ts is tstate


def test_vq_fused_refuses_unknown_device_and_backend():
    flat, embed = _inputs(8, 4, 3)
    with pytest.raises(ValueError, match="no kernel"):
        tvqf.vq_assign_fused(torch.from_numpy(embed).to("meta"),
                             torch.from_numpy(flat).to("meta"))
    state = tvq.VQState(torch.from_numpy(embed), torch.zeros(3), torch.from_numpy(embed))
    with pytest.raises(ValueError, match="knn_backend"):
        tvq.vq_apply(state, torch.zeros(1, 2, 4, 4), backend="cuda-faiss")



@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_vq_apply_gradients_match_jax(backend):
    """The commit loss and the straight-through estimator carry gradient to
    the features on both routes, as in JAX: d/dx of commit + Σ q·cot is
    2(x − q)/N + cot."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    embed = rng.normal(size=(10, 16)).astype(np.float32)
    state = (embed, np.zeros(10, np.float32), embed)

    def jloss(xx):
        q, commit, _, _ = jvq.vq_apply(jvq.VQState(*map(jnp.asarray, state)), xx,
                                       momentum=0.9, train=True, backend=backend)
        return commit + jnp.sum(q * cot)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    q, commit, _, _ = tvq.vq_apply(tvq.VQState(*map(torch.from_numpy, state)), xt,
                                   momentum=0.9, train=True, backend=backend)
    (commit + (q * torch.from_numpy(cot)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6, rtol=0)
    assert np.abs(want - cot).max() > 1e-3  # the commit term is in it
