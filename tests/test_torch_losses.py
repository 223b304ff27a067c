"""The port's losses and NT-Xent kernel wrappers against the JAX package.

Inputs come from numpy; JAX runs on the CPU, its Pallas NT-Xent kernel in
interpret mode, and the port on the CPU, where each kernel wrapper runs
its plain version. Everything is float32. Tolerance rtol 1e-5, atol 1e-6:
both sides do the same float32 arithmetic and differ only in summation
order, a few ulps on values of order 1 (losses) and 1e-3 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu.ops import losses as jl
from simclr_tpu.ops.pallas import ntxent as jk
from simclr_tpu_torch.ops import losses as tl
from simclr_tpu_torch.ops.kernels import ntxent as tk

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(16, 32), (16, 128), (40, 32), (40, 128)]  # (2N, D)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module: under the tier-1 run's six
    workers an 8-thread pool for small tensors costs more than it
    gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(n2, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n2, d)) * scale).astype(np.float32)
    return z[: n2 // 2], z[n2 // 2:]


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("temperature", [0.5, 0.1])
@pytest.mark.parametrize("normalize", [True, False])
def test_nt_xent_loss_matches_jax(temperature, normalize):
    z1, z2 = _pair(24, 32, seed=1, scale=0.3)
    jloss, jacc = jl.nt_xent_loss(jnp.asarray(z1), jnp.asarray(z2),
                                  temperature, normalize)
    tloss, tacc = tl.nt_xent_loss(torch.from_numpy(z1), torch.from_numpy(z2),
                                  temperature, normalize)
    _close(tloss, jloss)
    _close(tacc, jacc)


def test_nt_xent_logits_layout_matches_jax():
    z1, z2 = _pair(12, 16, seed=2)
    jlog, jlab = jl.nt_xent_logits(jnp.asarray(z1), jnp.asarray(z2), 0.5)
    tlog, tlab = tl.nt_xent_logits(torch.from_numpy(z1),
                                   torch.from_numpy(z2), 0.5)
    _close(tlog, jlog)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((20, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 20).astype(np.int32)
    weight = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    j = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(weight))
    t = tl.cross_entropy(torch.from_numpy(logits),
                         torch.from_numpy(labels).long(),
                         torch.from_numpy(weight))
    _close(t, j)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_modified_contrastive_loss_matches_jax(temperature):
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((10, 16)).astype(np.float32) * 3
    x2 = rng.standard_normal((10, 16)).astype(np.float32) * 3
    jloss, jacc = jl.modified_contrastive_loss(
        jnp.asarray(x1), jnp.asarray(x2), temperature)
    tloss, tacc = tl.modified_contrastive_loss(
        torch.from_numpy(x1), torch.from_numpy(x2), temperature)
    _close(tloss, jloss)
    _close(tacc, jacc)


def test_softplus_beta_linear_tail_matches_jax():
    x = np.linspace(-40, 40, 81).astype(np.float32)
    _close(tl.softplus_beta(torch.from_numpy(x), 0.8),
           jl.softplus_beta(jnp.asarray(x), 0.8))


@pytest.mark.parametrize("n2,d", SHAPES)
def test_kernel_forward_rows_match_pallas(n2, d):
    """Per-row loss, correctness and lse of the wrapper's plain path
    against the Pallas forward kernel itself."""
    z1, z2 = _pair(n2, d, seed=n2 + d)
    z = np.concatenate([z1, z2])
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    inv_t = 2.0
    jloss, jcorr, jlse = jk._pallas_fwd(
        jnp.asarray(z), jnp.full((1,), inv_t, jnp.float32), interpret=True)
    tloss, tcorr, tlse = tk.ntxent_fwd(torch.from_numpy(z), inv_t)
    _close(tloss, np.asarray(jloss)[:, 0])
    _close(tlse, np.asarray(jlse)[:, 0])
    np.testing.assert_array_equal(tcorr.numpy(), np.asarray(jcorr)[:, 0])


@pytest.mark.parametrize("n2,d", SHAPES)
def test_kernel_backward_matches_pallas(n2, d):
    z1, z2 = _pair(n2, d, seed=7 * n2 + d)
    z = np.concatenate([z1, z2])
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    inv_t = 2.0
    _, _, jlse = jk._pallas_fwd(
        jnp.asarray(z), jnp.full((1,), inv_t, jnp.float32), interpret=True)
    g = np.array([0.7], np.float32)
    jdz = jk._pallas_bwd(jnp.asarray(z), jlse,
                         jnp.full((1,), inv_t, jnp.float32), jnp.asarray(g),
                         interpret=True)
    tdz = tk.ntxent_bwd(torch.from_numpy(z),
                        torch.from_numpy(np.asarray(jlse)[:, 0].copy()),
                        inv_t, torch.from_numpy(g))
    _close(tdz, jdz)


@pytest.mark.parametrize("n2,d", SHAPES)
def test_fused_loss_and_grad_match_pallas(n2, d):
    """The autograd wrapper (plain path on the CPU) against
    nt_xent_loss_pallas and jax.grad of it, unnormalised inputs."""
    z1, z2 = _pair(n2, d, seed=3 * n2 + d, scale=0.5)

    def jloss(a, b):
        return jk.nt_xent_loss_pallas(a, b, 0.5, interpret=True)

    (jl_val, jacc), (jg1, jg2) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z1),
                                             jnp.asarray(z2))
    t1 = torch.from_numpy(z1).requires_grad_()
    t2 = torch.from_numpy(z2).requires_grad_()
    tl_val, tacc = tk.nt_xent_loss_fused(t1, t2, 0.5)
    tl_val.backward()
    _close(tl_val.detach(), jl_val)
    _close(tacc, jacc)
    _close(t1.grad, jg1)
    _close(t2.grad, jg2)
    assert not tacc.requires_grad


def test_fused_loss_matches_plain_loss():
    z1, z2 = _pair(40, 128, seed=11)
    a = tk.nt_xent_loss_fused(torch.from_numpy(z1), torch.from_numpy(z2),
                              0.5)
    b = tl.nt_xent_loss(torch.from_numpy(z1), torch.from_numpy(z2), 0.5)
    _close(a[0], b[0])
    _close(a[1], b[1])


def test_tied_positive_counts_as_correct():
    """A negative equal to the positive ties it: >= counts the row
    correct, on both sides."""
    z = np.tile(np.eye(4, 8, dtype=np.float32), (2, 1))  # row i+4 == row i
    z[2] = z[0]  # rows 0 and 4 now see a negative tied with the positive
    jloss, jcorr, _ = jk._pallas_fwd(
        jnp.asarray(z), jnp.full((1,), 2.0, jnp.float32), interpret=True)
    tloss, tcorr, _ = tk.ntxent_fwd(torch.from_numpy(z), 2.0)
    np.testing.assert_array_equal(tcorr.numpy(), np.asarray(jcorr)[:, 0])
    assert tcorr[0] == 1 and tcorr[4] == 1 and tcorr[2] == 0
    _close(tloss, np.asarray(jloss)[:, 0])


@pytest.mark.parametrize("n,d,ok", [
    (512, 128, True), (1024, 128, True), (100, 128, True), (1, 1, True),
    (512, 2048, True), (512, 2049, False), (0, 128, False), (4, 0, False),
])
def test_supports_states_the_kernel_limits(n, d, ok):
    assert tk.supports(n, d) is ok


def test_wrappers_count_no_launch_on_cpu():
    before = (tk.ntxent_fwd.launches, tk.ntxent_bwd.launches)
    z1, z2 = _pair(16, 32)
    t1 = torch.from_numpy(z1).requires_grad_()
    loss, _ = tk.nt_xent_loss_fused(t1, torch.from_numpy(z2), 0.5)
    loss.backward()
    assert (tk.ntxent_fwd.launches, tk.ntxent_bwd.launches) == before
