"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor tests/conftest.py's JAX set-up, so on a machine with a card and
without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops import rd1d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol,dp_tol", [(torch.float64, 1e-12, 1e-10),
                                              (torch.float32, 1e-5, 1e-5)])
def test_kernels_match_plain_versions(cuda, dtype, tol, dp_tol):
    """K1 and K2 at a ragged length (the masks) with the flagship
    inv_dx2 = n²; float32 sums run in another order than the plain
    version's, hence its looser tolerance."""
    n = 262147
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.rand(n, generator=gen, device=cuda, dtype=dtype)
    lam = torch.randn(n, generator=gen, device=cuda, dtype=dtype)
    p = torch.tensor([1e-7, 1.5], device=cuda, dtype=dtype)
    inv_dx2 = float(n) ** 2
    f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
    du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
    torch.cuda.synchronize()
    f_ref = rd1d.rd1d_reference(u, p, inv_dx2)
    du_ref, dp_ref = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam)
    assert float((f - f_ref).abs().max() / f_ref.abs().max()) <= tol
    assert float((du - du_ref).abs().max() / du_ref.abs().max()) <= tol
    assert float(((dp - dp_ref).abs() / dp_ref.abs()).max()) <= dp_tol
    # deterministic: no atomics in the reduction
    assert torch.equal(rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)[1], dp)


@pytest.mark.parametrize("sensealg", [None, P.DirectAdjoint()],
                         ids=["default_backsolve", "direct"])
def test_gradient_on_card_matches_cpu(cuda, sensealg):
    """The flagship gradient at n = 16384 (the smallest n that dispatches to
    BacksolveAdjoint), 16 steps, float64: the card, through K1 and K2,
    against the port's CPU run through the plain versions."""
    n, dt, t1 = 16384, 1e-9, 16e-9
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    grads = []
    for device in (cuda, "cpu"):
        x = torch.arange(n, dtype=torch.float64, device=device) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0).requires_grad_()
        p = torch.tensor([1e-7, 1.5], dtype=torch.float64,
                         device=device).requires_grad_()
        before = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                      saveat=[0.0, t1], dt=dt, adaptive=False,
                      sensealg=sensealg, adj_rtol=1e-3, adj_atol=1e-8)
        grads.append([g.cpu() for g in torch.autograd.grad(
            torch.sum(sol.ys[-1] ** 2), (u0, p))])
        after = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        assert sol.retcode == 0
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
        else:
            assert after == before
        if sensealg is None:
            assert isinstance(sol.sensealg, P.BacksolveAdjoint)
            assert sol.adjoint.stats.retcode == 0
    (gu_card, gp_card), (gu_cpu, gp_cpu) = grads
    rel = torch.linalg.vector_norm(gu_card - gu_cpu) / torch.linalg.vector_norm(gu_cpu)
    assert float(rel) <= 1e-9
    assert float(((gp_card - gp_cpu).abs() / gp_cpu.abs()).max()) <= 1e-9
