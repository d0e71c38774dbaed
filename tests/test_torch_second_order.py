"""Parity of the port's second-order sensitivities with the JAX package's,
in float64 on the CPU, at the setting of tests/test_interface.py:98-170
(Lotka–Volterra on (0, 3), 4 save times, the loss Σ ys² in p), but at
rtol 1e-7 and atol 1e-9 where the JAX test takes 1e-9 and 1e-11: one
Hessian row is one more reverse pass, and the tier-1 clock is short.

The port differentiates the gradient again by reverse mode, JAX by
forward mode (jacfwd over its gradient program); both hold step sizes
constant. DirectAdjoint is the same discrete program in both, so the
Hessians agree to 1e-9 (JAX compiled at XLA optimization level 0,
`torch_parity.jax_o0`, takes the port's steps). The continuous rules
differentiate different programs of the same Hessian (JAX its explicit
Gauss-hook program, the port the rule's backward, whose second pass runs
the continuous adjoint of the forward once more), which agree to the
solver tolerance: 2e-5 relative to max|H| (measured 2.9e-6; the port's H
is JAX's transposed to that tolerance, and 3e-8 apart at rtol 1e-9).
JAX's own test holds its continuous Hessian to its discrete one at
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, lotka_volterra_jax, lotka_volterra_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

LV_P = np.array([1.5, 1.0, 3.0, 1.0])
LV_U0 = np.array([1.0, 1.0])
TS = np.linspace(0.0, 3.0, 4)
KW = dict(rtol=1e-7, atol=1e-9, max_steps=1024)
V = np.array([1.0, -0.5, 0.25, 0.1])
DIRECT_RTOL = 1e-9
CONTINUOUS_RTOL = 2e-5
DT = torch.float64


def _close(got, ref, rtol, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=msg)


@pytest.fixture(scope="module")
def jax_hessians():
    """JAX's Hessians under DirectAdjoint and GaussAdjoint (its
    InterpolatingAdjoint runs the same Gauss-hook program)."""
    def run(u0, p):
        prob = J.ODEProblem(lotka_volterra_jax, u0, (0.0, 3.0), p)
        loss = lambda sol: jnp.sum(sol.ys ** 2)
        return {name: J.second_order_sensitivities(
            loss, prob, J.Tsit5(), sensealg=getattr(J, name)(),
            saveat=jnp.asarray(TS), **KW)
            for name in ("DirectAdjoint", "GaussAdjoint")}

    return jax_o0(run, jnp.asarray(LV_U0), jnp.asarray(LV_P))


def _prob(field=lotka_volterra_port):
    return P.ODEProblem(field, torch.tensor(LV_U0, dtype=DT), (0.0, 3.0),
                        torch.tensor(LV_P, dtype=DT))


def _loss(sol):
    return torch.sum(sol.ys ** 2)


@pytest.mark.parametrize("sensealg,ref,rtol", [
    ("DirectAdjoint", "DirectAdjoint", DIRECT_RTOL),
    ("InterpolatingAdjoint", "GaussAdjoint", CONTINUOUS_RTOL)])
def test_hessian_and_product_match_jax(jax_hessians, sensealg, ref, rtol):
    """H against JAX's (DirectAdjoint to 1e-9, InterpolatingAdjoint against
    JAX's continuous program to 2e-5), symmetric to the same tolerance, and
    H·v from second_order_sensitivity_product equal to H @ v to the same
    tolerance (it is one reverse pass, (∂g/∂p)ᵀv, the transpose's
    product, which the symmetry makes H·v)."""
    alg = getattr(P, sensealg)()
    H = P.second_order_sensitivities(_loss, _prob(), P.Tsit5(), sensealg=alg,
                                     saveat=TS, **KW)
    assert H.shape == (4, 4)
    _close(H, jax_hessians[ref], rtol, sensealg)
    _close(H, H.T.numpy(), rtol, sensealg)
    hv = P.second_order_sensitivity_product(_loss, _prob(), V, P.Tsit5(),
                                            sensealg=alg, saveat=TS, **KW)
    _close(hv, (H @ torch.tensor(V, dtype=DT)).numpy(), rtol, sensealg)


def test_forwarddiff_over_adjoint_product_matches_jax(jax_hessians):
    """ForwardDiffOverAdjoint(adjalg) runs the rule it wraps (JAX
    `_unwrap_fdoa`): its H·v against JAX's continuous Hessian times v, to
    2e-5; the wrapper without an argument takes GaussAdjoint."""
    from scimlsensitivity_jl_tpu_torch.adjoints.second_order import (
        _unwrap_fdoa)

    assert isinstance(_unwrap_fdoa(P.ForwardDiffOverAdjoint()),
                      P.GaussAdjoint)
    hv = P.second_order_sensitivity_product(
        _loss, _prob(), V, P.Tsit5(), sensealg=P.ForwardDiffOverAdjoint(P.InterpolatingAdjoint()),
        saveat=TS, **KW)
    _close(hv, np.asarray(jax_hessians["GaussAdjoint"]) @ V, CONTINUOUS_RTOL)


@pytest.mark.parametrize("sensealg", ["GaussKronrodAdjoint",
                                      "QuadratureAdjoint"])
def test_quadrature_rules_refused_as_in_jax(sensealg):
    """Their quadrature controls would not steer a Hessian: both packages
    raise NotImplementedError."""
    for mod, prob in ((P, _prob()), (J, J.ODEProblem(
            lotka_volterra_jax, jnp.asarray(LV_U0), (0.0, 3.0),
            jnp.asarray(LV_P)))):
        with pytest.raises(NotImplementedError, match=sensealg):
            mod.second_order_sensitivities(
                lambda sol: sol.ys.sum(), prob, mod.Tsit5(),
                sensealg=getattr(mod, sensealg)(), saveat=TS)


@pytest.mark.parametrize("field", ["rd1d", "mlp"])
def test_kernel_field_refuses_second_order(field):
    """Through a kernel field (fused_rd1d, fused_mlp2) the second pass
    raises DoubleBackwardUnsupported naming the Function, on the CPU's
    plain versions as on the card: the pullback operators register a
    backward that refuses. JAX refuses too: its custom_vjp kernels have no
    jvp rule, so jacfwd over their gradient raises (its error names
    custom_vjp, not the kernel)."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2
    from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field
    from scimlsensitivity_jl_tpu_torch.ops.vjp import DoubleBackwardUnsupported

    if field == "rd1d":
        n = 64
        x = torch.arange(n, dtype=DT) / n
        prob = P.ODEProblem(make_rd1d_field(n, 1.0 / n),
                            torch.exp(-((x - 0.5) ** 2) * 100.0), (0.0, 1e-4),
                            torch.tensor([1e-3, 1.5], dtype=DT))
        kw = dict(saveat=[0.0, 1e-4], sensealg=P.GaussAdjoint(), rtol=1e-6)
        name = "FusedRD1D"
    else:
        gen = torch.Generator().manual_seed(0)
        params = P.mlp_init(gen, (2, 8, 2), DT, device="cpu")
        prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u ** 3),
                            torch.tensor([2.0, 0.0], dtype=DT), (0.0, 0.3),
                            params)
        kw = dict(saveat=[0.0, 0.3], sensealg=P.DirectAdjoint(), rtol=1e-6)
        name = "FusedMLP2"
    with pytest.raises(DoubleBackwardUnsupported, match=name):
        P.second_order_sensitivity_product(
            _loss, prob, torch.ones(sum(
                v.numel() for v in (params.values() if field == "mlp"
                                    else [prob.p])), dtype=DT),
            P.Tsit5(), **kw)
