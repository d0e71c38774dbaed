"""Time derivatives through the port's stiff and extrapolation steppers,
against the JAX package in float64 on the CPU.

JAX traces t and dt through every stepper, so a step's start and length
carry derivatives: DirectAdjoint differentiates the length of each step
clipped to a save time (a saveat that is differentiated) and the event
time's θ, and ForwardDiffSensitivity carries the event time's tangent into
the steps after a continuous event (FBDF's history restarts there, every
slot carrying it). The port hands each stepper zero-valued offsets of its
start and length (`t_off`, `ddt`); FBDF's history slots carry theirs in
`FBDFState.t_off`.

The field is small, stiff (rate 20) and reads t, so the stage times'
derivatives matter: u0' = −20(u0 − (1 − 2t)) + u1, u1' = −0.7u1 + u0·t,
over (0, 0.6) at rtol 1e-3 from dt0 0.02 (10-50 steps a solve, since a
stiff step's forward mode costs tens of ms on a CPU), with saves at 0.15,
0.35 and 0.5 and, in the event cases, u0 ← u0 − 0.05 where u0 falls
through 0.5 (t ≈ 0.30): the event time's derivative then reaches the
steps up to the save at 0.35. Gradients in p, u0 and the save times equal
JAX's to 1e-8 relative (of the largest entry); JAX's references are
compiled at XLA optimization level 0 (`torch_parity.jax_o0`), one per
case, and most of the file's time is their tracing and compilation.
DirectAdjoint on FBDF is refused by both packages (JAX's masked scan takes
no multistep stepper).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.solvers.fbdf import HCAP

DT = torch.float64
P0 = np.array([20.0, 0.7, 1.0])
U0 = np.array([1.1, 0.1])
SV = np.array([0.15, 0.35, 0.5])
T1 = 0.6
KW = dict(rtol=1e-3, atol=1e-6, dt0=0.02, max_steps=160)
STEPPERS = ["Rosenbrock23", "TRBDF2", "Kvaerno3", "SDIRK4", "Seulex",
            "Rodas4Like", "Vern9Like", "FBDF"]
CASES = ["direct_saveat", "direct_event", "fd_event"]


def _stepper(mod, name):
    # Seulex at five levels, beside Rodas4Like's four
    return mod.Seulex(levels=5) if name == "Seulex" else getattr(mod, name)()


def _field(lib, as_t):
    def f(u, p, t):
        tt = as_t(t, u)
        return lib.stack([-p[0] * (u[0] - (1.0 - 2.0 * tt)) + p[2] * u[1],
                          -p[1] * u[1] + u[0] * tt])
    return f


def _callback(mod, lib):
    return mod.ContinuousCallback(
        condition=lambda u, p, t: u[0] - 0.5,
        affect=lambda u, p, t: lib.stack([u[0] - 0.05, u[1]]),
        direction=-1)


def _solve(mod, name, case, p, u0, sv):
    lib = jnp if mod is J else torch
    as_t = ((lambda t, u: t) if mod is J
            else (lambda t, u: torch.as_tensor(t, dtype=u.dtype)))
    sensealg = (mod.ForwardDiffSensitivity() if case == "fd_event"
                else mod.DirectAdjoint())
    cb = None if case == "direct_saveat" else _callback(mod, lib)
    sol = mod.solve(mod.ODEProblem(_field(lib, as_t), u0, (0.0, T1), p),
                    _stepper(mod, name), saveat=sv, sensealg=sensealg,
                    callback=cb, **KW)
    if mod is P and cb is not None:
        assert sol.events.count == 1
    return lib.sum(sol.ys[:, 0] ** 2) + 3.0 * lib.sum(sol.ys[:, 1] ** 2)


@functools.lru_cache(maxsize=None)
def jax_ref(name, case):
    return [np.asarray(g) for g in jax_o0(
        jax.grad(lambda p, u0, sv: _solve(J, name, case, p, u0, sv),
                 argnums=(0, 1, 2)),
        jnp.asarray(P0), jnp.asarray(U0), jnp.asarray(SV))]


def port_grads(name, case):
    args = [torch.tensor(a, dtype=DT, requires_grad=True)
            for a in (P0, U0, SV)]
    return torch.autograd.grad(_solve(P, name, case, *args), args)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", STEPPERS)
def test_time_derivatives_match_jax(name, case):
    """dL/dp, dL/du0 and dL/dsaveat through each stepper equal JAX's to
    1e-8; where JAX refuses the case (DirectAdjoint on FBDF), the port
    refuses it too."""
    if name == "FBDF" and case != "fd_event":
        with pytest.raises(NotImplementedError, match="multistep"):
            port_grads(name, case)
        with pytest.raises(NotImplementedError):
            jax_ref.__wrapped__(name, case)
        return
    got, ref = port_grads(name, case), jax_ref(name, case)
    for g, r, what in zip(got, ref, ("p", "u0", "saveat")):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-8,
                                   atol=1e-8 * np.abs(r).max(),
                                   err_msg=f"{name} {case} d/d{what}")


def _offsets():
    zero = torch.zeros((), dtype=DT)
    return dict(ddt=zero.clone(), t_off=zero.clone())


@pytest.mark.parametrize("name", STEPPERS)
def test_zero_offsets_leave_steps_bit_identical(name):
    """The offsets are zero-valued: with or without them each stepper's
    u1, f1 and err (and FBDF's state after the step) are bit-identical, at
    a step from a history of several steps for FBDF, its slots carrying
    offsets too."""
    f = _field(torch, lambda t, u: torch.as_tensor(t, dtype=u.dtype))
    p = torch.tensor(P0, dtype=DT)
    fvec = lambda u, t: f(u, p, t)
    stepper = _stepper(P, name)
    t, dt = np.float64(0.3), np.float64(0.0125)
    u = torch.tensor([0.7, -0.2], dtype=DT)
    f0 = fvec(u, t)
    if name != "FBDF":
        plain = stepper.step(fvec, t, dt, u, f0)
        carried = stepper.step(fvec, t, dt, u, f0, **_offsets())
        for a, b in zip(plain, carried):
            assert torch.equal(a, b.detach())
        return
    state = stepper.init_state(fvec, t, u, f0, np.float64(1e-5),
                               np.float64(1e-8))
    for _ in range(4):  # a history of five slots
        u, f0, _, state = stepper.step(fvec, t, dt, u, f0, state)
        t = np.float64(t + dt)
    plain = stepper.step(fvec, t, dt, u, f0, state)
    carried = stepper.step(fvec, t, dt, u, f0,
                           state._replace(t_off=torch.zeros(HCAP, dtype=DT)),
                           **_offsets())
    for a, b in zip(plain[:3], carried[:3]):
        assert torch.equal(a, b.detach())
    s0, s1 = plain[3], carried[3]
    assert np.array_equal(s0.t_hist, s1.t_hist)
    assert torch.equal(s0.u_hist, s1.u_hist.detach())
    assert (s0.n_hist, s0.k, s0.steps_at_k) == (s1.n_hist, s1.k,
                                                 s1.steps_at_k)
    assert s0.t_off is None and torch.equal(s1.t_off,
                                            torch.zeros(HCAP, dtype=DT))
