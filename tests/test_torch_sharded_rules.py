"""Every reverse-mode rule and option on a sharded state (parallel/sharded.py)
against the JAX package's unsharded gradients.

The flagship field (make_rd1d_field, K1/K2) at n = 1027 split over 4 gloo
ranks (tests/sharded_ranks.py, one group for the module) runs under the
rules and options that tests/test_torch_sharded.py leaves out
(`sharded_ranks.RULE_CASES`): QuadratureAdjoint and GaussKronrodAdjoint
with their tolerances and max_depth, checkpointing=True on Interpolating,
Gauss and GaussKronrod with `checkpoints=`, pinned_reverse and
pinned_fallback, Gauss's n_nodes, Backsolve's checkpointing and
recon_guard, DirectAdjoint's max_steps and remat=True, and unroll=True
(sensealg=None resolving to DirectAdjoint). The JAX tests' heat field
(tests/test_parallel.py:204) runs under QuadratureAdjoint and
GaussAdjoint(checkpointing=True) on the fixed grid's first 256 steps (its
torch.roll gathers the whole state, ~10 ms a step). Each sharded gradient
is held against JAX's unsharded one and the port's at 1e-10, with the
accepted steps, the reverse solve that ran and the field's evaluations
(so the Gauss–Kronrod panels and quadrature nodes) equal to the port's
unsharded run. The JAX flagship reference is the package's plain
`rd1d_reference` field, the function its Pallas kernel computes, whose
solves compile in seconds; for an unroll=True case it is JAX's while
driver, whose steps the masked scan takes inside its budget (the scan
emits every iteration straight-line, which takes JAX minutes to compile
at this size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_ranks as R
from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
from scimlsensitivity_jl_tpu.ops import pallas_pde as jpde
import scimlsensitivity_jl_tpu_torch as P

RTOL = 1e-10
GROUPS = (("rheat",), ("rule ",))


@pytest.fixture(scope="module")
def ranks():
    groups = R.RankGroups(GROUPS)
    yield groups
    groups.close()


@pytest.fixture(scope="module")
def jax_refs(ranks):
    """Every case's JAX gradient, computed once the ranks have started and
    before any test waits for them."""
    refs = {f"rule {label}": _jax_rule(label) for label in R.RULE_CASES}
    refs.update({f"rheat {label}": _jax_heat_rule(label)
                 for label in R.HEAT_RULES})
    return refs


def _close(got, ref, rtol=RTOL, what=""):
    """Relative to the largest entry of the reference."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"{what}: max error {err:.3e} > {rtol:g}"


def _check(got, gu_j, gp_j, gu_p, gp_p, sol_p):
    """The sharded case against JAX and the port's unsharded run."""
    assert got["sensealg"] == type(sol_p.sensealg).__name__
    assert got["stats"] == R._stats(sol_p.stats)
    assert got["field_calls"] == sol_p.field_calls
    if sol_p.adjoint is not None:
        assert got["adj"] == R._stats(sol_p.adjoint.stats)
        assert got["reverse"] == (sol_p.adjoint.reverse,
                                  sol_p.adjoint.resolves)
    assert got["ys_type"] == "DTensor" and got["gp_type"] == "Tensor"
    assert got["gu_placements"] == "(Shard(dim=0),)"
    _close(got["gu"], gu_j, what="u0-grad vs JAX")
    _close(got["gp"], gp_j, what="p-grad vs JAX")
    _close(got["gu"], R._np(gu_p), what="u0-grad vs the port unsharded")
    _close(got["gp"], R._np(gp_p), what="p-grad vs the port unsharded")


def _jax_rule(label):
    """JAX's unsharded gradient of Σ ys[-1]² through its plain flagship
    field under RULE_CASES[label]."""
    rule, opts, grid = R.RULE_CASES[label]
    n = R.RD_N
    inv_dx2 = float(n * n)

    def field(u, p, t):
        return jpde.rd1d_reference(u, p[0], p[1], inv_dx2)

    t1 = R.RD_STEPS * R.RD_DT
    # JAX builds a checkpoint grid from concrete save times, which jit
    # traces: its reference for `checkpoints=` is the same grid as save
    # times, the last one's rows in the loss (the same intervals re-solved)
    opts = dict(opts)
    saveat = [0.0, *opts.pop("checkpoints", ()), t1]
    if grid == "unroll":
        # unroll=True: sensealg=None is DirectAdjoint, and the scan's
        # reverse is not pinned
        rule = rule or "DirectAdjoint"
        if rule == "InterpolatingAdjoint":
            opts["pinned_reverse"] = False
    sensealg = None if rule is None else getattr(J, rule)(**opts)

    # unroll=True: JAX's masked scan emits every iteration straight-line
    # (minutes of compile for this field); inside its budget it takes the
    # while driver's steps, whose gradient is the reference
    kw = dict(R.rule_kwargs(grid), unroll=False)

    def loss(u0, p):
        sol = J.solve(J.ODEProblem(field, u0, (0.0, t1), p), J.Tsit5(),
                      saveat=jnp.asarray(saveat), sensealg=sensealg, **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    gu, gp = jax_o0(jax.grad(loss, argnums=(0, 1)),
                    jnp.asarray(R.rd_u0(n)), jnp.asarray(R.rd_p(n)))
    return np.asarray(gu), np.asarray(gp)


@pytest.mark.parametrize("label", list(R.RULE_CASES),
                         ids=[s.replace(" ", "-") for s in R.RULE_CASES])
def test_flagship_rule_matches_jax(ranks, jax_refs, label):
    """make_rd1d_field on 1027 cells over 4 ranks under one rule and its
    options (see the module docstring)."""
    gu_j, gp_j = jax_refs[f"rule {label}"]
    u0 = torch.from_numpy(R.rd_u0(R.RD_N)).requires_grad_()
    gu_p, gp_p, sol_p = R.rule_gradient(P, u0, label)
    rule, _, grid = R.RULE_CASES[label]
    if rule is None:
        assert type(sol_p.sensealg).__name__ == "DirectAdjoint"
    got = ranks[f"rule {label}"]
    print(f"{label}: steps {got['stats']}, reverse {got['adj']} "
          f"({got['reverse']}), field calls {got['field_calls']}, "
          f"{got['seconds']:.1f} s sharded")
    _check(got, gu_j, gp_j, gu_p, gp_p, sol_p)


def test_rule_cases_cover_every_option():
    """Each option that a sharded state used to refuse appears in a case."""
    opts = {(rule, key) for rule, o, _ in R.RULE_CASES.values()
            for key in o}
    grids = {grid for _, _, grid in R.RULE_CASES.values()}
    assert {("QuadratureAdjoint", "abstol"), ("QuadratureAdjoint", "reltol"),
            ("QuadratureAdjoint", "max_depth"),
            ("GaussKronrodAdjoint", "max_depth"),
            ("GaussKronrodAdjoint", "checkpointing"),
            ("GaussKronrodAdjoint", "pinned_reverse"),
            ("InterpolatingAdjoint", "checkpointing"),
            ("InterpolatingAdjoint", "checkpoints"),
            ("InterpolatingAdjoint", "pinned_reverse"),
            ("InterpolatingAdjoint", "pinned_fallback"),
            ("GaussAdjoint", "checkpointing"), ("GaussAdjoint", "n_nodes"),
            ("GaussAdjoint", "pinned_reverse"),
            ("BacksolveAdjoint", "checkpointing"),
            ("BacksolveAdjoint", "recon_guard"),
            ("DirectAdjoint", "max_steps"),
            ("DirectAdjoint", "remat")} <= opts
    assert grids == {"fixed", "adaptive", "unroll"}


def _jax_heat_rule(label):
    rule, opts = R.HEAT_RULES[label]
    scale = R.heat_scale()

    def heat(u, p, t):
        return p * scale * (jnp.roll(u, 1) + jnp.roll(u, -1) - 2.0 * u)

    def loss(p, u0):
        sol = J.solve(J.ODEProblem(heat, u0, (0.0, R.HEAT_DT * R.HEAT_STEPS),
                                   p), J.Tsit5(), dt=R.HEAT_DT,
                      adaptive=False, adj_rtol=1e-8, adj_atol=1e-10,
                      adj_max_steps=4096, sensealg=getattr(J, rule)(**opts))
        return jnp.sum(sol.ys[-1] ** 2)

    gp, gu = jax_o0(jax.grad(loss, argnums=(0, 1)), jnp.asarray(1.3),
                    jnp.asarray(R.heat_u0()))
    return np.asarray(gu), float(gp)


@pytest.mark.parametrize("label", list(R.HEAT_RULES),
                         ids=[s.replace(" ", "-") for s in R.HEAT_RULES])
def test_heat_rule_matches_jax(ranks, jax_refs, label):
    """test_parallel.py:204's heat problem on its first 256 steps over 4
    ranks under QuadratureAdjoint and GaussAdjoint(checkpointing=True)."""
    gu_j, gp_j = jax_refs[f"rheat {label}"]
    u0 = torch.from_numpy(R.heat_u0()).requires_grad_()
    gu_p, gp_p, sol_p = R.heat_rule_gradient(P, u0, label)
    got = ranks[f"rheat {label}"]
    print(f"heat {label}: reverse {got['adj']} ({got['reverse']}), field "
          f"calls {got['field_calls']}, {got['seconds']:.1f} s sharded")
    _check(got, gu_j, gp_j, gu_p, gp_p, sol_p)
