"""Parity of the port's digits model (models/digits.py) with the JAX
package's, in float64 on the CPU, and the port's profiling helpers
(utils/profile.py) and entry point (entry.py).

Both packages draw their data and weights from their own generators
(`jax.random` keys, `torch.Generator`s), which give different numbers, so
the port takes JAX's images, labels and weights through numpy: at batch 4
the logits, the loss and its gradient in every weight equal JAX's to 1e-9
(BacksolveAdjoint(checkpointing=True), Tsit5 at rtol 1e-3, one adaptive
solve per image in both: JAX vmaps them, the port loops). JAX's reference
is compiled at XLA level 0 (`torch_parity.jax_o0`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.models import digits as jd
from scimlsensitivity_jl_tpu_torch.models import digits as pd
from scimlsensitivity_jl_tpu_torch.utils import profile

DT = torch.float64
BATCH = 4


def _params_to_port(params):
    return {k: {kk: torch.tensor(np.asarray(v), dtype=DT)
                for kk, v in d.items()} for k, d in params.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's batch (synthetic_digits(PRNGKey(0))), weights
    (digits_node_init(PRNGKey(1)) in float64), logits, loss and its
    gradient."""
    x, y = jd.synthetic_digits(jax.random.PRNGKey(0), n=BATCH,
                               dtype=jnp.float64)
    params = jd.digits_node_init(jax.random.PRNGKey(1), dtype=jnp.float64)
    _, loss_fn = jd.make_digits_train_step(None)

    def run(params, x, y):
        logits = jax.vmap(lambda xx: jd.digits_node_apply(params, xx))(x)
        loss, grad = jax.value_and_grad(loss_fn)(params, x, y)
        return logits, loss, grad

    logits, loss, grad = jax_o0(run, params, x, y)
    return dict(x=np.asarray(x), y=np.asarray(y), params=params,
                logits=np.asarray(logits), loss=float(loss), grad=grad)


def test_digits_forward_and_gradient_match_jax(jax_ref):
    """Logits (one image and the batch), loss and gradient against JAX's
    to 1e-9 relative."""
    params = _params_to_port(jax_ref["params"])
    leaves = [v.requires_grad_() for d in params.values() for v in d.values()]
    x = torch.tensor(jax_ref["x"], dtype=DT)
    y = torch.tensor(jax_ref["y"])
    logits = pd.digits_node_apply(params, x)
    np.testing.assert_allclose(logits.detach().numpy(), jax_ref["logits"],
                               rtol=1e-9, atol=1e-12)
    one = pd.digits_node_apply(params, x[1])
    np.testing.assert_allclose(one.detach().numpy(), jax_ref["logits"][1],
                               rtol=1e-9, atol=1e-12)
    _, loss_fn = pd.make_digits_train_step(None)
    loss = loss_fn(params, x, y)
    assert abs(float(loss.detach()) - jax_ref["loss"]) <= 1e-9 * abs(
        jax_ref["loss"])
    grads = torch.autograd.grad(loss, leaves)
    names = [(k, kk) for k, d in params.items() for kk in d]
    for (k, kk), g in zip(names, grads):
        ref = np.asarray(jax_ref["grad"][k][kk])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(),
                                   err_msg=f"{k}.{kk}")


def test_train_step_and_synthetic_digits():
    """synthetic_digits: shapes, labels in 0-9, the same arrays from the
    same seed, noise-free images that are shifted smooth prototypes of
    unit spread; one Adam step through make_digits_train_step returns the
    loss before it and moves every weight."""
    x, y = pd.synthetic_digits(torch.Generator().manual_seed(0), n=6,
                               dtype=DT, device="cpu")
    x2, y2 = pd.synthetic_digits(torch.Generator().manual_seed(0), n=6,
                                 dtype=DT, device="cpu")
    assert x.shape == (6, 64) and y.shape == (6,)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert int(y.min()) >= 0 and int(y.max()) <= 9
    clean, _ = pd.synthetic_digits(torch.Generator().manual_seed(0), n=6,
                                   noise=0.0, dtype=DT, device="cpu")
    spread = clean.reshape(6, 8, 8).std(dim=(1, 2), correction=0)
    np.testing.assert_allclose(spread.numpy(), 1.0, rtol=1e-12)

    params = pd.digits_node_init(torch.Generator().manual_seed(1), dtype=DT,
                                 device="cpu")
    leaves = [v.requires_grad_() for d in params.values() for v in d.values()]
    before = [v.detach().clone() for v in leaves]
    opt = torch.optim.Adam(leaves, lr=3e-3)
    step, loss_fn = pd.make_digits_train_step(opt)
    with torch.no_grad():
        want = float(loss_fn(params, x[:2], y[:2]))
    loss = step(params, x[:2], y[:2])
    assert abs(float(loss) - want) <= 1e-12 * abs(want)
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))


def test_profile_helpers():
    """trace (torch.profiler, a Chrome trace in its directory; on the CPU
    no device time, so the idle share is 1), timed (the block's seconds)
    and solve_stats (the solution's counters)."""
    prob = P.ODEProblem(lambda u, p, t: -p * u, torch.tensor([1.0], dtype=DT),
                        (0.0, 1.0), torch.tensor(1.0, dtype=DT))
    with profile.trace() as tr:
        sol = P.solve(prob, P.Tsit5())
    assert tr.wall_ms > 0 and tr.device_ms() == 0.0
    assert tr.idle_share() == 1.0
    assert os.path.exists(os.path.join(tr.logdir, "trace.json"))
    with profile.timed("solve") as out:
        P.solve(prob, P.Tsit5())
    assert out["label"] == "solve" and out["seconds"] > 0
    stats = profile.solve_stats(sol)
    assert stats["retcode"] == 0 and stats["n_accepted"] == sol.stats.n_accepted
    assert stats["n_fevals"] == sol.stats.n_fevals
    assert stats["sensealg"] == repr(sol.sensealg)


def test_entry_on_cpu():
    """entry("cpu"): the spiral's gradient step (2→50→2 on u³, Backsolve,
    float32) gives a finite loss and a finite gradient for every weight."""
    from scimlsensitivity_jl_tpu_torch.entry import entry

    fn, (params, data) = entry("cpu")
    loss, grads = fn(params, data)
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert set(grads) == set(params)
    for k, g in grads.items():
        assert g.shape == params[k].shape and torch.isfinite(g).all()
