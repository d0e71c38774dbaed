"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor tests/conftest.py's JAX set-up, so on a machine with a card and
without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops import mlp, rd1d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (n, u's offset, λ's offset) in elements into a larger buffer: the ragged
# length, tiny n (no whole 16-byte vector, or one and a tail), the PDE's
# larger n, u and λ both off 16-byte alignment (a scalar head, then vectors)
# and λ off u's alignment (the kernel's single-cell instantiation)
RD1D_CASES = [(262147, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0), (5, 0, 0),
              (33, 0, 0), (1048576, 0, 0), (262144, 1, 1), (262144, 0, 1)]


def _rd1d_case(cuda, dtype, n, u_off, lam_off, seed=0):
    """Seeded u ∈ [0, 1) and λ ~ N(0, 1), each a contiguous view at the
    given element offset into a buffer of n + 1 values."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.rand(n + 1, generator=gen, device=cuda, dtype=dtype)
    lam = torch.randn(n + 1, generator=gen, device=cuda, dtype=dtype)
    return u[u_off:u_off + n], lam[lam_off:lam_off + n]


@pytest.mark.parametrize("n,u_off,lam_off", RD1D_CASES,
                         ids=[f"n{n}-u{a}-lam{b}" for n, a, b in RD1D_CASES])
@pytest.mark.parametrize("dtype,tol,dp_tol", [(torch.float64, 1e-12, 1e-10),
                                              (torch.float32, 1e-5, 1e-5)])
def test_kernels_match_plain_versions(cuda, dtype, tol, dp_tol, n, u_off,
                                      lam_off):
    """K1 and K2 against their plain versions with the flagship
    inv_dx2 = n², at every geometry the kernels handle in-kernel (scalar
    head and tail, single-cell lanes); float32 sums run in another order
    than the plain version's, hence its looser tolerance. float32 D̄ and k̄
    are held against the plain version evaluated in float64 on the same
    inputs: they cancel (terms of either sign), and at n = 2^20 the float32
    plain version's own sum is off by up to ~1e-5 of k̄. D̄ is exactly 0
    at n = 1 (L(u) = 0), so a zero reference is compared absolutely."""
    u, lam = _rd1d_case(cuda, dtype, n, u_off, lam_off)
    p = torch.tensor([1e-7, 1.5], device=cuda, dtype=dtype)
    inv_dx2 = float(n) ** 2
    f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
    du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
    torch.cuda.synchronize()
    f_ref = rd1d.rd1d_reference(u, p, inv_dx2)
    du_ref, _ = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam)
    _, dp_ref = rd1d.rd1d_vjp_reference(u.double(), p.double(), inv_dx2,
                                        lam.double())
    dp = dp.double()
    assert f.shape == du.shape == (n,) and dp.shape == (2,)
    assert float((f - f_ref).abs().max() / f_ref.abs().max()) <= tol
    assert float((du - du_ref).abs().max() / du_ref.abs().max()) <= tol
    diff = (dp - dp_ref).abs()
    err = torch.where(dp_ref != 0, diff / dp_ref.abs(), diff)
    assert float(err.max()) <= dp_tol
    # deterministic: the cross-block sum runs in block order every call
    du2, dp2 = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
    assert torch.equal(du2, du) and torch.equal(dp2.double(), dp)


@pytest.mark.parametrize("n,u_off,lam_off", [(262144, 0, 0), (1048576, 0, 0),
                                             (262144, 1, 1), (262144, 0, 1),
                                             (5, 0, 0)])
def test_kernels_launch_once_per_call(cuda, n, u_off, lam_off):
    """A profiler trace of one K1 and one K2 call (after a first call that
    makes K2's workspace): exactly one kernel each, and no memset. A trace
    that recorded no device activity is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    u, lam = _rd1d_case(cuda, torch.float32, n, u_off, lam_off)
    p = torch.tensor([1e-7, 1.5], device=cuda)
    calls = {"K1": lambda: rd1d.rd1d_fwd_cuda(u, p, float(n) ** 2),
             "K2": lambda: rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            keys = [e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    for _ in range(e.count)]
            if keys:
                break
        assert len(keys) == 1 and "rd1d" in keys[0], (name, keys)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_k2_nan_input_finishes(cuda, dtype):
    """A NaN in λ makes K2's D̄ and k̄ NaN, as in the plain version, and the
    launch still finishes (the NaN partials fill their slots); the next
    call on clean inputs is right again."""
    n = 262144
    u, lam = _rd1d_case(cuda, dtype, n, 0, 0)
    p = torch.tensor([1e-7, 1.5], device=cuda, dtype=dtype)
    bad = lam.clone()
    bad[n // 3] = float("nan")
    _, dp = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, bad)
    _, dp_ref = rd1d.rd1d_vjp_reference(u, p, float(n) ** 2, bad)
    assert torch.isnan(dp).all() and torch.isnan(dp_ref).all()
    _, dp = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)
    _, dp_ref = rd1d.rd1d_vjp_reference(u.double(), p.double(),
                                        float(n) ** 2, lam.double())
    assert float(((dp.double() - dp_ref).abs() / dp_ref.abs()).max()) <= 1e-5


def test_k2_under_graph_capture(cuda):
    """K2 in a CUDA graph: captured on a stream whose workspace an eager
    call made, each replay gives the eager call's bits, and the next eager
    call too (the replays leave the slots empty). Capture on a stream
    without a workspace raises before launch."""
    n = 262144
    u, lam = _rd1d_case(cuda, torch.float32, n, 0, 0)
    p = torch.tensor([1e-7, 1.5], device=cuda)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        du0, dp0 = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        du, dp = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(du, du0) and torch.equal(dp, dp0)
    with torch.cuda.stream(stream):
        du1, dp1 = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)
    stream.synchronize()
    assert torch.equal(du1, du0) and torch.equal(dp1, dp0)
    with pytest.raises(RuntimeError, match="before CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(),
                              stream=torch.cuda.Stream(cuda)):
            rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)


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


def test_forwarddiff_gradient_on_card_matches_cpu(cuda):
    """Lotka–Volterra's gradient under sensealg=None, which is
    ForwardDiffSensitivity (no kernel: forward mode through the tangent
    replay), float64 on [0, 2]: the card against the port's CPU run."""
    grads = []
    for device in (cuda, "cpu"):
        prob = P.lotka_volterra_problem((0.0, 2.0), device=device)
        u0 = prob.u0.clone().requires_grad_()
        p = prob.p.clone().requires_grad_()
        sol = P.solve(P.ODEProblem(prob.f, u0, prob.tspan, p), P.Tsit5(),
                      saveat=[0.0, 0.5, 1.0, 1.5, 2.0], rtol=1e-8, atol=1e-10)
        assert type(sol.sensealg) is P.ForwardDiffSensitivity
        grads.append(torch.cat(torch.autograd.grad(
            torch.sum((sol.ys - 1.0) ** 2), (u0, p))).cpu())
    rel = torch.linalg.vector_norm(grads[0] - grads[1]) / torch.linalg.vector_norm(grads[1])
    assert float(rel) <= 1e-9


def test_quadrature_gradient_on_card_matches_cpu(cuda):
    """The flagship gradient under QuadratureAdjoint at n = 16384, 16 fixed
    steps, float64: the card (K1 in the forward, K2 at every λ stage and
    Gauss–Kronrod node) against the port's CPU run."""
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
                      sensealg=P.QuadratureAdjoint(), adj_rtol=1e-3,
                      adj_atol=1e-8)
        grads.append([g.cpu() for g in torch.autograd.grad(
            torch.sum(sol.ys[-1] ** 2), (u0, p))])
        after = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        assert sol.retcode == 0 and sol.adjoint.stats.retcode == 0
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
    (gu_card, gp_card), (gu_cpu, gp_cpu) = grads
    rel = torch.linalg.vector_norm(gu_card - gu_cpu) / torch.linalg.vector_norm(gu_cpu)
    assert float(rel) <= 1e-9
    assert float(((gp_card - gp_cpu).abs() / gp_cpu.abs()).max()) <= 1e-9


# relative to max|.| of each output: float64 and float32 sum in another order
# than the plain version; bfloat16 outputs keep 8 bits, and a sum in another
# order can flip one rounding of h, dz or an output (2^-8 ~ 3.9e-3 each)
MLP_TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16], ids=str)
def test_mlp_kernels_match_plain_versions(cuda, dtype):
    """K3 and K4 at a ragged shape (B = 37, 5 -> 67 -> 3: no dimension a
    multiple of a tile) against their plain versions on the card, float32
    without TF32; K4 returns the same bits twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, din, hid, dout = 37, 5, 67, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    make = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)
    x, w0, b0, w1, b1, g = (make(B, din), make(din, hid), make(hid),
                            make(hid, dout), make(dout), make(B, dout))
    y, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    grads = mlp.mlp2_vjp_cuda(x, w0, w1, h, g)
    torch.cuda.synchronize()
    y_ref, h_ref = mlp.mlp2_fwd_reference(x, w0, b0, w1, b1)
    refs = mlp.mlp2_vjp_reference(x, w0, w1, h, g)
    for name, got, ref in zip(("y", "h", "dx", "dW0", "db0", "dW1", "db1"),
                              (y, h) + tuple(grads), (y_ref, h_ref) + refs):
        assert got.dtype == dtype and got.shape == ref.shape, name
        err = float((got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        assert err <= MLP_TOL[dtype], (name, err)
    again = mlp.mlp2_vjp_cuda(x, w0, w1, h, g)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("route,shape", [
    ("wgmma", (1024, 512, 2048, 512)),  # S4, the batched field
    ("wgmma", (1000, 264, 1032, 136)),  # partial tiles in every dimension
    ("wmma", (37, 5, 67, 3)),           # ragged widths: WMMA's own shape
    ("wmma", (1024, 512, 2048, 512)),   # S4 forced onto WMMA
], ids=["wgmma-S4", "wgmma-ragged", "wmma-ragged", "wmma-forced-S4"])
def test_mlp_routes_match_plain_versions(cuda, route, shape):
    """bfloat16 K3 and K4 on each tensor-core route against their plain
    versions (MLP_TOL, relative to max|.| of each output: every K4 output
    comes from one product, so a wrong operand layout shows in its own
    output); K4 returns the same bits twice; the per-route counters move as
    mlp2_route says, or as the forced route says."""
    B, din, hid, dout = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    make = lambda *s, scale=1.0: (scale * torch.randn(
        *s, generator=gen, device=cuda)).to(torch.bfloat16)
    x, w0, b0 = make(B, din), make(din, hid, scale=din ** -0.5), make(hid)
    w1, b1, g = make(hid, dout, scale=hid ** -0.5), make(dout), make(B, dout)
    natural = mlp.mlp2_route(B, din, hid, dout, torch.bfloat16, True)
    forced = None if route == natural else route
    before = (dict(mlp.mlp2_fwd_cuda.routes), dict(mlp.mlp2_vjp_cuda.routes))
    y, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=forced)
    grads = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=forced)
    again = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=forced)
    torch.cuda.synchronize()
    refs = (mlp.mlp2_fwd_reference(x, w0, b0, w1, b1)
            + mlp.mlp2_vjp_reference(x, w0, w1, h, g))
    for name, got, ref in zip(("y", "h", "dx", "dW0", "db0", "dW1", "db1"),
                              (y, h) + tuple(grads), refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        err = float((got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        assert err <= MLP_TOL[torch.bfloat16], (name, err)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))
    moved = [{k: v - b[k] for k, v in now.items() if v != b[k]} for now, b in
             zip((mlp.mlp2_fwd_cuda.routes, mlp.mlp2_vjp_cuda.routes), before)]
    assert moved == [{route: 1}, {route: 2}]


def test_spiral_gradient_on_card_matches_cpu(cuda):
    """S1, the spiral on a fixed grid with the fused field (DirectAdjoint),
    float64: the card through K3 and K4 against the port's CPU run through
    the plain versions, relative L2 <= 1e-9 per parameter; the launch
    counters move on the card and stay put on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ts = torch.linspace(0.0, 1.5, 30, dtype=torch.float64).tolist()
    grads = []
    for device in (cuda, "cpu"):
        gen = torch.Generator().manual_seed(0)
        params = {k: v.requires_grad_() for k, v in P.mlp_init(
            gen, (2, 50, 2), torch.float64, device=device).items()}
        data = 0.1 * torch.arange(60, dtype=torch.float64,
                                  device=device).reshape(30, 2)
        before = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
        prob = P.ODEProblem(lambda u, p, t: mlp.fused_mlp2(p, u ** 3),
                            torch.tensor([2.0, 0.0], dtype=torch.float64,
                                         device=device), (0.0, 1.5), params)
        sol = P.solve(prob, P.Tsit5(), saveat=ts, dt=1.5 / 29,
                      adaptive=False, unroll=True)
        loss = torch.sum((sol.ys - data) ** 2)
        grads.append({k: g.cpu() for k, g in zip(
            params, torch.autograd.grad(loss, list(params.values())))})
        after = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
        assert isinstance(sol.sensealg, P.DirectAdjoint)
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
        else:
            assert after == before
    for k in grads[1]:
        rel = (torch.linalg.vector_norm(grads[0][k] - grads[1][k])
               / torch.linalg.vector_norm(grads[1][k]))
        assert float(rel) <= 1e-9, (k, float(rel))


# K5, K6 vs plain, relative to max|.| (ū, u) and per entry (D̄, k̄): float64
# to roundoff; float32 runs 4·S stages whose sums round in another order
RK4_TOL = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-5)}


def _rk4_inputs(n, dtype, device, h=1e-3):
    """Random u in [0, 1] and λ, with h·D·inv_dx2 = h·k-scale = 1e-3: every
    step moves u, while the window-edge values that the halo absorbs stay
    (1e-3)^(2S+2) below the interior's (the windowed pullback equals the
    whole-grid one to that order, in JAX as here)."""
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.rand(n, generator=gen, device=device, dtype=dtype)
    lam = torch.randn(n, generator=gen, device=device, dtype=dtype)
    inv_dx2 = float(n) ** 2
    p = torch.tensor([1.0 / inv_dx2, 1.5], device=device, dtype=dtype)
    return u, lam, p, inv_dx2, h


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("n,S,chunk,bwd_chunk", [
    (65536, 16, 4096, 1024),  # the flagship tiles, G = 16 and 64
    (3072, 8, 1024, 512),     # few tiles: both grid edges next to each other
    (1024, 4, 1024, 1024),    # one tile, no halo
    (5000, 7, 1000, 500),     # windows of 1064 and 564: no multiple of
                              # threads x R
    (240, 2, 40, 24),         # windows of 64 and 48: under one warp's 32·R
    (4096, 1, 512, 256),      # S = 1
    (20480, 16, 5120, 1024),  # a K5 window of 5256: R = 16
])
def test_rk4_kernels_match_plain_versions(cuda, dtype, n, S, chunk, bwd_chunk):
    """K5 and K6 against the whole-grid plain versions, at geometries that
    stress each thread's register tile; K6 gives the same bits twice."""
    u, lam, p, inv_dx2, h = _rk4_inputs(n, dtype, cuda)
    tol, dp_tol = RK4_TOL[dtype]
    y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk)
    du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam)
    torch.cuda.synchronize()
    y_ref = rd1d.rd1d_rk4_scan_reference(u, p, inv_dx2, h, S)
    du_ref, dp_ref = rd1d.rd1d_rk4_block_vjp_reference(u, p, inv_dx2, h, S,
                                                       lam)
    assert float((y - y_ref).abs().max() / y_ref.abs().max()) <= tol
    assert float((du - du_ref).abs().max() / du_ref.abs().max()) <= tol
    assert float(((dp - dp_ref).abs() / dp_ref.abs()).max()) <= dp_tol
    du2, dp2 = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam)
    assert torch.equal(du2, du) and torch.equal(dp2, dp)


def test_rk4_wrappers_refuse_bad_geometry(cuda):
    """Both contracts of _chunk_geometry, a K5 window larger than its
    register tile and a K6 window whose entry-state cache exceeds a block's
    shared memory raise before any launch."""
    u, _, p, inv_dx2, h = _rk4_inputs(4096, torch.float32, cuda)
    before = rd1d.rd1d_rk4_fwd_cuda.launches
    with pytest.raises(ValueError, match="divisible"):
        rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, 4, 1000)
    with pytest.raises(ValueError, match="halo width"):
        rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, 16, 64)
    big = torch.zeros(1 << 20, device=cuda)
    with pytest.raises(ValueError, match="register tile"):
        rd1d.rd1d_rk4_fwd_cuda(big, p, inv_dx2, h, 16, 1 << 16)
    with pytest.raises(ValueError, match="shared memory"):
        rd1d.rd1d_rk4_vjp_cuda(big, p, inv_dx2, h, 16, 4096, big)
    assert rd1d.rd1d_rk4_fwd_cuda.launches == before


def test_rk4_block_gradient_on_card_matches_cpu(cuda):
    """Four chained blocks (S = 16, n = 65536, float64) through
    make_rd1d_rk4_block: the card through K5 and K6 against the port's CPU
    run through the plain versions, relative L2 <= 1e-9; each block is
    one K5 and one K6 launch."""
    n, S = 65536, 16
    blk = rd1d.make_rd1d_rk4_block(n, S)
    u_cpu, _, p_cpu, inv_dx2, h = _rk4_inputs(n, torch.float64, "cpu")
    grads = []
    for device in (cuda, "cpu"):
        u = u_cpu.to(device).requires_grad_()
        p = p_cpu.to(device).requires_grad_()
        before = (rd1d.rd1d_rk4_fwd_cuda.launches,
                  rd1d.rd1d_rk4_vjp_cuda.launches)
        y = u
        for _ in range(4):
            y = blk(y, p, inv_dx2, h)
        grads.append([g.cpu() for g in torch.autograd.grad(
            torch.sum(y ** 2), (u, p))])
        after = (rd1d.rd1d_rk4_fwd_cuda.launches,
                 rd1d.rd1d_rk4_vjp_cuda.launches)
        want = (4, 4) if device != "cpu" else (0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
    for got, ref in zip(*grads):
        rel = torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)
        assert float(rel) <= 1e-9
