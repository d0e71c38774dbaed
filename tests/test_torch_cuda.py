"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor tests/conftest.py's JAX set-up, so on a machine with a card and
without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.adjoints.continuous import AdjointRecord
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
MLP_OUTPUTS = ("y", "h", "dx", "dW0", "db0", "dW1", "db1")


def _mlp_inputs(cuda, dtype, shape, offset=0, fan_in=True):
    """Seeded K3/K4 inputs (x, W0, b0, W1, b1, g) at (B, din, hid, dout),
    W0 and W1 at the fan-in scale of mlp_init when `fan_in` (tanh does not
    saturate at wide layers), each a contiguous view `offset` elements into
    a buffer of its own."""
    B, din, hid, dout = shape
    gen = torch.Generator(device=cuda).manual_seed(0)

    def make(*s, scale=1.0):
        n = 1
        for d in s:
            n *= d
        buf = scale * torch.randn(n + offset, generator=gen, device=cuda)
        return buf[offset:].to(dtype).view(*s)

    s0, s1 = (din ** -0.5, hid ** -0.5) if fan_in else (1.0, 1.0)
    return (make(B, din), make(din, hid, scale=s0), make(hid),
            make(hid, dout, scale=s1), make(dout), make(B, dout))


def _check_mlp_kernels(x, w0, b0, w1, b1, g, route=None):
    """K3 and K4 against their plain versions (MLP_TOL, relative to max|.|
    of each output: every K4 output comes from one product, so a wrong
    operand layout shows in its own output), both returning the same bits
    on a second call; the (K3, K4) route counters' moves."""
    dtype = x.dtype
    before = (dict(mlp.mlp2_fwd_cuda.routes), dict(mlp.mlp2_vjp_cuda.routes))
    y, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=route)
    y2, h2 = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=route)
    grads = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=route)
    again = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=route)
    torch.cuda.synchronize()
    refs = (mlp.mlp2_fwd_reference(x, w0, b0, w1, b1)
            + mlp.mlp2_vjp_reference(x, w0, w1, h, g))
    for name, got, ref in zip(MLP_OUTPUTS, (y, h) + tuple(grads), refs):
        assert got.dtype == dtype and got.shape == ref.shape, name
        err = float((got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())
        assert err <= MLP_TOL[dtype], (name, err)
    assert torch.equal(y2, y) and torch.equal(h2, h)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))
    return [{k: v - b[k] for k, v in now.items() if v != b[k]} for now, b in
            zip((mlp.mlp2_fwd_cuda.routes, mlp.mlp2_vjp_cuda.routes), before)]


def _splits(shape, bwd):
    """Whether the float32 plan splits the depth of a product of K3 (or
    K4) at this shape on device 0: it then has a workspace."""
    return mlp._split_words(0, *shape, bwd) > 0


# (dtype, (B, din, hid, dout), offset of every operand in elements)
MLP_KERNEL_CASES = [
    (torch.float64, (37, 5, 67, 3), 0),  # no dimension a multiple of a tile
    (torch.float32, (37, 5, 67, 3), 0),  # (unscaled weights at this shape)
    (torch.bfloat16, (37, 5, 67, 3), 0),
    # float32, the simt route's edges: B = 1 at S4's widths (split depths),
    # the spiral's field, ragged 128 x 64 tiles with depths (hid, B) that
    # are no multiple of the 16-deep slice and rows (dout) off 16 bytes, and
    # every operand one float off 16-byte alignment (the 4-byte copies)
    (torch.float32, (1, 512, 2048, 512), 0),
    (torch.float32, (1, 2, 50, 2), 0),
    (torch.float32, (1100, 520, 2050, 510), 0),
    (torch.float32, (64, 512, 2048, 512), 1),
    # float64 stays on the 64 x 64 tiles it had
    (torch.float64, (8, 512, 2048, 512), 0),
]


@pytest.mark.parametrize(
    "dtype,shape,offset", MLP_KERNEL_CASES,
    ids=[f"{str(d)[6:]}-{'x'.join(map(str, s))}-off{o}"
         for d, s, o in MLP_KERNEL_CASES])
def test_mlp_kernels_match_plain_versions(cuda, dtype, shape, offset):
    """K3 and K4 on the route mlp2_route picks against their plain versions
    on the card, float32 without TF32; both return the same bits twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _mlp_inputs(cuda, dtype, shape, offset,
                         fan_in=shape != (37, 5, 67, 3))
    if offset:
        assert all(t.data_ptr() % 16 for t in inputs)
    route = mlp.mlp2_route(*shape, dtype, offset == 0)
    assert _check_mlp_kernels(*inputs) == [{route: 2}, {route: 2}]


@pytest.mark.parametrize("route,shape", [
    ("wgmma", (1024, 512, 2048, 512)),  # S4, the batched field
    ("wgmma", (1000, 264, 1032, 136)),  # partial tiles in every dimension
    ("wmma", (37, 5, 67, 3)),           # ragged widths: WMMA's own shape
    ("wmma", (1024, 512, 2048, 512)),   # S4 forced onto WMMA
    ("simt", (1024, 512, 2048, 512)),   # S4 float32: 128 x 64, split depths
    ("simt", (8, 512, 2048, 512)),      # S4's widths at B = 8: 64 x 64, split
], ids=["wgmma-S4", "wgmma-ragged", "wmma-ragged", "wmma-forced-S4",
        "simt-S4", "simt-S4-widths-B8"])
def test_mlp_routes_match_plain_versions(cuda, route, shape):
    """K3 and K4 on each route (bfloat16 on the tensor-core routes, float32
    on simt) against their plain versions; both return the same bits twice;
    the per-route counters move as mlp2_route says, or as the forced route
    says. The float32 shapes split the depth of products in K3 and in K4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float32 if route == "simt" else torch.bfloat16
    inputs = _mlp_inputs(cuda, dtype, shape)
    natural = mlp.mlp2_route(*shape, dtype, True)
    if route == "simt":
        assert _splits(shape, False) and _splits(shape, True)
    forced = None if route == natural else route
    assert _check_mlp_kernels(*inputs, route=forced) == [{route: 2},
                                                          {route: 2}]


def test_mlp_f32_split_kernels_in_cuda_graphs(cuda):
    """K3 and K4 on the float32 route with split products, captured in two
    CUDA graphs (each call zeroes the arrival counters in its own
    workspace) and replayed at once on two streams while eager calls run
    on the current one: every replay and every eager call gives the first
    eager call's bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (64, 512, 2048, 512)
    assert _splits(shape, False) and _splits(shape, True)
    x, w0, b0, w1, b1, g = _mlp_inputs(cuda, torch.float32, shape)

    def both():
        y, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        return (y, h) + tuple(mlp.mlp2_vjp_cuda(x, w0, w1, h, g))

    want = both()
    torch.cuda.synchronize()
    graphs, outs = [], []
    for _ in range(2):
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append(both())
    streams = [torch.cuda.Stream(cuda) for _ in graphs]
    for _ in range(3):
        for graph, stream in zip(graphs, streams):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        eager = both()
        for stream in streams:
            torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        for got in outs + [eager]:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.parametrize("sensealg", [None, P.InterpolatingAdjoint(),
                                      P.DirectAdjoint()],
                         ids=["default_gauss", "interpolating", "direct"])
def test_dosed_pde_gradient_on_card_matches_cpu(cuda, sensealg):
    """The flagship field at n = 16384 with one dose (PresetTimeCallback at
    6 ns of 16, affect u ← 0.9u + 0.05u²), adaptive from dt0 = 1e-9,
    float64: the card through K1 and K2 against the port's CPU run; one
    dose recorded on both."""
    n, t1 = 16384, 16e-9
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    cb = P.PresetTimeCallback([6e-9], lambda u, p, t: 0.9 * u + 0.05 * u * u)
    grads = []
    for device in (cuda, "cpu"):
        x = torch.arange(n, dtype=torch.float64, device=device) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0).requires_grad_()
        p = torch.tensor([1e-7, 1.5], dtype=torch.float64,
                         device=device).requires_grad_()
        before = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                      saveat=[0.0, t1], dt0=1e-9, rtol=1e-8, atol=1e-10,
                      callback=cb, sensealg=sensealg)
        grads.append([g.cpu() for g in torch.autograd.grad(
            torch.sum(sol.ys[-1] ** 2), (u0, p))])
        after = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        assert sol.retcode == 0 and sol.events.count == 1
        if sensealg is None:
            assert isinstance(sol.sensealg, P.GaussAdjoint)
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
    (gu_card, gp_card), (gu_cpu, gp_cpu) = grads
    rel = torch.linalg.vector_norm(gu_card - gu_cpu) / torch.linalg.vector_norm(gu_cpu)
    assert float(rel) <= 1e-9
    assert float(((gp_card - gp_cpu).abs() / gp_cpu.abs()).max()) <= 1e-9


@pytest.mark.parametrize("case", ["event_gauss", "event_direct",
                                  "dense_gauss", "saveat_gauss"])
def test_spiral_events_and_dense_on_card_match_cpu(cuda, case):
    """The spiral's fused field (K3/K4), adaptive (rtol 1e-3, atol 1e-6) on
    [0, 1.5], float64: with the event ‖u‖² = 3 (u ← 0.8u; ‖u‖² falls
    from 4 to 1.8 at seed 0) under GaussAdjoint
    and DirectAdjoint, with dense=True and Σ sol(t)² over 20 query times,
    and with a saveat tensor's gradient; the card against the port's CPU
    run, relative L2 <= 1e-9 per leaf, the same event count on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ts = torch.linspace(0.0, 1.5, 30, dtype=torch.float64).tolist()
    tq = torch.linspace(0.01, 1.49, 20, dtype=torch.float64).tolist()
    sensealg = P.DirectAdjoint() if case == "event_direct" else P.GaussAdjoint()
    cb = P.ContinuousCallback(lambda u, p, t: u[0] ** 2 + u[1] ** 2 - 3.0,
                              lambda u, p, t: 0.8 * u)
    grads, counts = [], []
    for device in (cuda, "cpu"):
        gen = torch.Generator().manual_seed(0)
        params = {k: v.requires_grad_() for k, v in P.mlp_init(
            gen, (2, 50, 2), torch.float64, device=device).items()}
        sv = torch.tensor(ts, dtype=torch.float64, requires_grad=True)
        before = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
        prob = P.ODEProblem(lambda u, p, t: mlp.fused_mlp2(p, u ** 3),
                            torch.tensor([2.0, 0.0], dtype=torch.float64,
                                         device=device), (0.0, 1.5), params)
        sol = P.solve(prob, P.Tsit5(), saveat=sv, rtol=1e-3, atol=1e-6,
                      max_steps=256, sensealg=sensealg,
                      dense=case == "dense_gauss",
                      callback=cb if case.startswith("event") else None)
        loss = (torch.sum(sol(tq) ** 2) if case == "dense_gauss"
                else torch.sum(sol.ys ** 2))
        wrt = list(params.values()) + ([sv] if case == "saveat_gauss" else [])
        grads.append([g.cpu() for g in torch.autograd.grad(loss, wrt)])
        after = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
        assert sol.retcode == 0
        if case.startswith("event"):
            counts.append(sol.events.count)
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
    assert not counts or counts[0] == counts[1] >= 1
    for g_card, g_cpu in zip(*grads):
        rel = (torch.linalg.vector_norm(g_card - g_cpu)
               / torch.linalg.vector_norm(g_cpu))
        assert float(rel) <= 1e-9


@pytest.mark.parametrize("sensealg", [P.ForwardDiffSensitivity(),
                                      P.DirectAdjoint()],
                         ids=["forwarddiff", "direct"])
def test_ball_dense_through_bounces_on_card_matches_cpu(cuda, sensealg):
    """sol(t) through the bouncing ball's bounces (continuous events, which
    move the dense nodes after them) under the discrete rules, float64:
    the card's gradient against the port's CPU run, 1e-12 per entry."""
    grads = []
    for device in (cuda, "cpu"):
        u0 = torch.tensor([1.0, 0.0], dtype=torch.float64, device=device,
                          requires_grad=True)
        p = torch.tensor([0.9], dtype=torch.float64, device=device,
                         requires_grad=True)
        cb = P.ContinuousCallback(
            lambda u, q, t: u[0],
            lambda u, q, t: torch.stack([u[0], -q[0] * u[1]]), direction=-1)
        prob = P.ODEProblem(
            lambda u, q, t: torch.stack([u[1], -9.81 + 0.0 * u[0]]), u0,
            (0.0, 2.0), p)
        sol = P.solve(prob, P.Tsit5(), rtol=1e-10, atol=1e-12, dense=True,
                      callback=cb, sensealg=sensealg)
        assert sol.retcode == 0 and sol.events.count == 3
        loss = torch.sum(sol([0.3, 0.7, 1.2, 1.8]) ** 2)
        grads.append([g.cpu() for g in torch.autograd.grad(loss, (u0, p))])
    for g_card, g_cpu in zip(*grads):
        assert torch.allclose(g_card, g_cpu, rtol=1e-12, atol=1e-12)


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


# a shard's geometry: (n, S, chunk, bwd_chunk) of one rank's cells, each with
# a neighbour on both sides, on the left only and on the right only
RK4_SHARD_GEOMS = [
    (32768, 16, 4096, 1024),  # the flagship tiles on a shard
    (1000, 4, 1000, 1000),    # one tile that still needs its halo
    (5000, 7, 1000, 500),     # windows not a multiple of threads x R
    (68, 16, 68, 68),         # a shard of exactly 4(S+1) cells
]


@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("n,S,chunk,bwd_chunk", RK4_SHARD_GEOMS)
def test_rk4_kernels_with_shard_ghosts_match_plain_versions(
        cuda, dtype, n, S, chunk, bwd_chunk, sides):
    """K5 and K6 on a shard, reading the 4(S+1) cells beyond each inner end
    from a device buffer, against the ghosted plain versions (the scan and
    the reverse sweep over the shard widened by its ghosts) on the same
    inputs; K6 gives the same bits twice."""
    u, lam, p, inv_dx2, h = _rk4_inputs(n, dtype, cuda)
    H = 4 * (S + 1)
    gen = torch.Generator(device=cuda).manual_seed(5)
    ghosts = torch.rand(4 * H, generator=gen, device=cuda, dtype=dtype)
    tol, dp_tol = RK4_TOL[dtype]
    y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk,
                               ghosts[:2 * H].contiguous(), *sides)
    du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam,
                                    ghosts, *sides)
    torch.cuda.synchronize()
    y_ref = rd1d.rd1d_rk4_scan_shard_reference(u, p, inv_dx2, h, S,
                                               ghosts[:2 * H], *sides)
    du_ref, _ = rd1d.rd1d_rk4_block_vjp_shard_reference(
        u, p, inv_dx2, h, S, lam, ghosts, *sides)
    _, dp_ref = rd1d.rd1d_rk4_block_vjp_shard_reference(
        u.double(), p.double(), inv_dx2, h, S, lam.double(),
        ghosts.double(), *sides)
    assert float((y - y_ref).abs().max() / y_ref.abs().max()) <= tol
    assert float((du - du_ref).abs().max() / du_ref.abs().max()) <= tol
    assert float(((dp.double() - dp_ref).abs() / dp_ref.abs()).max()) \
        <= dp_tol
    du2, dp2 = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam,
                                      ghosts, *sides)
    assert torch.equal(du2, du) and torch.equal(dp2, dp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_rk4_kernels_on_pieces_give_the_whole_grids_bits(cuda, dtype):
    """K5 and K6 with a null ghost buffer over the whole grid, and on two
    and four pieces whose ends fall on tile ends, each piece reading its
    neighbours' cells from its ghost buffer: the pieces' windows are the
    whole grid's, so u after the block and ū are the null launch's bits,
    and the pieces' D̄, k̄ sum to its."""
    n, S, chunk, bwd_chunk = 262144, 16, 4096, 1024
    u, lam, p, inv_dx2, h = _rk4_inputs(n, dtype, cuda)
    H = 4 * (S + 1)
    y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk)
    du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam)
    for world in (2, 4):
        m = n // world
        ys, dus, dps = [], [], []
        for r in range(world):
            a, b = r * m, (r + 1) * m
            sides = (r > 0, r + 1 < world)

            def ghosts_of(x):
                left = x[a - H:a] if sides[0] else x.new_zeros(H)
                right = x[b:b + H] if sides[1] else x.new_zeros(H)
                return torch.cat([left, right])

            gu = ghosts_of(u)
            ys.append(rd1d.rd1d_rk4_fwd_cuda(u[a:b], p, inv_dx2, h, S, chunk,
                                             gu, *sides))
            d, q = rd1d.rd1d_rk4_vjp_cuda(u[a:b], p, inv_dx2, h, S,
                                          bwd_chunk, lam[a:b],
                                          torch.cat([gu, ghosts_of(lam)]),
                                          *sides)
            dus.append(d)
            dps.append(q)
        assert torch.equal(torch.cat(ys), y)
        assert torch.equal(torch.cat(dus), du)
        total = sum(q.double() for q in dps)
        assert float(((total - dp.double()).abs() / dp.double().abs()).max()
                     ) <= RK4_TOL[dtype][1]


def test_rk4_wrappers_refuse_a_narrow_shard(cuda):
    """A shard narrower than 4(S+1) cells, or one that the chunk does not
    divide, raises ShardedStateError before any launch."""
    from scimlsensitivity_jl_tpu_torch.parallel.sharded import (
        ShardedStateError)

    u, lam, p, inv_dx2, h = _rk4_inputs(60, torch.float32, cuda)
    ghosts = torch.zeros(4 * 68, device=cuda)
    before = (rd1d.rd1d_rk4_fwd_cuda.launches,
              rd1d.rd1d_rk4_vjp_cuda.launches)
    with pytest.raises(ShardedStateError, match="at least 4"):
        rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, 16, 60, ghosts[:136],
                               True, True)
    with pytest.raises(ShardedStateError, match="divisible"):
        rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, 1, 7, lam, ghosts[:32],
                               True, False)
    assert (rd1d.rd1d_rk4_fwd_cuda.launches,
            rd1d.rd1d_rk4_vjp_cuda.launches) == before


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


def _second_pass_through(field, device):
    """The gradient of a loss through one kernel field, taken with
    create_graph=True, then differentiated again: rd1d under GaussAdjoint
    (the continuous rule's backward), the fused MLP under DirectAdjoint
    (autograd through the fixed grid), the RK4 block chained twice."""
    if field == "rd1d":
        n, dt = 16384, 1e-9
        x = torch.arange(n, dtype=torch.float64, device=device) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
        p = torch.tensor([1e-7, 1.5], dtype=torch.float64, device=device,
                         requires_grad=True)
        sol = P.solve(P.ODEProblem(rd1d.make_rd1d_field(n, 1.0 / n), u0,
                                   (0.0, 8 * dt), p), P.Tsit5(),
                      saveat=[0.0, 8 * dt], dt=dt, adaptive=False,
                      sensealg=P.GaussAdjoint())
        loss = torch.sum(sol.ys[-1] ** 2)
    elif field == "mlp":
        gen = torch.Generator().manual_seed(0)
        p = {k: v.requires_grad_() for k, v in P.mlp_init(
            gen, (2, 50, 2), torch.float64, device=device).items()}
        sol = P.solve(P.ODEProblem(
            lambda u, q, t: mlp.fused_mlp2(q, u ** 3),
            torch.tensor([2.0, 0.0], dtype=torch.float64, device=device),
            (0.0, 0.3), p), P.Tsit5(), saveat=[0.0, 0.3], dt=0.1,
            adaptive=False, unroll=True)
        loss = torch.sum(sol.ys ** 2)
        p = p["W0"]
    else:
        n = 65536
        u, _, p, inv_dx2, h = _rk4_inputs(n, torch.float64, device)
        p.requires_grad_()
        blk = rd1d.make_rd1d_rk4_block(n, 16)
        loss = torch.sum(blk(blk(u, p, inv_dx2, h), p, inv_dx2, h) ** 2)
    (g,) = torch.autograd.grad(loss, p, create_graph=True)
    return torch.autograd.grad(g.sum(), p)


@pytest.mark.parametrize("field,name", [("rd1d", "FusedRD1D"),
                                        ("mlp", "FusedMLP2"),
                                        ("rk4_block", "RD1DRK4Block")])
def test_second_derivative_through_kernel_raises(cuda, field, name):
    """Through each kernel Function, a gradient taken with
    create_graph=True and differentiated again raises
    DoubleBackwardUnsupported naming the Function: its pullback kernel has
    no derivative, so a second derivative would miss its terms (the JAX
    package's custom_vjp kernels refuse jvp the same way)."""
    from scimlsensitivity_jl_tpu_torch.ops.vjp import DoubleBackwardUnsupported

    with pytest.raises(DoubleBackwardUnsupported, match=name):
        _second_pass_through(field, cuda)


@pytest.mark.parametrize("arm", ["InterpolatingAdjoint", "BacksolveAdjoint",
                                 "GaussAdjoint", "QuadratureAdjoint",
                                 "ODEAdjointProblem"])
def test_direct_api_on_card_matches_cpu(cuda, arm):
    """adjoint_sensitivities under each rule family, and ODEAdjointProblem's
    Interpolating layout solved by hand, on the flagship field (n = 16384,
    64 fixed steps of 1e-9, dense output, Σ u(t1)² as dgdu_discrete at
    t1), float64: the card through K1 and K2 against the port's CPU run,
    relative L2 <= 1e-9; the direct call alone launches both kernels."""
    n, dt, steps = 16384, 1e-9, 64
    t1 = steps * dt
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    cost = lambda u, p, t, i: 2.0 * u
    adj = dict(rtol=1e-3, atol=1e-8, max_steps=128)
    grads = []
    for device in (cuda, "cpu"):
        x = torch.arange(n, dtype=torch.float64, device=device) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
        p = torch.tensor([1e-7, 1.5], dtype=torch.float64, device=device)
        sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                      saveat=[0.0, t1], dt=dt, adaptive=False, dense=True,
                      sensealg=P.BacksolveAdjoint())
        before = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        if arm == "ODEAdjointProblem":
            spec = P.ODEAdjointProblem(sol, t=[t1], dgdu_discrete=cost)
            rev = P.solve(spec.prob, P.Tsit5(), callback=spec.callback,
                          tstops=spec.tstops, saveat=[t1, 0.0], **adj)
            assert rev.retcode == 0
            du0, dp = spec.extract(rev.u_final)
        else:
            du0, dp = P.adjoint_sensitivities(
                sol, t=[t1], dgdu_discrete=cost,
                sensealg=getattr(P, arm)(), **adj)
        after = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        if device != "cpu":
            assert all(a > b for a, b in zip(after, before))
        grads.append([du0.cpu(), dp.cpu()])
    for got, ref in zip(*grads):
        rel = torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref)
        assert float(rel) <= 1e-9


# -- the unrolled continuous rules and the stiff solvers ---------------------

def _dose_grad(device, sensealg, unroll):
    """(u0-grad, p-grad, solution) of the dosed PDE at n = 16384 (see
    test_dosed_pde_gradient_on_card_matches_cpu) with max_steps 256."""
    n, t1 = 16384, 16e-9
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    cb = P.PresetTimeCallback([6e-9], lambda u, p, t: 0.9 * u + 0.05 * u * u)
    x = torch.arange(n, dtype=torch.float64, device=device) / n
    u0 = torch.exp(-((x - 0.5) ** 2) * 100.0).requires_grad_()
    p = torch.tensor([1e-7, 1.5], dtype=torch.float64,
                     device=device).requires_grad_()
    sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                  saveat=[0.0, t1], dt0=1e-9, rtol=1e-8, atol=1e-10,
                  callback=cb, sensealg=sensealg, unroll=unroll,
                  max_steps=256)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    return gu, gp, sol


def _spiral_grad(device, sensealg, unroll):
    """d/dp of Σ(ys − data)² of the spiral through K3/K4, adaptive at
    bench.py:1121-1150's setting (rtol 1e-3, atol 1e-6, max_steps 64)."""
    gen = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in P.mlp_init(
        gen, (2, 50, 2), torch.float64, device=device).items()}
    ts = torch.linspace(0.0, 1.5, 30, dtype=torch.float64).tolist()
    data = 0.1 * torch.arange(60, dtype=torch.float64,
                              device=device).reshape(30, 2)
    prob = P.ODEProblem(lambda u, p, t: mlp.fused_mlp2(p, u ** 3),
                        torch.tensor([2.0, 0.0], dtype=torch.float64,
                                     device=device), (0.0, 1.5), params)
    sol = P.solve(prob, P.Tsit5(), saveat=ts, rtol=1e-3, atol=1e-6,
                  max_steps=64, sensealg=sensealg, unroll=unroll)
    return torch.autograd.grad(torch.sum((sol.ys - data) ** 2),
                               list(params.values())), sol


@pytest.mark.parametrize("field,rule", [
    ("rd1d", "BacksolveAdjoint"), ("rd1d", "InterpolatingAdjoint"),
    ("mlp2", "GaussAdjoint"), ("mlp2", "BacksolveAdjoint")])
def test_unrolled_equals_while_driver_on_card(cuda, field, rule):
    """unroll=True runs the while driver's eager loop with the masked
    scan's budget: on each kernel field the unrolled gradient equals the
    while driver's bit for bit (Interpolating's against its unpinned
    reverse, which unroll runs), and it launches the field's kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    while_alg = (P.InterpolatingAdjoint(pinned_reverse=False)
                 if rule == "InterpolatingAdjoint" else getattr(P, rule)())
    run = _dose_grad if field == "rd1d" else _spiral_grad
    counters = ((rd1d.rd1d_fwd_cuda, rd1d.rd1d_vjp_cuda) if field == "rd1d"
                else (mlp.mlp2_fwd_cuda, mlp.mlp2_vjp_cuda))
    before = [c.launches for c in counters]
    got_u = run(cuda, getattr(P, rule)(), True)
    after = [c.launches for c in counters]
    got_w = run(cuda, while_alg, False)
    assert all(a > b for a, b in zip(after, before))
    sol_u, sol_w = got_u[-1], got_w[-1]
    assert sol_u.retcode == 0 and sol_w.retcode == 0
    assert sol_u.stats.n_accepted == sol_w.stats.n_accepted
    grads_u = got_u[:-1] if field == "rd1d" else got_u[0]
    grads_w = got_w[:-1] if field == "rd1d" else got_w[0]
    for gu, gw in zip(grads_u, grads_w):
        assert torch.equal(gu, gw)


@pytest.mark.parametrize("solver", ["Rosenbrock23", "FBDF"])
def test_stiff_robertson_on_card_matches_cpu(cuda, solver):
    """Robertson on (0, 10) at rtol 1e-6 with the gradient of Σ y1² in p
    under GaussAdjoint (torch.linalg's LU on the card): the same accepted
    forward steps as the CPU run and the states to 1e-9 relative L2. The
    gradient is held to the CPU's at 1e-9 relative L2 (k3's entry is ~1e-9
    of k1's, so it is not held alone) where the reverse takes the CPU's
    steps. cuSOLVER's LU rounds otherwise than LAPACK's, and on
    Rosenbrock23's reverse that moved its steps (at adj_rtol 1e-5: 362
    accepted against 368, gradients 8.8e-5 apart); there both are held to
    one oracle instead, ForwardDiffSensitivity on the CPU through
    Rosenbrock23, at tests/test_stiff.py's bound (rtol 2e-4, atol 1e-8).
    FBDF's reverse moved its steps too."""
    def rob(u, p, t):
        return torch.stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                            p[0] * u[0] - p[1] * u[1] * u[2]
                            - p[2] * u[1] ** 2, p[2] * u[1] ** 2])

    out = []
    for device in (cuda, "cpu"):
        p = torch.tensor([0.04, 1e4, 3e7], dtype=torch.float64,
                         device=device).requires_grad_()
        sol = P.solve(P.ODEProblem(rob, torch.tensor(
            [1.0, 0.0, 0.0], dtype=torch.float64, device=device), (0.0, 10.0),
            p), getattr(P, solver)(), saveat=[0.0, 1.0, 10.0], rtol=1e-6,
            atol=1e-10, adj_rtol=1e-6, adj_atol=1e-10,
            sensealg=P.GaussAdjoint())
        (g,) = torch.autograd.grad(torch.sum(sol.ys[:, 0] ** 2), p)
        out.append((sol, sol.ys.detach().cpu(), g.cpu()))
    (s_card, y_card, g_card), (s_cpu, y_cpu, g_cpu) = out
    assert s_card.retcode == 0 and s_cpu.retcode == 0
    assert s_card.stats.n_accepted == s_cpu.stats.n_accepted, (
        s_card.stats, s_cpu.stats)
    norm = torch.linalg.vector_norm
    assert float(norm(y_card - y_cpu) / norm(y_cpu)) <= 1e-9
    if s_card.adjoint.stats == s_cpu.adjoint.stats:
        assert float(norm(g_card - g_cpu) / norm(g_cpu)) <= 1e-9
        return
    p = torch.tensor([0.04, 1e4, 3e7], dtype=torch.float64,
                     requires_grad=True)
    sol = P.solve(P.ODEProblem(rob, torch.tensor([1.0, 0.0, 0.0],
                                                 dtype=torch.float64),
                               (0.0, 10.0), p), P.Rosenbrock23(),
                  saveat=[0.0, 1.0, 10.0], rtol=1e-6, atol=1e-10,
                  sensealg=P.ForwardDiffSensitivity())
    (oracle,) = torch.autograd.grad(torch.sum(sol.ys[:, 0] ** 2), p)
    for g in (g_card, g_cpu):
        assert torch.allclose(g, oracle, rtol=2e-4, atol=1e-8), (g, oracle)


@pytest.mark.parametrize("solver", ["Rosenbrock23", "TRBDF2", "Rodas4Like",
                                    "FBDF"])
def test_stiff_solver_on_kernel_field_raises(cuda, solver):
    """A stiff step takes ∂f/∂u by forward mode, which the kernel Functions
    refuse: ForwardModeUnsupported by name, on the card."""
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    n = 4096
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    x = torch.arange(n, dtype=torch.float64, device=cuda) / n
    u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
    p = torch.tensor([1e-7, 1.5], dtype=torch.float64, device=cuda)
    with pytest.raises(ForwardModeUnsupported, match="FusedRD1D"):
        P.solve(P.ODEProblem(field, u0, (0.0, 16e-9), p),
                getattr(P, solver)(), dt0=1e-9, sensealg=P.GaussAdjoint(),
                max_steps=4)


@pytest.mark.parametrize("rule", ["GaussAdjoint", "InterpolatingAdjoint"])
def test_dae_robertson_on_card_matches_cpu(cuda, rule):
    """Robertson's semi-explicit DAE (M = diag(1, 1, 0)) on (0, 1e-3) under
    SDIRK4: the card takes the CPU's forward steps, and where the reverse
    takes the CPU's steps too the gradient in log p equals the CPU's to
    1e-9 relative L2 (cuSOLVER's LU may move a stiff step; then the stiff
    bound of tests/test_stiff.py, rtol 2e-4, atol 1e-8, holds)."""
    def rob(u, p, t):
        return torch.stack([-p[0] * u[0] + p[2] * u[1] * u[2],
                            p[0] * u[0] - p[1] * u[1] ** 2
                            - p[2] * u[1] * u[2], u[0] + u[1] + u[2] - 1.0])

    out = []
    for device in (cuda, "cpu"):
        logp = torch.log(torch.tensor([0.04, 3e7, 1e4], dtype=torch.float64,
                                      device=device)).requires_grad_()
        sol = P.solve(P.ODEProblem(rob, torch.tensor(
            [1.0, 0.0, 0.0], dtype=torch.float64, device=device), (0.0, 1e-3),
            torch.exp(logp), mass_matrix=torch.diag(torch.tensor(
                [1.0, 1.0, 0.0]))), P.SDIRK4(), saveat=[1e-4, 5e-4, 1e-3],
            rtol=1e-5, atol=1e-9, dt0=1e-5, adj_rtol=1e-5, adj_atol=1e-9,
            sensealg=getattr(P, rule)())
        (g,) = torch.autograd.grad(1e4 * sol.ys[:, 1].sum()
                                   + sol.ys[:, 2].sum(), logp)
        out.append((sol, g.cpu()))
    (s_card, g_card), (s_cpu, g_cpu) = out
    assert s_card.retcode == 0 and s_cpu.retcode == 0
    assert s_card.stats.n_accepted == s_cpu.stats.n_accepted
    if s_card.adjoint.stats == s_cpu.adjoint.stats:
        norm = torch.linalg.vector_norm
        assert float(norm(g_card - g_cpu) / norm(g_cpu)) <= 1e-9
    else:
        assert torch.allclose(g_card, g_cpu, rtol=2e-4, atol=1e-8)


def _rob(u, p, t):
    return torch.stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                        p[0] * u[0] - p[1] * u[1] * u[2] - p[2] * u[1] ** 2,
                        p[2] * u[1] ** 2])


def _card_matches_cpu(s_card, g_card, s_cpu, g_cpu):
    """Both succeed; where the card took the CPU's steps the gradients agree
    to 1e-9 relative L2, else (cuSOLVER's LU moved a step) to the stiff
    bound of tests/test_stiff.py."""
    assert s_card.retcode == 0 and s_cpu.retcode == 0
    assert torch.isfinite(g_card).all()
    if s_card.stats.n_accepted == s_cpu.stats.n_accepted:
        norm = torch.linalg.vector_norm
        assert float(norm(g_card - g_cpu) / norm(g_cpu)) <= 1e-9
    else:
        assert torch.allclose(g_card, g_cpu, rtol=2e-4, atol=1e-8)


def test_fbdf_forwarddiff_on_card_matches_cpu(cuda):
    """ForwardDiffSensitivity on FBDF (the tangents replayed through each
    logged BDF solve, with the history's tangents): Robertson on (0, 0.1)
    at rtol 1e-4, the gradient of Σ y1² in p, on the card and on the CPU."""
    out = []
    for device in (cuda, "cpu"):
        p = torch.tensor([0.04, 1e4, 3e7], dtype=torch.float64,
                         device=device).requires_grad_()
        sol = P.solve(P.ODEProblem(_rob, torch.tensor(
            [1.0, 0.0, 0.0], dtype=torch.float64, device=device), (0.0, 0.1),
            p), P.FBDF(), saveat=[0.01, 0.1], rtol=1e-4, atol=1e-8,
            sensealg=P.ForwardDiffSensitivity())
        (g,) = torch.autograd.grad(torch.sum(sol.ys[:, 0] ** 2), p)
        out += [sol, g.cpu()]
    _card_matches_cpu(*out)


def test_esdirk_direct_adjoint_saveat_on_card_matches_cpu(cuda):
    """DirectAdjoint through a saveat tensor with requires_grad on TRBDF2
    (each step clipped to a save time differentiated in its length):
    Robertson's transient (0, 1e-3) at rtol 1e-5, the gradient of 1e4·Σ y2
    in log p and in the save times, on the card and on the CPU."""
    out = []
    for device in (cuda, "cpu"):
        logp = torch.log(torch.tensor([0.04, 1e4, 3e7], dtype=torch.float64,
                                      device=device)).requires_grad_()
        sv = torch.tensor([1e-4, 5e-4], dtype=torch.float64, device=device,
                          requires_grad=True)
        sol = P.solve(P.ODEProblem(_rob, torch.tensor(
            [1.0, 0.0, 0.0], dtype=torch.float64, device=device),
            (0.0, 1e-3), torch.exp(logp)), P.TRBDF2(), saveat=sv, rtol=1e-5,
            atol=1e-10, max_steps=256, sensealg=P.DirectAdjoint())
        g = torch.autograd.grad(1e4 * torch.sum(sol.ys[:, 1]), (logp, sv))
        out += [sol, torch.cat(g).cpu()]
    _card_matches_cpu(*out)


@pytest.mark.parametrize("adaptive", [False, True])
def test_dde_fused_mlp_on_card_matches_cpu(cuda, adaptive):
    """u'(t) = mlp2(u(t - 0.25)) through fused_mlp2 (B = 4, 8→16→8,
    float64): the method of steps launches K3 in every stage and K4 in its
    pullback, and the card's gradient equals the CPU's to 1e-9 relative L2
    per leaf (RK4 at dt 1/32, or adaptive Tsit5 at rtol 1e-6)."""
    def run(device):
        gen = torch.Generator().manual_seed(3)
        params = P.mlp_init(gen, (8, 16, 8), torch.float64, device=device)
        params = {k: v.requires_grad_() for k, v in params.items()}
        u0 = (0.3 * torch.randn((4, 8), generator=gen,
                                dtype=torch.float64)).to(device)
        prob = P.DDEProblem(lambda u, h, p, t: P.fused_mlp2(p, h[0]), u0,
                            (0.0, 1.0), params, lags=(0.25,))
        kw = dict(rtol=1e-6, atol=1e-6) if adaptive else dict(dt=1.0 / 32)
        sol = P.solve(prob, saveat=[0.0, 1.0], **kw)
        grads = torch.autograd.grad(sol.ys[-1].pow(2).sum(),
                                    list(params.values()))
        return sol, [g.cpu() for g in grads]

    mlp.mlp2_fwd_cuda.launches = mlp.mlp2_vjp_cuda.launches = 0
    s_card, g_card = run(cuda)
    assert mlp.mlp2_fwd_cuda.launches > 0 and mlp.mlp2_vjp_cuda.launches > 0
    s_cpu, g_cpu = run("cpu")
    assert s_card.retcode == 0 and s_card.stats == s_cpu.stats
    for a, b in zip(g_card, g_cpu):
        assert float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)) <= 1e-9


def _nsde(device, B=4, widths=(8, 16, 8)):
    """A neural SDE whose drift and diffusion are fused_mlp2 (K3/K4), with
    seeded float64 weights."""
    gen = torch.Generator().manual_seed(0)
    params = {"drift": P.mlp_init(gen, widths, torch.float64, device=device),
              "diffusion": P.mlp_init(gen, widths, torch.float64,
                                      device=device)}
    u0 = (0.1 * torch.randn((B, widths[0]), generator=gen,
                            dtype=torch.float64)).to(device)
    prob = P.SDEProblem(
        lambda u, p, t: mlp.fused_mlp2(p["drift"], u),
        lambda u, p, t: 0.1 * torch.nn.functional.softplus(
            mlp.fused_mlp2(p["diffusion"], u)),
        u0, (0.0, 1.0), params)
    return prob, params


@pytest.mark.parametrize("rule", ["DirectAdjoint", "InterpolatingAdjoint",
                                  "BacksolveAdjoint"])
def test_neural_sde_on_card_matches_cpu(cuda, rule):
    """The neural SDE through K3/K4 under each rule, EulerMaruyama at dt
    1/16, on the numpy-backed key (the same draws on both): the card's
    gradient against the CPU run's to 1e-9 relative."""
    grads = []
    for device in (cuda, "cpu"):
        prob, params = _nsde(device)
        leaves = [v.requires_grad_() for d in params.values()
                  for v in d.values()]
        sol = P.solve(prob, P.EulerMaruyama(), dt=1 / 16, key=P.NumpyKey(3),
                      sensealg=getattr(P, rule)())
        grads.append(torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), leaves))
    for a, b in zip(*grads):
        assert torch.linalg.norm(a.cpu() - b) <= 1e-9 * torch.linalg.norm(b)


@pytest.mark.parametrize("scheme", ["Milstein", "RKMilGeneral",
                                    "StrongTaylor15", "ImplicitEM",
                                    "EulerHeun", "adaptive Milstein"])
def test_sde_kernel_field_forward_mode_refused(cuda, scheme):
    """A scheme that differentiates the kernel diffusion or drift by
    forward mode raises ForwardModeUnsupported naming the Function before
    any launch (EulerHeun through the Itô drift transform)."""
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    prob, _ = _nsde(cuda)
    solver = (P.Milstein() if scheme == "adaptive Milstein"
              else getattr(P, scheme)())
    kw = (dict(rtol=1e-3, atol=1e-6) if scheme == "adaptive Milstein"
          else dict(dt=1 / 16))
    mlp.mlp2_fwd_cuda.launches = 0
    mlp.mlp2_vjp_cuda.launches = 0
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.solve(prob, solver, key=P.NumpyKey(3), **kw)
    assert mlp.mlp2_fwd_cuda.launches == 0 == mlp.mlp2_vjp_cuda.launches


@pytest.mark.parametrize("rode", [False, True])
def test_fisher_kpp_sde_on_card_matches_cpu(cuda, rode):
    """The stochastic Fisher–KPP field through K1/K2 (the SDE with noise
    0.5u, and the RODE f + 0.5·u·W), 16 steps of 1e-9 at n = 4096 in
    float64, BacksolveAdjoint, the numpy-backed key: card against CPU to
    1e-9 relative."""
    n = 4096
    out = []
    for device in (cuda, "cpu"):
        x = torch.arange(n, dtype=torch.float64, device=device) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0).requires_grad_()
        p = torch.tensor([1e-7, 1.5], dtype=torch.float64,
                         device=device).requires_grad_()
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        if rode:
            prob = P.RODEProblem(lambda u, q, t, W: field(u, q, t)
                                 + 0.5 * u * W, u0, (0.0, 16e-9), p)
            sol = P.solve(prob, dt=1e-9, key=P.NumpyKey(3),
                          sensealg=P.BacksolveAdjoint())
        else:
            prob = P.SDEProblem(field, lambda u, q, t: 0.5 * u, u0,
                                (0.0, 16e-9), p)
            sol = P.solve(prob, P.EulerMaruyama(), dt=1e-9,
                          key=P.NumpyKey(3), sensealg=P.BacksolveAdjoint())
        out.append(torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p)))
    for a, b in zip(*out):
        assert torch.linalg.norm(a.cpu() - b) <= 1e-9 * torch.linalg.norm(b)


@pytest.mark.parametrize("rule", ["BacksolveAdjoint", "InterpolatingAdjoint"])
def test_adaptive_sde_memory_on_card(cuda, rule):
    """Adaptive EulerMaruyama on the Brownian tree at a state of 2^19
    float64 values (4 MiB; GBM with noise 0.5u, the port's own key): the
    tree keeps its queries' W (two per step in the forward, a few more
    where the reverse's tb − ta rounds off the forward's step) and one walk
    of 28 nodes, so the gradient's peak stays under (6 + s)·steps + 64
    states, s = 1 for InterpolatingAdjoint's stored nodes. A tree that kept
    every node its queries touched held about 20 states per step."""
    n = 1 << 19
    u0 = torch.ones(n, dtype=torch.float64, device=cuda).requires_grad_()
    p = torch.tensor([0.2, 0.5], dtype=torch.float64,
                     device=cuda).requires_grad_()
    prob = P.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                        u0, (0.0, 1.0), p)
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    sol = P.solve(prob, saveat=[0.0, 1.0], key=P.PRNGKey(7), rtol=1e-2,
                  atol=1e-4, sensealg=getattr(P, rule)())
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1]), (u0, p))
    torch.cuda.synchronize(cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    steps = sol.stats.n_accepted
    assert sol.retcode == 0 and 0 < steps < 1024
    assert bool(torch.isfinite(gu).all()) and bool(torch.isfinite(gp).all())
    stored = 1 if rule == "InterpolatingAdjoint" else 0
    assert peak <= ((6 + stored) * steps + 64) * n * 8, (peak, steps)


def _mlp_problem(device, B=8, widths=(8, 16, 8), T=0.5):
    """u' = fused_mlp2(θ, u) (K3/K4) with seeded float64 weights."""
    gen = torch.Generator().manual_seed(5)
    params = P.mlp_init(gen, widths, torch.float64, device=device)
    params = {k: v.requires_grad_() for k, v in params.items()}
    u0 = (0.3 * torch.randn((B, widths[0]), generator=gen,
                            dtype=torch.float64)).to(device)
    return P.ODEProblem(lambda u, p, t: mlp.fused_mlp2(p, u), u0, (0.0, T),
                        params), params


def test_nilsas_kernel_field_on_card_matches_cpu(cuda):
    """NILSAS(nseg 2, M 2) on the fused MLP field (B = 8, 8→16→8, float64)
    with g = mean(u²): K3 once and K4 M+1 = 3 times per evaluation of the
    adjoint field, and the card's d⟨g⟩/dθ against the CPU's to 1e-9
    relative (the terminal draw is a host draw, the same on both). A
    smooth g: under solve's rule the lifted cotangent rows jump midway
    between save times, and on this small field a one-ulp move of u0
    moves that gradient by up to 2.1e-7 on the CPU
    (tests/shadowing_roundoff_witness.py; chip_smoke 5n holds the rule on
    S4's field, where it does not)."""
    out = []
    for device in (cuda, "cpu"):
        prob, params = _mlp_problem(device)
        prob = P.remake(prob, p={k: v.detach() for k, v in params.items()})
        rec = AdjointRecord()
        mlp.mlp2_fwd_cuda.launches = mlp.mlp2_vjp_cuda.launches = 0
        res = P.nilsas_shadow_adjoint(
            P.NILSASProblem(prob, P.NILSAS(nseg=2, nstep=5, M=2),
                            g=lambda u, p, t: torch.mean(u ** 2)),
            rtol=1e-8, atol=1e-10, fwd_rtol=1e-8, fwd_atol=1e-10, record=rec)
        out.append(res.cpu())
        if device == cuda:
            seg_evals = 2 * 2 + 6 * (rec.stats.n_accepted
                                     + rec.stats.n_rejected)
            prim = 2 + 6 * (rec.primal.n_accepted + rec.primal.n_rejected)
            assert mlp.mlp2_vjp_cuda.launches == 3 * seg_evals
            assert mlp.mlp2_fwd_cuda.launches == prim + 1 + seg_evals
    assert torch.isfinite(out[0]).all()
    assert torch.linalg.norm(out[0] - out[1]) <= 1e-9 * torch.linalg.norm(
        out[1])


def test_shadowing_kernel_field_refusals_launch_nothing(cuda):
    """ForwardLSS, AdjointLSS and NILSS on the fused MLP field on the card
    raise ForwardModeUnsupported naming it, with no K3 or K4 launch."""
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    prob, _ = _mlp_problem(cuda, B=1)
    with torch.no_grad():
        sol = P.solve(prob, P.Tsit5(), saveat=torch.linspace(0.0, 0.5, 11))
    g = lambda u, p, t: u[0]  # noqa: E731
    mlp.mlp2_fwd_cuda.launches = mlp.mlp2_vjp_cuda.launches = 0
    for build in (lambda: P.ForwardLSSProblem(sol, P.ForwardLSS(g=g)),
                  lambda: P.AdjointLSSProblem(sol, P.AdjointLSS(g=g)),
                  lambda: P.shadow_forward(P.NILSSProblem(
                      prob, P.NILSS(nseg=2, nstep=5), g=g))):
        with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
            build()
    assert mlp.mlp2_fwd_cuda.launches == mlp.mlp2_vjp_cuda.launches == 0


def test_ensemble_on_kernel_field_equals_single_solves(cuda):
    """Two trajectories of the fused MLP field under GaussAdjoint: the
    ensemble's rows equal each trajectory's own solve bit for bit, the
    "vmap" and "shard_map" (one-card mesh) gradients are equal, and equal
    the sum of the single solves' gradients."""
    prob, params = _mlp_problem(cuda, B=2)
    leaves = list(params.values())
    scale = (1.0, 1.5)

    def prob_func(pr, i):
        return P.remake(pr, u0=pr.u0 * scale[i])

    kw = dict(saveat=[0.0, 0.5], sensealg=P.GaussAdjoint(), rtol=1e-8,
              atol=1e-10)
    singles = [P.solve(prob_func(prob, i), P.Tsit5(), **kw) for i in (0, 1)]
    g_single = [sum(gs) for gs in zip(*[
        torch.autograd.grad(torch.sum(s.ys[-1] ** 2), leaves)
        for s in singles])]
    got = {}
    for backend in ("vmap", "shard_map"):
        ens = P.solve_ensemble(P.EnsembleProblem(prob, prob_func), P.Tsit5(),
                               trajectories=2, backend=backend,
                               mesh=P.make_mesh(), **kw)
        for i in (0, 1):
            assert torch.equal(ens.ys[i], singles[i].ys)
        got[backend] = torch.autograd.grad(torch.sum(ens.ys[:, -1] ** 2),
                                           leaves)
    for a, b, c in zip(got["vmap"], got["shard_map"], g_single):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("n,u_off,lam_off", RD1D_CASES,
                         ids=[f"n{n}-u{a}-lam{b}" for n, a, b in RD1D_CASES])
@pytest.mark.parametrize("dtype,tol,dp_tol", [(torch.float64, 1e-12, 1e-10),
                                              (torch.float32, 1e-5, 1e-5)])
def test_kernels_with_shard_ghosts_match_plain_versions(cuda, dtype, tol,
                                                        dp_tol, n, u_off,
                                                        lam_off):
    """K1 and K2 reading a shard's ghost cells from a device buffer
    ([left, right] of u, then of λ) against the plain versions given the
    same ghosts; only the two end cells move off the edge-copy launch's
    bits."""
    u, lam = _rd1d_case(cuda, dtype, n, u_off, lam_off, seed=3)
    p = torch.tensor([1e-7, 1.5], device=cuda, dtype=dtype)
    ghosts = torch.rand(4, device=cuda, dtype=dtype,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    inv_dx2 = float(n) ** 2
    f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2, ghosts[:2].contiguous())
    f_edge = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
    du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam, ghosts)
    f_ref = rd1d.rd1d_reference(u, p, inv_dx2, ghosts[:2])
    du_ref, _ = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam, ghosts)
    _, dp_ref = rd1d.rd1d_vjp_reference(u.double(), p.double(), inv_dx2,
                                        lam.double(), ghosts.double())
    assert torch.allclose(f, f_ref, rtol=0, atol=tol * f_ref.abs().max())
    assert torch.allclose(du, du_ref, rtol=0, atol=tol * du_ref.abs().max())
    diff = (dp.double() - dp_ref).abs()
    assert bool((diff <= dp_tol * dp_ref.abs().clamp_min(1e-300)).all()
                | (dp_ref == 0).all())
    if n > 2:
        assert torch.equal(f[1:-1], f_edge[1:-1])


def test_sharded_flagship_gradient_on_two_ranks(cuda):
    """The flagship PDE (float64, n = 262,144, 64 steps, sensealg=None,
    which dispatches to BacksolveAdjoint) with its state split over two
    gloo ranks that share the card (chip_smoke.py's phase 5q arm, run
    here alone): the gradients equal the unsharded card run's within
    1e-10, each rank launching K1/K2 as often as the unsharded run on n/2
    cells."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C

    out, _ = C.shard_phase(P, rd1d, cuda, torch.cuda.get_device_name(0),
                           cases=((torch.float64, 262144),), arms=("None",),
                           mega=(), s4_arms=())
    assert out["[shard] rank 0"] == out["[shard] rank 1"]
    assert out["[shard] rank 0"]["K1"] > 0 and out["[shard] rank 0"]["K2"] > 0
