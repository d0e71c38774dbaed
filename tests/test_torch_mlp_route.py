"""The route table of the port's fused MLP kernels (`ops/mlp.py:mlp2_route`)
and the CUDA wrappers' refusal of a forced route that cannot take a call.
Both are decided before any launch, so they run here on CPU tensors; the
kernels themselves are tested on the card in tests/test_torch_cuda.py."""

import pytest
import torch

from scimlsensitivity_jl_tpu_torch.ops import mlp

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64


@pytest.mark.parametrize("B,din,hid,dout,dtype,aligned,want", [
    (1024, 512, 2048, 512, BF16, True, "wgmma"),   # S4
    (1000, 264, 1032, 136, BF16, True, "wgmma"),   # partial tiles everywhere
    (1, 8, 8, 8, BF16, True, "wgmma"),             # B is free
    (37, 5, 67, 3, BF16, True, "wmma"),            # ragged widths
    (1024, 512, 2044, 512, BF16, True, "wmma"),    # hid not a multiple of 8
    (1024, 512, 2048, 512, BF16, False, "wmma"),   # an unaligned operand
    (1024, 512, 2048, 512, F32, True, "simt"),
    (1, 2, 50, 2, F32, True, "simt"),              # the spiral
    (1, 2, 50, 2, F64, False, "simt"),
])
def test_mlp2_route_table(B, din, hid, dout, dtype, aligned, want):
    assert mlp.mlp2_route(B, din, hid, dout, dtype, aligned) == want


def test_mlp2_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        mlp.mlp2_route(8, 8, 8, 8, torch.float16, True)


def _inputs(B, din, hid, dout, dtype):
    g = torch.Generator().manual_seed(0)
    make = lambda *s: torch.randn(*s, generator=g).to(dtype)
    return (make(B, din), make(din, hid), make(hid), make(hid, dout),
            make(dout), make(B, hid), make(B, dout))


def _call(wrapper, args, route=None):
    x, w0, b0, w1, b1, h, g = args
    if wrapper == "fwd":
        return mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=route)
    return mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=route)


def _counters():
    return (mlp.mlp2_fwd_cuda.launches, dict(mlp.mlp2_fwd_cuda.routes),
            mlp.mlp2_vjp_cuda.launches, dict(mlp.mlp2_vjp_cuda.routes))


def _edit(i, change):
    """The inputs with the i-th (x, W0, b0, W1, b1, h, g) changed."""
    return lambda args: [change(t) if k == i else t for k, t in enumerate(args)]


@pytest.mark.parametrize("wrapper", ["fwd", "vjp"])
@pytest.mark.parametrize("edit,error,match", [
    (lambda args: [t.half() for t in args], TypeError, "float16"),
    (_edit(0, lambda x: x[0]), ValueError, "matrices"),
    (_edit(0, lambda x: x[:0]), ValueError, "non-empty"),
    (_edit(1, lambda w0: w0[:, :-1]), ValueError, "W0: shape"),
    (_edit(3, lambda w1: w1.double()), ValueError, "W1: .*float64"),
    (_edit(1, lambda w0: w0.T.contiguous().T), ValueError, "W0 must be contiguous"),
], ids=["float16", "x-not-a-matrix", "empty-batch", "W0-shape", "W1-dtype",
        "W0-column-major"])
def test_wrappers_refuse_what_no_kernel_takes(wrapper, edit, error, match):
    """A call that no route can take raises before any launch, whatever the
    route: the launch and route counters stay put."""
    args = edit(_inputs(8, 8, 16, 8, BF16))
    before = _counters()
    with pytest.raises(error, match=match):
        _call(wrapper, args)
    assert _counters() == before


@pytest.mark.parametrize("wrapper", ["fwd", "vjp"])
def test_an_unaligned_operand_cannot_be_forced_onto_wgmma(wrapper):
    """x 2 bytes past a 16-byte boundary: TMA cannot read it, so
    mlp2_route gives WMMA and a forced wgmma route raises before launch."""
    args = list(_inputs(8, 8, 16, 8, BF16))
    buf = torch.empty(args[0].numel() + 1, dtype=BF16)
    args[0] = buf[1:].view(8, 8).copy_(args[0])
    assert args[0].data_ptr() % 16 and args[0].is_contiguous()
    before = _counters()
    with pytest.raises(ValueError, match="aligned operands False; mlp2_route "
                                         "gives 'wmma'"):
        _call(wrapper, args, route="wgmma")
    assert _counters() == before


@pytest.mark.parametrize("wrapper", ["fwd", "vjp"])
@pytest.mark.parametrize("shape,dtype,route,match", [
    ((37, 5, 67, 3), BF16, "wgmma", "cannot take"),  # widths not multiples of 8
    ((8, 8, 16, 8), F32, "wgmma", "cannot take"),
    ((8, 8, 16, 8), F32, "wmma", "cannot take"),
    ((8, 8, 16, 8), BF16, "simt", "cannot take"),
    ((8, 8, 16, 8), BF16, "cublas", "unknown route"),
])
def test_wrappers_refuse_a_forced_route_they_cannot_take(wrapper, shape, dtype,
                                                         route, match):
    """A forced route that cannot take the call raises before any launch:
    the launch and route counters stay put."""
    before = _counters()
    with pytest.raises(ValueError, match=match):
        _call(wrapper, _inputs(*shape, dtype), route=route)
    assert _counters() == before


def test_a_route_that_fits_still_needs_the_card():
    """WMMA can take an aligned bfloat16 shape, so forcing it passes the
    route check; a CPU tensor is then refused as on every route."""
    x, w0, b0, w1, b1, _, _ = _inputs(8, 8, 16, 8, BF16)
    with pytest.raises(ValueError, match="CUDA"):
        mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route="wmma")
