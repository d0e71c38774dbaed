"""Shadowing methods for chaotic systems (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/shadowing/__init__.py`:
`shadow_forward` and `shadow_adjoint` dispatch on the problem type and
raise TypeError for any other."""

from .lss import AdjointLSSProblem, ForwardLSSProblem
from .lss import shadow_adjoint as _lss_shadow_adjoint
from .lss import shadow_forward as _lss_shadow_forward
from .nilsas import NILSASProblem, nilsas_shadow_adjoint
from .nilss import NILSSProblem, nilss_shadow_forward

__all__ = [
    "ForwardLSSProblem",
    "AdjointLSSProblem",
    "NILSSProblem",
    "NILSASProblem",
    "shadow_forward",
    "shadow_adjoint",
    "nilsas_shadow_adjoint",
]


def shadow_forward(prob, *args, **kwargs):
    """ForwardLSS or NILSS: d⟨g⟩/dp."""
    if isinstance(prob, ForwardLSSProblem):
        return _lss_shadow_forward(prob, *args, **kwargs)
    if isinstance(prob, NILSSProblem):
        return nilss_shadow_forward(prob, *args, **kwargs)
    raise TypeError(f"shadow_forward not defined for {type(prob).__name__}")


def shadow_adjoint(prob, *args, **kwargs):
    """AdjointLSS or NILSAS: d⟨g⟩/dp."""
    if isinstance(prob, AdjointLSSProblem):
        return _lss_shadow_adjoint(prob, *args, **kwargs)
    if isinstance(prob, NILSASProblem):
        return nilsas_shadow_adjoint(prob, *args, **kwargs)
    raise TypeError(f"shadow_adjoint not defined for {type(prob).__name__}")
