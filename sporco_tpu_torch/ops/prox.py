"""Proximal operators (counterpart of ``sporco_tpu.ops.prox``): the l1
norm and its shrinkage, complex-aware.  Reductions over ``axis`` keep
their dimensions, as in the JAX package."""

import torch

__all__ = ["zdivide", "norm_l1", "prox_l1"]


def zdivide(a, b):
    """Element-wise division returning 0 where the denominator is 0
    (``sporco/array.py:119``)."""
    ok = b != 0
    return torch.where(ok, a, 0) / torch.where(ok, b, 1)


def _sign(v):
    """Sign for real input, unit phase ``v/|v|`` for complex input
    (``sporco/prox/_lp.py:144``)."""
    if v.is_complex():
        return zdivide(v, v.abs())
    return torch.sign(v)


def norm_l1(x, axis=None):
    """l1 norm, optionally per slice over ``axis``."""
    if axis is None:
        return torch.sum(x.abs())
    return torch.sum(x.abs(), dim=axis, keepdim=True)


def prox_l1(v, alpha):
    """Soft thresholding (scalar shrinkage); complex-aware."""
    return _sign(v) * torch.clamp(v.abs() - alpha, min=0)
