"""Image quality metrics (counterpart of ``sporco_tpu.utils.metric``,
``sporco/metric.py:37-300``): the mean absolute and squared errors, the
SNR family, PAMSE and GMSD.  Each takes numpy arrays or tensors and
returns a 0-d tensor; PAMSE and GMSD filter by DFT-domain convolution
with a symmetric boundary, as the JAX package does."""

import numpy as np
import torch

from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.utils.signal import _as_tensor, _pad_symmetric

__all__ = ["mae", "mse", "snr", "psnr", "isnr", "bsnr", "pamse", "gmsd"]


def mae(vref, vcmp):
    """Mean absolute error."""
    return torch.mean(torch.abs(_as_tensor(vref) - _as_tensor(vcmp)))


def mse(vref, vcmp):
    """Mean squared error."""
    return torch.mean(torch.abs(_as_tensor(vref) - _as_tensor(vcmp)) ** 2)


def _var(x):
    return torch.var(_as_tensor(x), unbiased=False)


def snr(vref, vcmp):
    """Signal-to-noise ratio in dB: ``10 log10(var(ref) / mse)``."""
    return 10.0 * torch.log10(_var(vref) / mse(vref, vcmp))


def psnr(vref, vcmp, rng=None):
    """Peak SNR in dB; the peak ``rng`` defaults to the range of
    ``vref`` (``sporco/metric.py:115``)."""
    if rng is None:
        v = _as_tensor(vref)
        rng = torch.abs(torch.max(v) - torch.min(v))
    return 10.0 * torch.log10(torch.as_tensor(rng + 0.0) ** 2
                              / mse(vref, vcmp))


def isnr(vref, vdeg, vrst):
    """Improvement SNR in dB of a restored ``vrst`` over a degraded
    ``vdeg``."""
    return 10.0 * torch.log10(mse(vref, vdeg) / mse(vref, vrst))


def bsnr(vblr, vnsy):
    """Blurred SNR in dB of the noise-free blurred ``vblr`` and its noisy
    ``vnsy``."""
    return 10.0 * torch.log10(_var(vblr) / _var(_as_tensor(vnsy)
                                                - _as_tensor(vblr)))


def _conv2_same_symm(x, h):
    """2-D "same" convolution of ``x`` with ``h`` under a symmetric
    boundary, by the DFT."""
    hr, hc = h.shape
    pr, pc = hr // 2, hc // 2
    xp = _pad_symmetric(x, ((pr, hr - 1 - pr), (pc, hc - 1 - pc)))
    full = sf.fftconv(h.to(xp.dtype), xp, axes=(0, 1))
    return full[hr - 1:hr - 1 + x.shape[0], hc - 1:hc - 1 + x.shape[1]]


def pamse(vref, vcmp, rescale=True):
    """Perceptual-fidelity aware MSE (xue-2013-perceptual): the energy of
    the error map filtered by a Gaussian of sd 0.8 (radius 4 sd)."""
    vref = _as_tensor(vref)
    dt = torch.float64 if vref.dtype == torch.float64 else torch.float32
    emap = vref.to(dt) - _as_tensor(vcmp).to(dt)
    if rescale:
        emap = emap * (255.0 / torch.max(vref))
    sigma = 0.8
    rad = int(4 * sigma + 0.5)
    x = np.arange(-rad, rad + 1)
    g1 = np.exp(-x ** 2 / (2 * sigma ** 2))
    g1 = g1 / g1.sum()
    h = torch.as_tensor(np.outer(g1, g1), dtype=dt).to(emap.device)
    return torch.mean(_conv2_same_symm(emap, h) ** 2)


def gmsd(vref, vcmp, rescale=True, returnMap=False):
    """Gradient magnitude similarity deviation (xue-2014-gradient), in
    float32; with ``returnMap`` also the similarity map."""
    vref = _as_tensor(vref).to(torch.float32)
    vcmp = _as_tensor(vcmp).to(torch.float32)
    dev = vref.device
    scl = (255.0 / torch.max(vref)) if rescale else 1.0
    T = 170.0
    dwn = 2
    dx = torch.tensor([[1, 0, -1]] * 3, dtype=torch.float32,
                      device=dev) / 3.0
    dy = dx.T
    ukrn = torch.ones((2, 2), dtype=torch.float32, device=dev) / 4.0
    ave1 = _conv2_same_symm(scl * vref, ukrn)[0::dwn, 0::dwn]
    ave2 = _conv2_same_symm(scl * vcmp, ukrn)[0::dwn, 0::dwn]
    g1 = torch.sqrt(_conv2_same_symm(ave1, dx) ** 2
                    + _conv2_same_symm(ave1, dy) ** 2)
    g2 = torch.sqrt(_conv2_same_symm(ave2, dx) ** 2
                    + _conv2_same_symm(ave2, dy) ** 2)
    qmap = (2 * g1 * g2 + T) / (g1 ** 2 + g2 ** 2 + T)
    score = torch.std(qmap, unbiased=False)
    return (score, qmap) if returnMap else score
