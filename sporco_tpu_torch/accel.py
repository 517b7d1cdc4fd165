"""The accelerator API: the counterpart of the reference's native-GPU
binding ``sporco.cuda`` (``sporco/cuda/__init__.py``, documented in
``docs/source/modules/sporco.cuda.rst:107-239``) and of
``sporco_tpu.accel``.

The four CSC solvers ``cbpdn``, ``cbpdngrd``, ``cbpdnmsk`` and
``cbpdngrdmsk`` are thin functions over the model classes of
:mod:`sporco_tpu_torch.models.cbpdn`, so they take the full generality of
those classes (options as :class:`~sporco_tpu_torch.solvers.admm.ADMMOpts`
or a reference-style option dict, and the classes' keyword arguments)
and return the coefficient maps as a tensor in the reference's layout.
At the geometry of the reference's CUDA solvers (a single-channel 2-D
image) they run the fused driver: ``csc_iter`` for ``cbpdn``, the
gradient x-step and ``admm_tail`` for ``cbpdngrd``, and the AMS form of
``admm_tail`` for the masked two.

They run on the CUDA device ``dev`` unless the caller passes
``device``; without a card they raise unless asked for the CPU
(``device="cpu"``).  The device helpers report on ``torch.cuda`` and
never stand in the CPU for a missing card.
"""

import torch

from sporco_tpu_torch.models import cbpdn as _cbpdn

__all__ = ["cbpdn", "cbpdngrd", "cbpdnmsk", "cbpdngrdmsk", "device_count",
           "current_device", "device_name", "memory_info"]


def _device(dev, device):
    """The solve's device: ``device`` when given, else CUDA device
    ``dev`` (which the model refuses without a card)."""
    return device if device is not None else f"cuda:{int(dev)}"


def cbpdn(D, s, lmbda, opt=None, dev=0, device=None, **kw):
    """Solve ConvBPDN (``sporco.cuda.cbpdn``); returns the coefficient
    maps."""
    return _cbpdn.ConvBPDN(D, s, lmbda, opt=opt, device=_device(dev, device),
                           **kw).solve()


def cbpdngrd(D, s, lmbda, mu, opt=None, dev=0, device=None, **kw):
    """Solve ConvBPDNGradReg (``sporco.cuda.cbpdngrd``)."""
    return _cbpdn.ConvBPDNGradReg(D, s, lmbda, mu=mu, opt=opt,
                                  device=_device(dev, device), **kw).solve()


def cbpdnmsk(D, s, w, lmbda, opt=None, dev=0, device=None, **kw):
    """Solve masked ConvBPDN by Additive Mask Simulation
    (``sporco.cuda.cbpdnmsk``); ``w`` is the fidelity mask."""
    return _cbpdn.AddMaskSim(_cbpdn.ConvBPDN, D, s, w, lmbda, opt=opt,
                             device=_device(dev, device), **kw).solve()


def cbpdngrdmsk(D, s, w, lmbda, mu, opt=None, dev=0, device=None, **kw):
    """Solve masked ConvBPDNGradReg by Additive Mask Simulation
    (``sporco.cuda.cbpdngrdmsk``)."""
    return _cbpdn.AddMaskSim(_cbpdn.ConvBPDNGradReg, D, s, w, lmbda, mu=mu,
                             opt=opt, device=_device(dev, device),
                             **kw).solve()


def device_count():
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count()


def _need_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")


def current_device(id=None):
    """The current CUDA device's index, after making ``id`` current when
    given; raises without a card."""
    _need_card()
    if id is not None:
        torch.cuda.set_device(int(id))
    return torch.cuda.current_device()


def device_name(int_id=0):
    """The name of CUDA device ``int_id``; raises without a card."""
    _need_card()
    return torch.cuda.get_device_name(int_id)


def memory_info():
    """``(free, total)`` bytes of the current CUDA device, or ``(-1, -1)``
    without a card."""
    if not torch.cuda.is_available():
        return (-1, -1)
    return torch.cuda.mem_get_info()
