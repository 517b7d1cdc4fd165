"""sporco_tpu_torch: the PyTorch/CUDA port of ``sporco_tpu``.

A second package beside the JAX reference.  Module names mirror
``sporco_tpu`` so that every piece has an obvious counterpart:

- :mod:`sporco_tpu_torch.cnvrep`   -- problem dimensions and layouts.
- :mod:`sporco_tpu_torch.ops`      -- FFT glue and its dispatch, prox and
  linear-algebra helpers, the fused ConvBPDN ADMM driver and FISTA
  problem, and the hand-written CUDA kernels (``csc_iter``,
  ``pgm_iter``, ``rfft2_planar``/``irfft2_planar``, ``admm_tail``).
- :mod:`sporco_tpu_torch.solvers`  -- the generic ADMM driver, options,
  state and AutoRho; the PGM (FISTA) options, state and loop.
- :mod:`sporco_tpu_torch.models`   -- ``cbpdn.ConvBPDN``,
  ``cbpdn.ConvElasticNet`` and ``cbpdn.ConvBPDNGradReg`` (ADMM),
  ``pgm.ConvBPDN`` and ``pgm.ConvBPDNMask`` (FISTA), each on a fused
  path and the generic FFT path.
- :mod:`sporco_tpu_torch.utils`    -- the timer and ``gradient_filters``.

The package imports ``torch`` and never ``jax``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on the CPU
every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
