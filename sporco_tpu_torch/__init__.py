"""sporco_tpu_torch: the PyTorch/CUDA port of ``sporco_tpu``.

A second package beside the JAX reference.  Module names mirror
``sporco_tpu`` so that every piece has an obvious counterpart:

- :mod:`sporco_tpu_torch.cnvrep`   -- problem dimensions and layouts.
- :mod:`sporco_tpu_torch.ops`      -- FFT glue, the fused ConvBPDN
  driver and the hand-written CUDA kernel (``csc_iter``).
- :mod:`sporco_tpu_torch.solvers`  -- ADMM options, state and AutoRho.
- :mod:`sporco_tpu_torch.models`   -- ``ConvBPDN``.

The package imports ``torch`` and never ``jax``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on the CPU
every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
