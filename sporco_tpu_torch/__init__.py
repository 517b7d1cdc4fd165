"""sporco_tpu_torch: the PyTorch/CUDA port of ``sporco_tpu``.

A second package beside the JAX reference.  Module names mirror
``sporco_tpu`` so that every piece has an obvious counterpart:

- :mod:`sporco_tpu_torch.cnvrep`   -- problem dimensions and layouts.
- :mod:`sporco_tpu_torch.ops`      -- FFT glue and its dispatch, the
  proximal operators, linear-algebra helpers (the per-bin solves and the
  dense Gram, Cholesky and LU solves), the fused ConvBPDN ADMM driver and FISTA
  problem, and the hand-written CUDA kernels (``csc_iter``,
  ``pgm_iter``, ``rfft2_planar``/``irfft2_planar``, ``admm_tail``).
- :mod:`sporco_tpu_torch.solvers`  -- the generic ADMM driver, options,
  state and AutoRho; the PGM (FISTA) options, state and loop.
- :mod:`sporco_tpu_torch.models`   -- ``cbpdn.ConvBPDN``,
  ``cbpdn.ConvElasticNet`` and ``cbpdn.ConvBPDNGradReg`` (ADMM) and
  masked CSC over them, ``cbpdn.AddMaskSim``; ``pgm.ConvBPDN`` and
  ``pgm.ConvBPDNMask`` (FISTA), each on a fused path and the generic
  FFT path; the dictionary updates ``ccmod.ConvCnstrMOD`` (ADMM) and
  ``pgm.ConvCnstrMOD``/``pgm.ConvCnstrMODMask`` (FISTA), and dictionary
  learning, ``dictlrn.ConvBPDNDictLearn`` and the generic
  ``dictlrn.DictLearn``; the dense BPDN models of ``bpdn`` (``BPDN``,
  ``BPDNJoint``, ``ElasticNet``, ``BPDNProjL1``, ``MinL1InL2Ball``), the
  TV models of ``tv`` and ``rpca.RobustPCA``, the filter-parallel
  ``parcbpdn.ParConvBPDN``; all with checkpoints
  (``save_state``/``load_state_file``).
- :mod:`sporco_tpu_torch.accel`    -- the accelerator API, the
  counterpart of the reference's ``sporco.cuda``: the solvers
  ``cbpdn``, ``cbpdngrd``, ``cbpdnmsk`` and ``cbpdngrdmsk`` and the
  device helpers.
- :mod:`sporco_tpu_torch.parallel` -- the parallel paths on
  ``torch.distributed`` (NCCL on the cards, gloo on CPU ranks): ``mesh``
  and ``launch`` (process groups, the ``("data", "filter")`` mesh, the
  multi-process grid search), consensus dictionary learning on one
  device or sharded over the ``"data"`` ranks, ``gridsearch`` (serial and
  ``torch.func.vmap``) and ``spatial`` (the row-sharded FFT and the
  row-sharded ConvBPDN and TV deconvolution).
- :mod:`sporco_tpu_torch.utils`    -- array helpers, signal processing
  and image metrics, the timers, interpolation, example data and
  dictionary tiling, plotting.

The package imports ``torch`` and never ``jax``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on the CPU
every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
