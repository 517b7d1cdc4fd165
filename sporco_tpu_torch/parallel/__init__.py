"""Parallel dictionary learning (counterpart of ``sporco_tpu.parallel``):
the consensus loop of :mod:`sporco_tpu_torch.parallel.consensus`, on one
device so far."""
