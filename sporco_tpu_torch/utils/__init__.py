"""utils of the PyTorch/CUDA port (counterpart of ``sporco_tpu.utils``):
array helpers, signal processing, image metrics, timers, interpolation,
example data and dictionary tiling, plotting (matplotlib, imported on
first use)."""
