"""Parallel paths (counterpart of ``sporco_tpu.parallel``) on
``torch.distributed``: the mesh helpers, launching and the multi-process
grid search, consensus dictionary learning (on one device or sharded
over the mesh's ``"data"`` ranks), the grid search by ``torch.func.vmap``
and the row-sharded solvers."""

from sporco_tpu_torch.parallel import mesh  # noqa: F401
from sporco_tpu_torch.parallel import launch  # noqa: F401
from sporco_tpu_torch.parallel import consensus  # noqa: F401
from sporco_tpu_torch.parallel import gridsearch  # noqa: F401
from sporco_tpu_torch.parallel import spatial  # noqa: F401
