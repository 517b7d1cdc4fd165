"""A fixture of the Jacobi SVD's tests on the CPU
(``tests/test_torch_svd.py``) and on the card (``tests/test_torch_cuda.py``):
:func:`clusters` forces the size of the kernels' clusters."""

import pytest

from sporco_tpu_torch.ops import svd as tsvd


@pytest.fixture
def clusters(monkeypatch):
    """``set(C)`` makes :func:`svd.geometry` give clusters of C blocks (the
    route, shared or global, as ``shared_rows`` gives it at that C) to the
    real and the complex form."""
    geo0 = tsvd.geometry

    def set_c(C):
        def geometry(m, n, itemsize=8):
            g = geo0(m, n, itemsize)
            return g._replace(C=C, shared=tsvd.shared_rows(g.L, g.w, C,
                                                           itemsize))
        monkeypatch.setattr(tsvd, "geometry", geometry)
    return set_c
