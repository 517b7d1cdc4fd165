"""General utilities (counterpart of ``sporco_tpu.utils.util``;
capability of ``sporco/util.py``): dictionary tiling for display,
example images and pre-learned dictionaries, the CPU idle count, URL
fetching, and the re-exports of the timers and the grid search.

Example images and dictionaries are read from the data pack in the
repository, ``sporco_tpu/data/`` (by path: the port imports nothing of
the JAX package), or from ``SPORCO_TPU_DATA_PATH`` when set; without
either, a deterministic synthetic fallback gives the same arrays as the
JAX package's.
"""

import os

import numpy as np
import torch

from sporco_tpu_torch.utils.timer import Timer, ContextTimer  # noqa: F401
from sporco_tpu_torch.parallel.gridsearch import grid_search  # noqa: F401

__all__ = ["tiledict", "convdicts", "ExampleImages", "Timer",
           "ContextTimer", "grid_search", "idle_cpu_count",
           "netgetdata"]

_DATA_PATHS = [
    os.environ.get("SPORCO_TPU_DATA_PATH", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "sporco_tpu", "data"),   # the pack
]


def _data_dir():
    for p in _DATA_PATHS:
        if p and os.path.isdir(p):
            return p
    return None


def tiledict(D, sz=None):
    """Tile dictionary atoms into a single image for display
    (``sporco/util.py:285``).  Supports 2D matrix dictionaries (with
    ``sz`` the atom shape), 3D single-channel and 4D multi-channel
    convolutional dictionaries."""
    D = D.detach().cpu().numpy() if isinstance(D, torch.Tensor) \
        else np.asarray(D)
    if D.ndim == 2:
        D = D.reshape(tuple(sz) + (D.shape[1],))
        sz = None
    dsz = D.shape
    axisM = 3 if D.ndim == 4 else 2
    if sz is None:
        sz = np.tile(np.array(dsz[0:2]).reshape([2, 1]),
                     (1, D.shape[axisM]))
    else:
        szni = 3 if D.ndim == 4 else 2
        sz = np.array(sum(tuple((x[0:2],) * x[szni] for x in sz),
                          ())).T
    mxsz = np.amax(sz, 1)
    D = D - D.min()
    D = D / max(D.max(), 1e-12)
    N = dsz[axisM]
    Vr = int(np.floor(np.sqrt(N)))
    Vc = int(np.ceil(N / float(Vr)))
    if D.ndim == 4:
        im = np.ones((Vr * mxsz[0] + Vr - 1, Vc * mxsz[1] + Vc - 1,
                      dsz[2]))
    else:
        im = np.ones((Vr * mxsz[0] + Vr - 1, Vc * mxsz[1] + Vc - 1))
    k = 0
    for l in range(0, Vr):
        for m in range(0, Vc):
            r = mxsz[0] * l + l
            c = mxsz[1] * m + m
            if D.ndim == 4:
                im[r:r + sz[0, k], c:c + sz[1, k], :] = \
                    D[0:sz[0, k], 0:sz[1, k], :, k]
            else:
                im[r:r + sz[0, k], c:c + sz[1, k]] = \
                    D[0:sz[0, k], 0:sz[1, k], k]
            k += 1
            if k >= N:
                break
        if k >= N:
            break
    return im


def convdicts():
    """Access a set of pre-learned convolutional dictionaries
    (``sporco/util.py:356``), as numpy arrays.  Loaded from the data
    pack when it is found; otherwise a deterministic random set."""
    d = _data_dir()
    if d is not None and os.path.isfile(os.path.join(d, "convdict.npz")):
        npz = np.load(os.path.join(d, "convdict.npz"))
        return dict(npz)
    rng = np.random.default_rng(0)
    out = {}
    for key, shape in [("G:8x8x64", (8, 8, 64)),
                       ("G:12x12x36", (12, 12, 36)),
                       ("RGB:8x8x3x64", (8, 8, 3, 64))]:
        D = rng.standard_normal(shape)
        D /= np.sqrt((D ** 2).sum(axis=tuple(range(len(shape) - 1)),
                                  keepdims=True))
        out[key] = D
    return out


class ExampleImages:
    """Access a set of example images (``sporco/util.py:390``).

    Images come from the data pack when it is found (read with imageio
    where installed); otherwise deterministic synthetic images with
    similar statistics are generated, so examples and tests run
    hermetically.  Images are numpy arrays.
    """

    def __init__(self, scaled=False, dtype=None, zoom=None, gray=False,
                 pth=None):
        self.scaled = scaled
        self.dtype = dtype
        self.zoom = zoom
        self.gray = gray
        self.pth = pth if pth is not None else _data_dir()

    def images(self):
        """List available image names."""
        if self.pth and os.path.isdir(self.pth):
            return sorted(f for f in os.listdir(self.pth)
                          if f.endswith(".png"))
        return ["synthetic01.png", "synthetic02.png"]

    def image(self, fname, scaled=None, dtype=None, idxexp=None,
              zoom=None, gray=None):
        """Load (or synthesise) an image by name."""
        scaled = self.scaled if scaled is None else scaled
        dtype = self.dtype if dtype is None else dtype
        zoom = self.zoom if zoom is None else zoom
        gray = self.gray if gray is None else gray
        img = None
        if self.pth:
            fp = os.path.join(self.pth, fname)
            if os.path.isfile(fp):
                try:
                    import imageio.v2 as imageio
                    img = np.asarray(imageio.imread(fp))
                except Exception:
                    img = None
        if img is None:
            img = self._synthetic(fname)
        if img.dtype == np.uint8 and scaled:
            img = img.astype(np.float32) / 255.0
        if dtype is not None:
            img = img.astype(dtype)
        if gray and img.ndim == 3:
            w = np.array([0.299, 0.587, 0.114], dtype=img.dtype)
            img = (img * w).sum(axis=-1)
        if idxexp is not None:
            img = img[idxexp]
        if zoom is not None:
            from scipy.ndimage import zoom as _zoom
            if img.ndim == 2:
                img = _zoom(img, zoom)
            else:
                img = _zoom(img, (zoom, zoom, 1))
        return img

    @staticmethod
    def _synthetic(fname):
        rng = np.random.default_rng(abs(hash(fname)) % (2 ** 31))
        N = 256
        # piecewise-smooth image: random ellipse shapes + texture
        yy, xx = np.mgrid[0:N, 0:N] / N
        img = np.zeros((N, N))
        for _ in range(8):
            cx, cy = rng.random(2)
            a, b = 0.05 + 0.2 * rng.random(2)
            v = rng.random()
            img[((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 < 1] = v
        img += 0.05 * rng.standard_normal((N, N))
        img = np.clip(img, 0, 1)
        return np.stack([img, np.roll(img, 5, 0),
                         np.roll(img, 5, 1)], axis=-1)


def idle_cpu_count(mincpu=1):
    """Estimate of the number of idle CPUs (``sporco/util.py:52``):
    cpu count minus 1-minute load average, floored at ``mincpu``."""
    if hasattr(os, "getloadavg"):
        idle = int(os.cpu_count() - os.getloadavg()[0])
    else:  # pragma: no cover - non-POSIX
        idle = os.cpu_count()
    return max(mincpu, idle)


def netgetdata(url, maxtry=3, timeout=10):
    """Fetch a URL into a BytesIO with retries
    (``sporco/util.py:171``)."""
    import io
    import urllib.error
    import urllib.request
    err = ValueError("maxtry parameter should be greater than zero")
    for _ in range(maxtry):
        try:
            rsp = urllib.request.urlopen(url, timeout=timeout)
            cbio = io.BytesIO(rsp.read())
            break
        except urllib.error.URLError as e:
            err = e
            if not isinstance(e.reason, TimeoutError):
                raise
    else:
        raise err
    return cbio
