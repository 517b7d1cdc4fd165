"""Plotting wrappers (counterpart of ``sporco_tpu.utils.plot``;
capability of ``sporco/plot.py``): ``plot``, ``surf``, ``contour``,
``imview``, plus ``close`` and the matplotlib config helpers.  All
functions accept tensors (taken through ``.detach().cpu()``) or numpy
arrays.

matplotlib is imported lazily, on the first plotting call: importing
this module needs no display stack, and where matplotlib is not
installed a plotting call raises ``ImportError``.
"""

import numpy as np
import torch

__all__ = ["plot", "surf", "contour", "imview", "close",
           "attach_keypress", "attach_zoom", "set_ipython_plot_backend",
           "set_notebook_plot_backend", "config_notebook_plotting",
           "set_ipython_plot_pos"]


def _attach_hooks(fig, ax, created_fig, zoom=True):
    """Attach the interactive keypress (and optionally zoom) handlers
    to figures this module created, when a display is present."""
    if not (created_fig and _interactive_hooks and _has_display()):
        return
    attach_keypress(fig)
    if zoom and ax is not None:
        attach_zoom(ax)


def _mpl():
    import matplotlib
    if matplotlib.get_backend().lower() not in ("agg",) and \
            not _has_display():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _has_display():
    import os
    return bool(os.environ.get("DISPLAY"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot(y, x=None, ptyp="plot", xlbl=None, ylbl=None, title=None,
         lgnd=None, lglc=None, fig=None, ax=None, **kwargs):
    """Plot points or lines in 2D (``sporco/plot.py:179``)."""
    plt = _mpl()
    created = fig is None
    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.gca()
    pltfn = getattr(ax, ptyp)
    y = _np(y)
    if x is None:
        lines = pltfn(y, **kwargs)
    else:
        lines = pltfn(_np(x), y, **kwargs)
    if title is not None:
        ax.set_title(title)
    if xlbl is not None:
        ax.set_xlabel(xlbl)
    if ylbl is not None:
        ax.set_ylabel(ylbl)
    if lgnd is not None:
        ax.legend(lgnd, loc=lglc)
    _attach_hooks(fig, ax, created)
    return fig, ax


def surf(z, x=None, y=None, elev=None, azim=None, xlbl=None, ylbl=None,
         zlbl=None, title=None, cmap=None, fig=None, ax=None, **kwargs):
    """Plot a 2D surface in 3D (``sporco/plot.py:331``)."""
    plt = _mpl()
    created = fig is None
    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot(111, projection="3d")
    z = _np(z)
    if x is None or y is None:
        x, y = np.meshgrid(np.arange(z.shape[1]), np.arange(z.shape[0]))
    else:
        x, y = np.meshgrid(_np(x), _np(y))
    ax.plot_surface(x, y, z, cmap=cmap, **kwargs)
    if elev is not None or azim is not None:
        ax.view_init(elev=elev, azim=azim)
    for v, f in [(xlbl, ax.set_xlabel), (ylbl, ax.set_ylabel),
                 (zlbl, ax.set_zlabel), (title, ax.set_title)]:
        if v is not None:
            f(v)
    _attach_hooks(fig, ax, created, zoom=False)
    return fig, ax


def contour(z, x=None, y=None, v=5, xlog=False, ylog=False, xlbl=None,
            ylbl=None, title=None, cfntsz=10, lfntsz=None, cmap=None,
            fig=None, ax=None, **kwargs):
    """Contour plot of a 2D surface (``sporco/plot.py:444``)."""
    plt = _mpl()
    created = fig is None
    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.gca()
    z = _np(z)
    if x is None or y is None:
        x, y = np.meshgrid(np.arange(z.shape[1]), np.arange(z.shape[0]))
    else:
        x, y = np.meshgrid(_np(x), _np(y))
    cs = ax.contour(x, y, z, v, cmap=cmap, **kwargs)
    if cfntsz is not None and cfntsz > 0:
        ax.clabel(cs, inline=True, fontsize=cfntsz)
    if xlog:
        ax.set_xscale("log")
    if ylog:
        ax.set_yscale("log")
    for v_, f in [(xlbl, ax.set_xlabel), (ylbl, ax.set_ylabel),
                  (title, ax.set_title)]:
        if v_ is not None:
            f(v_)
    _attach_hooks(fig, ax, created)
    return fig, ax


def imview(img, title=None, copy=True, fltscl=False, intrp="nearest",
           norm=None, cbar=False, cmap=None, fig=None, ax=None,
           **kwargs):
    """Display an image (``sporco/plot.py:575``)."""
    plt = _mpl()
    created = fig is None
    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.gca()
    img = _np(img)
    if copy:
        img = img.copy()
    if img.dtype.kind == "f" and fltscl:
        img = img - img.min()
        img = img / max(img.max(), 1e-12)
    im = ax.imshow(img, interpolation=intrp, norm=norm, cmap=cmap,
                   **kwargs)
    if cbar:
        fig.colorbar(im, ax=ax)
    if title is not None:
        ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    _attach_hooks(fig, ax, created)
    return fig, ax


def attach_keypress(fig, scaling=1.1):
    """Attach keypress handlers to a figure (capability of
    ``sporco/plot.py:39``): 'q' closes the figure, 'e' enlarges it by
    ``scaling``, 'r' reduces it.  Returns the handler so it can be
    detached with ``fig.canvas.mpl_disconnect``."""
    plt = _mpl()

    def on_key(event):
        if event.key == "q":
            plt.close(fig)
        elif event.key in ("e", "r"):
            f = scaling if event.key == "e" else 1.0 / scaling
            w, h = fig.get_size_inches()
            fig.set_size_inches(w * f, h * f, forward=True)
            fig.canvas.draw_idle()

    fig.canvas.mpl_connect("key_press_event", on_key)
    return on_key


def attach_zoom(ax, scaling=2.0):
    """Attach scroll-wheel zoom to an axes (capability of
    ``sporco/plot.py:80``): scrolling up zooms in around the cursor by
    ``scaling``, scrolling down zooms out; the view never grows beyond
    the original data limits.  Returns the handler."""
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()

    def _new_range(lo, hi, centre, factor, full_lo, full_hi):
        span = (hi - lo) / factor
        rel = (centre - lo) / (hi - lo)
        nlo = centre - span * rel
        nhi = centre + span * (1.0 - rel)
        if abs(nhi - nlo) >= abs(full_hi - full_lo):
            return full_lo, full_hi
        return nlo, nhi

    def on_scroll(event):
        if event.inaxes is not ax or event.xdata is None:
            return
        factor = scaling if event.button == "up" else 1.0 / scaling
        ax.set_xlim(*_new_range(*ax.get_xlim(), event.xdata, factor,
                                x0, x1))
        ax.set_ylim(*_new_range(*ax.get_ylim(), event.ydata, factor,
                                y0, y1))
        ax.figure.canvas.draw_idle()

    ax.figure.canvas.mpl_connect("scroll_event", on_scroll)
    return on_scroll


def close(fig=None):
    """Close figure(s) (``sporco/plot.py:748``)."""
    plt = _mpl()
    if fig is None:
        plt.close("all")
    else:
        plt.close(fig)


def set_ipython_plot_backend(backend="qt"):
    """Set the matplotlib backend in an ipython console session
    (capability of ``sporco/plot.py:722``); no-op outside ipython."""
    try:
        from IPython import get_ipython
        ip = get_ipython()
        if ip is not None:
            ip.run_line_magic("matplotlib", backend)
    except Exception:
        pass


def set_notebook_plot_backend(backend="inline"):
    """Set the matplotlib backend in a notebook session (capability of
    ``sporco/plot.py:745``); no-op outside a notebook."""
    set_ipython_plot_backend(backend)


def config_notebook_plotting():
    """In a notebook: switch to the inline backend and disable the
    interactive keypress/zoom hooks, which have no effect there
    (capability of ``sporco/plot.py:768``); no-op elsewhere."""
    try:
        from IPython import get_ipython
        ip = get_ipython()
        if ip is None or "ZMQ" not in type(ip).__name__:
            return
    except Exception:
        return
    set_notebook_plot_backend("inline")
    global _interactive_hooks
    _interactive_hooks = False


def set_ipython_plot_pos():  # pragma: no cover - notebook helper
    """Compat no-op for the reference's notebook backend helper."""
    return None


# interactive keypress/zoom hooks are attached to newly-created figures
# when a display is present (disabled by config_notebook_plotting)
_interactive_hooks = True
