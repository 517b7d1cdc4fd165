"""Reference-style option dicts (counterpart of ``sporco_tpu.refopts``).

Model constructors accept the reference's nested option dicts, such as
``{'MaxMainIter': 200, 'AutoRho': {'Enabled': False}}``, as their
``opt`` argument: solver keys become fields of the model's native
options (built on ``cls.options()``), model keys become constructor
keyword arguments, display-only keys are ignored and unknown keys raise
:class:`UnknownKeyError`.  Only the ADMM keys that ``ConvBPDN`` needs
are ported so far.

One deliberate difference from the JAX package: tuple keys that share a
prefix of two or more levels are merged deeply, so
``{('A', 'B', 'x'): 1, ('A', 'B', 'y'): 2}`` keeps both leaves (the JAX
package's shallow merge keeps only ``y``).
"""

import dataclasses
import functools
import inspect
import warnings

__all__ = ["UnknownKeyError", "translate", "wrap_init", "keymap",
           "IGNORE", "WARN", "ADMM_BASE"]


class UnknownKeyError(KeyError):
    """Unknown option key."""

    def __str__(self):
        return self.args[0] if self.args else ""


IGNORE = "ignore"     # accepted, no effect here (display-only plumbing)
WARN = "warn"         # capability expressed differently; warn if truthy


_AUTORHO = {"Enabled": "enabled", "Period": "period",
            "Scaling": "scaling", "RsdlRatio": "rsdl_ratio",
            "RsdlTarget": "rsdl_target", "AutoScaling": "auto_scaling",
            "StdResiduals": "std_residuals"}


def _not(v):
    return not v


ADMM_BASE = {
    "Verbose": ("o", "verbose"),
    "StatusHeader": IGNORE,
    "IterTimer": IGNORE,
    "MaxMainIter": ("o", "max_iter"),
    "AbsStopTol": ("o", "abs_stop_tol"),
    "RelStopTol": ("o", "rel_stop_tol"),
    "RelaxParam": ("o", "relax_param"),
    "rho": ("o", "rho"),
    "FastSolve": ("o", "fast_solve"),
    "DataType": ("k", "dtype"),
    "Y0": ("k", "Y0"),
    "U0": ("k", "U0"),
    "Callback": WARN,
    "AutoRho": "autorho",
}

_ADMM_EQUAL = {
    "fEvalX": IGNORE,
    "gEvalY": IGNORE,
    "ReturnX": IGNORE,
    "ReturnVar": IGNORE,
}


def keymap(cls):
    """Merge ``REF_OPT_EXTRA`` dicts along the MRO (base first)."""
    out = {}
    for c in reversed(cls.__mro__):
        out.update(c.__dict__.get("REF_OPT_EXTRA", {}))
    return out


def _deep_merge(a, b):
    """Merge nested dict ``b`` into a copy of ``a``; leaves of ``b``
    win, siblings of both survive."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(out.get(k), dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _expand_tuple_keys(opt):
    """Normalise tuple-key addressing (``opt[('AutoRho', 'Period')]``)
    into nested dicts, merged deeply with any nested-dict entries for
    the same subtree.  Later entries win, in insertion order."""
    if not any(isinstance(k, tuple) for k in opt):
        return opt
    out = {}
    for key, val in opt.items():
        if isinstance(key, tuple):
            if not key:
                raise UnknownKeyError("empty tuple option key")
            for k in reversed(key[1:]):
                val = {k: val}
            key = key[0]
        if isinstance(out.get(key), dict) and isinstance(val, dict):
            val = _deep_merge(out[key], val)
        out[key] = val
    return out


def translate(cls, opt):
    """Translate a reference-style option dict for model class ``cls``.
    Returns ``(opts, kw)``: the native options (built from
    ``cls.options()``) and constructor keyword-argument updates."""
    opt = _expand_tuple_keys(opt)
    kmap = keymap(cls)
    ofields, kw, ar = {}, {}, {}
    for key, val in opt.items():
        if key not in kmap:
            raise UnknownKeyError(
                f"unknown option key {key!r} for {cls.__name__} "
                "(reference-style option dict)")
        spec = kmap[key]
        if val is None or spec == IGNORE:
            continue
        if spec == WARN:
            if val:
                warnings.warn(f"option {key!r} has no direct equivalent "
                              f"in {cls.__name__}", stacklevel=3)
            continue
        if spec == "autorho":
            for k2, v2 in _expand_tuple_keys(val).items():
                if k2 not in _AUTORHO:
                    raise UnknownKeyError(
                        f"unknown AutoRho option key {k2!r}")
                if v2 is not None:
                    ar[_AUTORHO[k2]] = v2
            continue
        kind, name = spec[0], spec[1]
        v = spec[2](val) if len(spec) > 2 else val
        if kind == "o":
            ofields[name] = v
        elif kind == "k":
            kw[name] = v
        else:  # pragma: no cover - keymap authoring error
            raise ValueError(f"bad keymap spec {spec!r}")
    opts = cls.options(**ofields)
    if ar:
        opts = opts.replace(
            auto_rho=dataclasses.replace(opts.auto_rho, **ar))
    return opts, kw


def wrap_init(cls):
    """Install the dict-accepting constructor wrapper on ``cls`` if it
    defines its own ``__init__`` with an ``opt`` parameter."""
    orig = cls.__dict__.get("__init__")
    if orig is None or getattr(orig, "_refopts_wrapped", False):
        return
    sig = inspect.signature(orig)
    if "opt" not in sig.parameters:
        return

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        ba = sig.bind_partial(self, *args, **kwargs)
        opt = ba.arguments.get("opt")
        if isinstance(opt, dict):
            new_opt, kwu = translate(type(self), opt)
            ba.arguments["opt"] = new_opt
            for k, v in kwu.items():
                if k not in sig.parameters:
                    raise UnknownKeyError(
                        f"option maps to constructor argument {k!r}, "
                        f"which {type(self).__name__} does not accept")
                ba.arguments.setdefault(k, v)
            orig(*ba.args, **ba.kwargs)
        else:
            orig(self, *args, **kwargs)

    __init__._refopts_wrapped = True
    cls.__init__ = __init__
