"""Reference-style option dicts (counterpart of ``sporco_tpu.refopts``).

Model constructors accept the reference's nested option dicts, such as
``{'MaxMainIter': 200, 'AutoRho': {'Enabled': False}}``, as their
``opt`` argument: solver keys become fields of the model's native
options (built on ``cls.options()``), model keys become constructor
keyword arguments, display-only keys are ignored and unknown keys raise
:class:`UnknownKeyError`.  The ADMM keys that ``ConvBPDN`` needs and the
PGM keys (``Momentum``, ``StepSizePolicy``, ``Backtrack``, ``AutoStop``)
are ported so far.
"""

import dataclasses
import functools
import inspect
import warnings

__all__ = ["UnknownKeyError", "translate", "wrap_init", "keymap",
           "IGNORE", "WARN", "ADMM_BASE", "PGM_BASE"]


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


def _momentum_kw(v):
    """A reference ``Momentum`` value is a strategy object
    (``sporco/pgm/momentum.py``) or a name; map it by class name, with
    the linear/genlinear parameters where the object has them."""
    if isinstance(v, str):
        return {"momentum": v.lower()}
    name = type(v).__name__
    if "GenLinear" in name:
        out = {"momentum": "genlinear"}
        if hasattr(v, "a"):
            out["momentum_a"] = float(v.a)
        if hasattr(v, "b"):
            out["momentum_b"] = float(v.b)
        return out
    if "Linear" in name:
        out = {"momentum": "linear"}
        if hasattr(v, "a"):
            out["momentum_a"] = float(v.a)
        return out
    if "Nesterov" in name:
        return {"momentum": "nesterov"}
    raise UnknownKeyError(f"unrecognised Momentum value {v!r}")


def _stepsize_kw(v):
    if isinstance(v, str):
        return {"stepsize": v.lower()}
    name = type(v).__name__
    if "Cauchy" in name:
        return {"stepsize": "cauchy"}
    if "BB" in name:
        return {"stepsize": "bb"}
    raise UnknownKeyError(f"unrecognised StepSizePolicy value {v!r}")


def _backtrack_kw(v):
    if isinstance(v, str):
        return {"backtrack": v.lower()}
    name = type(v).__name__
    if "Robust" in name:
        out = {"backtrack": "robust"}
    elif "Standard" in name:
        out = {"backtrack": "standard"}
    else:
        raise UnknownKeyError(f"unrecognised Backtrack value {v!r}")
    if hasattr(v, "gamma_u"):
        out["bt_gamma_u"] = float(v.gamma_u)
    if hasattr(v, "gamma_d"):
        out["bt_gamma_d"] = float(v.gamma_d)
    if hasattr(v, "maxiter"):
        out["bt_maxiter"] = int(v.maxiter)
    return out


# sporco/pgm/pgm.py:160-174
PGM_BASE = {
    "Verbose": ("o", "verbose"),
    "StatusHeader": IGNORE,
    "IterTimer": IGNORE,
    "MaxMainIter": ("o", "max_iter"),
    "RelStopTol": ("o", "rel_stop_tol"),
    "L": ("o", "L"),
    "Monotone": ("o", "monotone"),
    "Momentum": ("omulti", _momentum_kw),
    "StepSizePolicy": ("omulti", _stepsize_kw),
    "Backtrack": ("omulti", _backtrack_kw),
    "AutoStop": ("sub", {"Enabled": ("o", "auto_stop"),
                         "Tau0": ("o", "auto_stop_tau0")}),
    "FastSolve": ("o", "fast_solve"),
    "DataType": ("k", "dtype"),
    "X0": WARN,               # warm start via load_state_dict_numpy
    "Callback": WARN,
}


def keymap(cls):
    """Merge ``REF_OPT_EXTRA`` dicts along the MRO (base first)."""
    out = {}
    for c in reversed(cls.__mro__):
        out.update(c.__dict__.get("REF_OPT_EXTRA", {}))
    return out


def _expand_tuple_keys(opt):
    """Normalise the reference's tuple-key addressing
    (``opt[('AutoRho', 'Period')] = 5``, ``sporco/cdict.py:260-307``)
    into nested dicts, merged with any nested-dict entry for the same
    top-level key.  Later entries win, in insertion order.  The merge is
    one level deep, as in the JAX package: of two tuple keys sharing a
    prefix of two or more levels only the later subtree survives."""
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
            val = {**out[key], **val}
        out[key] = val
    return out


def translate(cls, opt):
    """Translate a reference-style option dict for model class ``cls``.
    Returns ``(opts, kw)``: the native options (built from
    ``cls.options()``) and constructor keyword-argument updates."""
    opt = _expand_tuple_keys(opt)
    kmap = keymap(cls)
    ofields, kw, ar = {}, {}, {}

    def apply(spec, key, val):
        if val is None or spec == IGNORE:
            return
        if spec == WARN:
            if val:
                warnings.warn(f"option {key!r} has no direct equivalent "
                              f"in {cls.__name__}", stacklevel=4)
            return
        if spec == "autorho":
            for k2, v2 in _expand_tuple_keys(val).items():
                if k2 not in _AUTORHO:
                    raise UnknownKeyError(
                        f"unknown AutoRho option key {k2!r}")
                if v2 is not None:
                    ar[_AUTORHO[k2]] = v2
            return
        kind = spec[0]
        if kind == "o":
            ofields[spec[1]] = spec[2](val) if len(spec) > 2 else val
        elif kind == "k":
            kw[spec[1]] = spec[2](val) if len(spec) > 2 else val
        elif kind == "omulti":
            ofields.update(spec[1](val))
        elif kind == "sub":
            for k2, v2 in _expand_tuple_keys(val).items():
                if k2 not in spec[1]:
                    raise UnknownKeyError(
                        f"unknown {key!r} option sub-key {k2!r}")
                apply(spec[1][k2], k2, v2)
        else:  # pragma: no cover - keymap authoring error
            raise ValueError(f"bad keymap spec {spec!r}")

    for key, val in opt.items():
        if key not in kmap:
            raise UnknownKeyError(
                f"unknown option key {key!r} for {cls.__name__} "
                "(reference-style option dict)")
        apply(kmap[key], key, val)
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
    varkw = next((p.name for p in sig.parameters.values()
                  if p.kind is inspect.Parameter.VAR_KEYWORD), None)

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        ba = sig.bind_partial(self, *args, **kwargs)
        opt = ba.arguments.get("opt")
        if isinstance(opt, dict):
            new_opt, kwu = translate(type(self), opt)
            ba.arguments["opt"] = new_opt
            extra = ba.arguments.get(varkw, {}) if varkw else {}
            for k, v in kwu.items():
                if k in sig.parameters and k != varkw:
                    ba.arguments.setdefault(k, v)
                elif varkw is not None:
                    extra.setdefault(k, v)
                else:
                    raise UnknownKeyError(
                        f"option maps to constructor argument {k!r}, "
                        f"which {type(self).__name__} does not accept")
            if varkw and extra:
                ba.arguments[varkw] = extra
            orig(*ba.args, **ba.kwargs)
        else:
            orig(self, *args, **kwargs)

    __init__._refopts_wrapped = True
    cls.__init__ = __init__
