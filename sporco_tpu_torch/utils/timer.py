"""Multi-label cumulative timers and their context manager (copy of
``sporco_tpu.utils.timer``)."""

import time

__all__ = ["Timer", "ContextTimer"]


class Timer:
    """Cumulative timers under string labels, with start/stop/reset/
    elapsed (the solver instrumentation labels ``init``, ``solve``)."""

    def __init__(self, labels=None):
        self.t0 = {}
        self.td = {}
        if labels is not None:
            if not isinstance(labels, (list, tuple)):
                labels = [labels]
            for lbl in labels:
                self.td[lbl] = 0.0
                self.t0[lbl] = None

    def start(self, labels=None):
        if labels is None:
            labels = list(self.td.keys())
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        t = time.time()
        for lbl in labels:
            if lbl not in self.td:
                self.td[lbl] = 0.0
            self.t0[lbl] = t

    def stop(self, labels=None):
        if labels is None:
            labels = list(self.td.keys())
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        t = time.time()
        for lbl in labels:
            if lbl not in self.t0:
                raise KeyError(f"Unrecognised timer label {lbl!r}")
            if self.t0[lbl] is not None:
                self.td[lbl] += t - self.t0[lbl]
                self.t0[lbl] = None

    def reset(self, labels=None):
        if labels is None:
            labels = list(self.td.keys())
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        for lbl in labels:
            self.td[lbl] = 0.0
            self.t0[lbl] = None

    def elapsed(self, label, total=True):
        t = time.time()
        if label not in self.td:
            raise KeyError(f"Unrecognised timer label {label!r}")
        te = self.td[label]
        if total and self.t0.get(label) is not None:
            te += t - self.t0[label]
        return te

    def labels(self):
        return list(self.td.keys())

    def __str__(self):
        return ", ".join(f"{k}: {self.elapsed(k):.3f}s" for k in self.td)


class ContextTimer:
    """Context-manager wrapper around :class:`Timer`
    (``sporco/util.py:808``); with ``action='StopStart'`` the labelled
    timers are *stopped* inside the block (for excluding sections)."""

    def __init__(self, timer=None, label=None, action="StartStop"):
        if action not in ("StartStop", "StopStart"):
            raise ValueError(f"Unrecognised action {action!r}")
        self.timer = timer if timer is not None else Timer()
        self.label = label if label is not None else list(
            self.timer.td.keys()) or "main"
        self.action = action

    def __enter__(self):
        if self.action == "StartStop":
            self.timer.start(self.label)
        else:
            self.timer.stop(self.label)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if self.action == "StartStop":
            self.timer.stop(self.label)
        else:
            self.timer.start(self.label)
        return exc_type is None

    def elapsed(self, total=True):
        lbl = self.label if not isinstance(self.label, (list, tuple)) \
            else self.label[0]
        return self.timer.elapsed(lbl, total=total)
