"""Multi-label cumulative timers (copy of ``sporco_tpu.utils.timer``)."""

import time

__all__ = ["Timer"]


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
