"""Host-side helpers: the counterpart of ``bfsr_tpu/utils/misc.py``'s
``Averager``."""


class Averager:
    """Running weighted mean."""

    def __init__(self):
        self.n = 0.0
        self.v = 0.0

    def add(self, v, n=1.0):
        self.v = (self.v * self.n + float(v) * n) / (self.n + n)
        self.n += n

    def item(self):
        return self.v
