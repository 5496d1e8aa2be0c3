"""Host-side helpers: the counterpart of ``bfsr_tpu/utils/misc.py``'s
``Averager``, ``Timer``, ``time_text``, ``compute_num_params``, ``log``
and ``set_save_path`` (the reference's ``LINF-LP/utils.py``).  Scalars go
to a plain JSON-lines file, ``scalars.jsonl``, under the save path."""

import json
import os
import time


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


class Timer:
    """Seconds since construction."""

    def __init__(self):
        self.v = time.time()

    def t(self):
        return time.time() - self.v


def time_text(t):
    if t >= 3600:
        return f"{t / 3600:.1f}h"
    if t >= 60:
        return f"{t / 60:.1f}m"
    return f"{t:.1f}s"


def compute_num_params(module, text=False):
    """The number of parameters of a module, or as '1.2M' / '3.4K'."""
    tot = sum(p.numel() for p in module.parameters())
    if text:
        return f"{tot / 1e6:.1f}M" if tot >= 1e6 else f"{tot / 1e3:.1f}K"
    return tot


_log_path = None


def log(obj, filename="log.txt"):
    """Print, and append to ``filename`` under the save path if one is
    set."""
    print(obj, flush=True)
    if _log_path is not None:
        with open(os.path.join(_log_path, filename), "a") as f:
            print(obj, file=f)


class ScalarWriter:
    """Appends ``{'tag', 'value', 'step'}`` lines to ``scalars.jsonl``."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")

    def add_scalars(self, tag, value_dict, step):
        for k, v in value_dict.items():
            self.add_scalar(f"{tag}/{k}", v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def set_save_path(save_path):
    """Create the save directory, log there, and return (log, writer).
    Never prompts: a run resumes into an existing directory."""
    global _log_path
    os.makedirs(save_path, exist_ok=True)
    _log_path = save_path
    return log, ScalarWriter(save_path)
