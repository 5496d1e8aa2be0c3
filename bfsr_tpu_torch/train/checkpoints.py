"""Trainer checkpoints: the counterpart of ``bfsr_tpu/train/checkpoints.py``.

A checkpoint is one ``torch.save`` file in the reference's layout
(LINF-LP's ``train.py``): ``{'prior_model': {'name', 'args', 'sd'},
'optimizer': {'name', 'args', 'sd'}, 'epoch': N}``, ``sd`` being a
``state_dict``.  It holds tensors and plain Python values only, so it
loads with ``weights_only=True``; it is written to a temporary file and
renamed, so a crash mid-write leaves the previous one.  The SRFlow-LP
prior trainer's (``cli/srflow_train.py``) has ``iter`` in place of
``epoch``.  The JAX package's orbax form has no counterpart.
"""

import os

import torch


def save_checkpoint(path, payload):
    """Write ``payload`` to ``path`` crash-safe (tmp + rename)."""
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path):
    """A checkpoint's payload, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def train_state(prior, optimizer, optimizer_spec, epoch):
    """The payload of a prior trainer's checkpoint after ``epoch``."""
    return {"prior_model": {**prior.spec(), "sd": prior.state_dict()},
            "optimizer": {**optimizer_spec, "sd": optimizer.state_dict()},
            "epoch": epoch}


def _newest_first(directory, prefix, suffix):
    """The names in ``directory`` that start with ``prefix`` and end with
    ``suffix``, newest (by modification time) first."""
    files = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(suffix)]
    files.sort(key=lambda f: os.path.getmtime(os.path.join(directory, f)),
               reverse=True)
    return files


def find_auto_resume(directory, suffix=".ckpt", prefix=""):
    """The newest checkpoint (by modification time) in ``directory``
    whose name starts with ``prefix`` and ends with ``suffix``, or
    None."""
    if not os.path.isdir(directory):
        return None
    files = _newest_first(directory, prefix, suffix)
    return os.path.join(directory, files[0]) if files else None


def keep_newest(directory, prefix, n_keep=2):
    """Delete all but the ``n_keep`` newest files in ``directory`` whose
    name starts with ``prefix`` (the reference keeps 2,
    ``SRFlow-LP/code/models/base_model.py:95-110``)."""
    for f in _newest_first(directory, prefix, "")[n_keep:]:
        os.remove(os.path.join(directory, f))
