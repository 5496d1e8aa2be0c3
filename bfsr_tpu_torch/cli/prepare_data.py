"""DIV2K / DF2K crop pickles for SRFlow training: the counterpart of
``prepare_data.py`` (SRFlow-LP's ``code/prepare_data.py``), without jax.

    python -m bfsr_tpu_torch.cli.prepare_data /path/to/DIV2K_train_HR

Writes ``<parent>/pkls/<name>.pklv4`` (160 px HR crops, 47 an image, from
``np.random.default_rng(0)``), ``<name>_X4.pklv4`` (their MATLAB-bicubic
x1/4 LQ, ``ops/imresize.py``) and the first 1% of each as
``<name>_1pct.pklv4`` / ``<name>_X4_1pct.pklv4``: the pickles
``data/pkl_dataset.py`` (``lrhr-pkl``) reads.  The images are read in
natural order (``utils/measure.natsorted``) and the pairs shuffled with
``random.Random(0)``, as the JAX script does, so both write the same
files (the JAX script names a 1% file by the first dot of its whole
path; here by the file name's, the same where no parent holds a dot).
"""

import os
import pickle
import random
import sys

import numpy as np

from bfsr_tpu_torch.ops.imresize import imresize
from bfsr_tpu_torch.utils.measure import natsorted


def random_crop(img, size, rng):
    h, w = img.shape[:2]
    hs = rng.integers(0, h - size)
    ws = rng.integers(0, w - size)
    return img[hs: hs + size, ws: ws + size]


def to_pklv4(obj, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    print(f"dumped {len(obj)} crops to {path}")


def main(dir_path, crops_per_image=47, crop_size=160, scale=4, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = natsorted(
        os.path.join(dir_path, p) for p in os.listdir(dir_path)
        if p.lower().endswith((".png", ".jpg", ".jpeg")))
    hrs, lqs = [], []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        for _ in range(crops_per_image):
            crop = random_crop(img, crop_size, rng)
            hrs.append(crop)
            lqs.append(imresize(crop, scale=1.0 / scale))
    combined = list(zip(hrs, lqs))
    random.Random(seed).shuffle(combined)
    hrs[:], lqs[:] = zip(*combined)

    base_dir = os.path.dirname(dir_path.rstrip("/"))
    name = os.path.basename(dir_path.rstrip("/"))
    hrs_path = os.path.join(base_dir, "pkls", name + ".pklv4")
    lqs_path = os.path.join(base_dir, "pkls", name + f"_X{scale}.pklv4")
    to_pklv4(hrs, hrs_path)
    to_pklv4(lqs, lqs_path)
    n = int(round(len(hrs) * 0.01))
    to_pklv4(hrs[:n], _one_pct(hrs_path))
    to_pklv4(lqs[:n], _one_pct(lqs_path))


def _one_pct(path):
    """``pkls/<name>_1pct.pklv4`` beside ``pkls/<name>.pklv4``."""
    head, tail = os.path.split(path)
    return os.path.join(head, tail.replace(".", "_1pct.", 1))


if __name__ == "__main__":
    if len(sys.argv) < 2 or not os.path.isdir(sys.argv[1]):
        raise SystemExit("usage: python -m bfsr_tpu_torch.cli.prepare_data "
                         "<folder of HR images>")
    main(sys.argv[1])
