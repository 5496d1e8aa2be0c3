"""``image-folder``: the images of a directory as float32 HWC arrays in
[0, 1]; ``image-folder-DF2K``, DIV2K's folder then Flickr2K's; and
``paired-image-folders``, two folders item by item: the counterparts of
``bfsr_tpu/data/image_folder.py``'s (the reference's
``LINF-LP/datasets/image_folder.py``).

Cache modes: 'none' (decode at each access), 'bin' (a one-time pickle of
each decoded uint8 array in ``bin_<folder>`` beside the folder) and
'in_memory' (decoded once, here).  PIL is imported where an image is
decoded.
"""

import json
import os
import pickle

import numpy as np

from bfsr_tpu_torch.registry import register


def _decode(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


@register("image-folder")
class ImageFolder:
    def __init__(self, root_path, split_file=None, split_key=None,
                 first_k=None, repeat=1, cache="none"):
        self.repeat = repeat
        self.cache = cache
        if split_file is None:
            filenames = sorted(os.listdir(root_path))
        else:
            with open(split_file) as f:
                filenames = json.load(f)[split_key]
        if first_k is not None:
            filenames = filenames[:first_k]
        self.files = []
        for filename in filenames:
            file = os.path.join(root_path, filename)
            if cache == "none":
                self.files.append(file)
            elif cache == "bin":
                bin_root = os.path.join(os.path.dirname(root_path),
                                        "bin_" + os.path.basename(root_path))
                os.makedirs(bin_root, exist_ok=True)
                bin_file = os.path.join(bin_root,
                                        filename.split(".")[0] + ".pkl")
                if not os.path.exists(bin_file):
                    with open(bin_file, "wb") as f:
                        pickle.dump(_decode(file), f)
                self.files.append(bin_file)
            elif cache == "in_memory":
                self.files.append(_decode(file).astype(np.float32) / 255.0)
            else:
                raise ValueError(cache)

    def __len__(self):
        return len(self.files) * self.repeat

    def __getitem__(self, idx):
        x = self.files[idx % len(self.files)]
        if self.cache == "none":
            return _decode(x).astype(np.float32) / 255.0
        if self.cache == "bin":
            with open(x, "rb") as f:
                return np.asarray(pickle.load(f), np.float32) / 255.0
        return x


@register("image-folder-DF2K")
class ImageFolderDF2K:
    """DIV2K's images (cached per ``cache``, as ``image-folder`` caches
    them) then Flickr2K's (always decoded at each access), each folder in
    sorted order and cut to its ``first_k``."""

    def __init__(self, root_path_D2K, root_path_F2K, first_k=None, repeat=1,
                 cache="none"):
        self.repeat = repeat
        self.cache = cache
        self.files = list(ImageFolder(root_path_D2K, first_k=first_k,
                                      cache=cache).files)
        filenames = sorted(os.listdir(root_path_F2K))
        if first_k is not None:
            filenames = filenames[:first_k]
        self.files.extend(os.path.join(root_path_F2K, f) for f in filenames)

    def __len__(self):
        return len(self.files) * self.repeat

    def __getitem__(self, idx):
        x = self.files[idx % len(self.files)]
        if not isinstance(x, str):
            return x
        if x.endswith(".pkl"):
            with open(x, "rb") as f:
                return np.asarray(pickle.load(f), np.float32) / 255.0
        return _decode(x).astype(np.float32) / 255.0


@register("paired-image-folders")
class PairedImageFolders:
    """Two ``image-folder`` s item by item (LR, HR), with the same
    arguments and cache mode."""

    def __init__(self, root_path_1, root_path_2, **kwargs):
        self.dataset_1 = ImageFolder(root_path_1, **kwargs)
        self.dataset_2 = ImageFolder(root_path_2, **kwargs)

    def __len__(self):
        return len(self.dataset_1)

    def __getitem__(self, idx):
        return self.dataset_1[idx], self.dataset_2[idx]
