"""The seeded fixture of the label-bookkeeping, postprocessing and stitching
tests of the PyTorch port: a boundary-like map of (24, 48, 48) and its
block-wise segmentation in blocks of (12, 24, 24), so that every face
direction occurs.  Imports neither JAX nor the JAX package."""

import numpy as np
from scipy import ndimage

from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.utils import file_reader

SHAPE = (24, 48, 48)
BLOCK = [12, 24, 24]


def make_volumes(seed: int = 0):
    """A boundary-like map in [0, 1] and its block-wise components of
    ``raw < 0.5`` with per-block id offsets (a watershed-like layout)."""
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(SHAPE), 2.0)
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)
    seg = np.zeros(SHAPE, np.uint64)
    offset = 0
    for z in range(0, SHAPE[0], BLOCK[0]):
        for y in range(0, SHAPE[1], BLOCK[1]):
            for x in range(0, SHAPE[2], BLOCK[2]):
                bb = np.s_[z:z + BLOCK[0], y:y + BLOCK[1], x:x + BLOCK[2]]
                lab, n = ndimage.label(raw[bb] < 0.5)
                seg[bb] = np.where(lab > 0, lab + offset, 0)
                offset += n
    return raw, seg


def setup(tmp_path, device="cpu", **extra):
    """``raw``, ``seg`` and ``extra`` datasets in ``tmp_path/d.n5`` (gzip,
    block chunks) and a config dir with the block shape and ``device``;
    returns (path, config_dir, raw, seg)."""
    raw, seg = make_volumes()
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    for key, data in {"raw": raw, "seg": seg, **extra}.items():
        f.create_dataset(key, data=data, chunks=tuple(BLOCK), compression="gzip")
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": device})
    return path, config_dir, raw, seg
