"""Multiscale NN inference: one prediction fed by center-aligned blocks from
several resolution levels (port of
``cluster_tools_tpu/tasks/multiscale_inference.py``; reference
inference/multiscale_inference.py:31).

Geometry: the blocking lives at scale 0; for each coarser level the block's
offset is mapped through the center-alignment rule (multiscale_inference.py
``_center_align_offset``:195-203) so that all levels look at the same physical
center, then read with their own halo and reflect padding.  The predictor
receives the list of per-scale arrays (finest first), one block at a time:
the levels are ragged.  As in the JAX package, only a user's predictor takes
such a list; the registered predictors take one array."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils import store
from ..utils.blocking import Blocking
from .frameworks import get_preprocessor
from .inference import InferenceTask


def center_align_offset(offset, shape, reference_shape, scale_factor):
    """Offset of the same physical center in a downsampled coordinate system
    (reference multiscale_inference.py:195-203)."""
    center_distance = [
        ref_sh // 2 - off for ref_sh, off in zip(reference_shape, offset)
    ]
    center_distance = [d // sf for d, sf in zip(center_distance, scale_factor)]
    return [sh // 2 - d for sh, d in zip(shape, center_distance)]


def load_multiscale_input(ds, offset, block_shape, halo, scale_factor,
                          reference_shape, padding_mode="reflect"):
    shape = ds.shape
    this_offset = center_align_offset(offset, shape, reference_shape, scale_factor)
    this_block_shape = [bs // sf for bs, sf in zip(block_shape, scale_factor)]
    starts = [off - h for off, h in zip(this_offset, halo)]
    stops = [
        off + bs + h for off, bs, h in zip(this_offset, this_block_shape, halo)
    ]
    pad_left = tuple(max(0, -s) for s in starts)
    pad_right = tuple(max(0, st - sh) for st, sh in zip(stops, shape))
    bb = tuple(
        slice(max(0, s), min(sh, st)) for s, st, sh in zip(starts, stops, shape)
    )
    data = np.asarray(ds[bb])
    if any(pad_left) or any(pad_right):
        data = np.pad(
            data,
            [(pl, pr) for pl, pr in zip(pad_left, pad_right)],
            mode=padding_mode,
        )
    return data


class MultiscaleInferenceTask(InferenceTask):
    """Prediction over center-aligned multi-resolution inputs.

    ``input_path``/``input_key`` are lists (finest scale first);
    ``scale_factors`` gives each level's sampling relative to scale 0 and
    ``halos`` each level's halo in its own coordinates."""

    task_name = "multiscale_inference"

    def __init__(self, *args, input_paths: Sequence[str] = (),
                 input_keys: Sequence[str] = (),
                 scale_factors: Sequence[Sequence[int]] = ((1, 1, 1),),
                 halos: Optional[Sequence[Sequence[int]]] = None,
                 **kwargs):
        kwargs.setdefault("input_path", input_paths[0] if input_paths else None)
        kwargs.setdefault("input_key", input_keys[0] if input_keys else None)
        super().__init__(*args, **kwargs)
        self.input_paths = list(input_paths)
        self.input_keys = list(input_keys)
        self.scale_factors = [
            [sf] * 3 if isinstance(sf, int) else list(sf)
            for sf in scale_factors
        ]
        self.halos = (
            [list(h) for h in halos]
            if halos is not None
            else [list(self.halo)] * len(self.scale_factors)
        )
        if not (
            len(self.input_paths)
            == len(self.input_keys)
            == len(self.scale_factors)
            == len(self.halos)
        ):
            raise ValueError("need one path/key/scale_factor/halo per level")

    def get_shape(self) -> Sequence[int]:
        shape = store.file_reader(self.input_paths[0], "r")[
            self.input_keys[0]
        ].shape
        return shape[-3:] if len(shape) > 3 else shape

    def _load_block(self, block_id, blocking, in_ds, mask_ds):
        block = blocking.block(block_id)
        if mask_ds is not None:
            m = np.asarray(mask_ds[block.slicing]).astype(bool)
            if not m.any():
                return None
        datasets = [
            store.file_reader(p, "r")[k]
            for p, k in zip(self.input_paths, self.input_keys)
        ]
        ref_shape = datasets[0].shape
        return [
            load_multiscale_input(
                ds, block.begin, blocking.block_shape, halo, sf, ref_shape
            )
            for ds, sf, halo in zip(datasets, self.scale_factors, self.halos)
        ]

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): each block's list of preprocessed levels."""
        mask_ds = self._mask_ds()
        preprocess = get_preprocessor(config.get("preprocess", "zero_mean_unit_variance"))
        out = []
        for bid in block_ids:
            data = self._load_block(bid, blocking, None, mask_ds)
            if data is not None:
                out.append((bid, [preprocess(d) for d in data]))
        return out

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2: the predictor once per block on its list of levels."""
        predictor = self.predictor(config)
        return [(bid, predictor(levels)) for bid, levels in payload]
