"""Distributed NN inference over halo'd blocks (port of
``cluster_tools_tpu/tasks/inference.py``; reference inference/inference.py:30
``InferenceBase`` and its per-block 5-stage pipeline, :217-327).

  * blocks are read with reflect-padded halos (``_load_input`` semantics,
    inference.py:175-205), tested against the mask and preprocessed on the
    host (the ``read_batch`` stage, over ``prefetch_threads``);
  * the forward runs on the task's device in groups of ``batch_size``
    (``compute_batch``; frameworks.py's predictors, halo cropped there);
  * outputs map to one or more datasets through ``output_key`` channel
    ranges, optionally channel-accumulated, optionally quantized to uint8
    with the mirrored scaling of the reference (``_to_uint8``,
    inference.py:208-214), and are written over threads (``write_batch``).

The ``cuda`` executor overlaps the three stages across batches, the JAX
package's prefetch → predict → write pipeline; ``local`` runs them per block.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask, _chunk_aligned
from .frameworks import get_predictor, get_preprocessor


def load_input_with_halo(ds, begin, block_shape, halo, padding_mode="reflect"):
    """Reflect-padded halo'd read (reference _load_input, inference.py:175-205)."""
    shape = ds.shape[-3:]
    starts = [b - h for b, h in zip(begin, halo)]
    stops = [b + bs + h for b, bs, h in zip(begin, block_shape, halo)]
    pad_left = tuple(max(0, -s) for s in starts)
    pad_right = tuple(max(0, st - sh) for st, sh in zip(stops, shape))
    bb = tuple(
        slice(max(0, s), min(sh, st)) for s, st, sh in zip(starts, stops, shape)
    )
    if len(ds.shape) == 4:
        bb = (slice(None),) + bb
    data = np.asarray(ds[bb])
    if any(pad_left) or any(pad_right):
        pad = [(pl, pr) for pl, pr in zip(pad_left, pad_right)]
        if data.ndim == 4:
            pad = [(0, 0)] + pad
        data = np.pad(data, pad, mode=padding_mode)
    return data


def to_uint8(data, float_range=(0.0, 1.0), safe_scale=True):
    """Mirrored quantization (reference _to_uint8, inference.py:208-214)."""
    if safe_scale:
        mult = np.floor(255.0 / (float_range[1] - float_range[0]))
    else:
        mult = np.ceil(255.0 / (float_range[1] - float_range[0]))
    add = 255 - mult * float_range[1]
    return np.clip((data * mult + add).round(), 0, 255).astype("uint8")


class InferenceTask(VolumeTask):
    """Block-wise prediction.

    ``output_key`` is a dict {dataset_key: [channel_start, channel_stop]}
    (reference output_key DictParameter); a 3d dataset gets one channel (or an
    accumulated reduction), a 4d dataset the full range.
    """

    task_name = "inference"

    def __init__(
        self,
        *args,
        checkpoint_path: str = None,
        halo: Sequence[int] = (0, 0, 0),
        output_key: Optional[Dict[str, Sequence[int]]] = None,
        mask_path: str = None,
        mask_key: str = None,
        framework: str = "jax",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.checkpoint_path = checkpoint_path
        self.halo = list(halo)
        self.output_key_map = dict(output_key or {})
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.framework = framework
        self._predictor = None
        self._predictor_lock = threading.Lock()

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {
                "dtype": "uint8",
                "compression": "gzip",
                "chunks": None,
                "channel_accumulation": None,
                "prep_model": None,
                # eager-torch checkpoint knobs (frameworks._load_torch_model):
                # state-dict checkpoints need the module class to construct;
                # use_best picks best_checkpoint.pytorch in inferno dirs
                "model_class": None,
                "model_kwargs": None,
                "mixed_precision": False,
                "use_best": True,
                "preprocess": "zero_mean_unit_variance",
                "batch_size": 1,
                "prefetch_threads": 2,
                # mirror test-time augmentation: None (off) or "all"
                # (reference frameworks.py:103-131 via neurofire)
                "augmentation_mode": None,
                "augmentation_dim": 3,
            }
        )
        return conf

    # -- outputs -------------------------------------------------------------

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        dtype = config.get("dtype", "uint8")
        chunks = config.get("chunks")
        chunks = (
            tuple(chunks)
            if chunks is not None
            else tuple(max(1, bs // 2) for bs in blocking.block_shape)
        )
        accumulation = config.get("channel_accumulation")
        f = store.file_reader(self.output_path, "a")
        for key, (c0, c1) in self.output_key_map.items():
            n_channels = c1 - c0
            if n_channels > 1 and accumulation is None:
                shape = (n_channels,) + tuple(blocking.shape)
                ds_chunks = (1,) + chunks
            else:
                shape = tuple(blocking.shape)
                ds_chunks = chunks
            f.require_dataset(
                key,
                shape=shape,
                dtype=dtype,
                chunks=tuple(min(c, s) for c, s in zip(ds_chunks, shape)),
                compression=config.get("compression", "gzip"),
            )

    def predictor(self, config):
        with self._predictor_lock:
            if self._predictor is None:
                self._predictor = get_predictor(self.framework)(
                    self.checkpoint_path,
                    self.halo,
                    prep_model=config.get("prep_model"),
                    use_best=config.get("use_best", True),
                    model_class=config.get("model_class"),
                    model_kwargs=config.get("model_kwargs"),
                    mixed_precision=config.get("mixed_precision", False),
                    augmentation_mode=config.get("augmentation_mode"),
                    augmentation_dim=config.get("augmentation_dim", 3),
                    config=config,
                )
        return self._predictor

    # -- per-block -----------------------------------------------------------

    def _load_block(self, block_id, blocking, in_ds, mask_ds):
        block = blocking.block(block_id)
        if mask_ds is not None:
            m = np.asarray(mask_ds[block.slicing]).astype(bool)
            if not m.any():
                return None
        return load_input_with_halo(
            in_ds, block.begin, blocking.block_shape, self.halo
        )

    def _write_block(self, block_id, blocking, out_datasets, output, config):
        block = blocking.block(block_id)
        bb = block.slicing
        actual = tuple(b.stop - b.start for b in bb)
        if output.ndim == 3:
            output = output[None]
        # crop overhanging padding at the volume end (halo itself was cropped
        # by the predictor)
        output = output[(slice(None),) + tuple(slice(0, a) for a in actual)]

        accumulation = config.get("channel_accumulation")
        dtype = config.get("dtype", "uint8")
        for key, (c0, c1) in self.output_key_map.items():
            ds = out_datasets[key]
            chan_out = output[c0:c1]
            if len(ds.shape) == 3:
                if accumulation is not None and chan_out.shape[0] > 1:
                    chan_out = getattr(np, accumulation)(chan_out, axis=0)
                else:
                    chan_out = chan_out[0]
                out_bb = bb
            else:
                out_bb = (slice(None),) + bb
            if dtype == "uint8" and chan_out.dtype != np.uint8:
                chan_out = to_uint8(chan_out)
            ds[out_bb] = chan_out.astype(ds.dtype, copy=False)

    def _mask_ds(self):
        return store.file_reader(self.mask_path, "r")[self.mask_key] if self.mask_path else None

    def _out_datasets(self):
        f = store.file_reader(self.output_path, "a")
        return {key: f[key] for key in self.output_key_map}

    # -- split batch protocol --------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): each block's halo'd, reflect-padded, preprocessed
        input, or None where the mask holds none of the block."""
        in_ds, mask_ds = self.input_ds(), self._mask_ds()
        preprocess = get_preprocessor(config.get("preprocess", "zero_mean_unit_variance"))

        def _one(bid):
            data = self._load_block(bid, blocking, in_ds, mask_ds)
            return None if data is None else preprocess(data)

        n_threads = min(max(1, int(config.get("prefetch_threads", 2))), len(block_ids))
        if n_threads > 1:
            with ThreadPoolExecutor(n_threads) as pool:
                datas = list(pool.map(_one, block_ids))
        else:
            datas = [_one(bid) for bid in block_ids]
        return [(bid, d) for bid, d in zip(block_ids, datas) if d is not None]

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2 (device): the forward in groups of ``batch_size``; the
        halo-cropped float32 outputs come back to the host."""
        predictor = self.predictor(config)
        batch_size = max(1, int(config.get("batch_size", 1)))
        results = []
        for lo in range(0, len(payload), batch_size):
            chunk = payload[lo:lo + batch_size]
            batch = np.stack([d for _, d in chunk])
            if batch.ndim == 4:  # [B, z, y, x] → add channel
                batch = batch[:, None]
            out = predictor(batch)
            results.extend((bid, out[i]) for i, (bid, _) in enumerate(chunk))
        return results

    def write_batch(self, results, blocking: Blocking, config):
        """Stage 3 (host): channel mapping, accumulation, quantisation and
        the writes, over threads where blocks cover whole chunks."""
        out_datasets = self._out_datasets()

        def _one(item):
            self._write_block(item[0], blocking, out_datasets, item[1], config)

        aligned = all(_chunk_aligned(ds, blocking.block_with_halo(bid, (0,) * blocking.ndim))
                      for ds in out_datasets.values() for bid, _ in results)
        n_threads = min(max(1, int(config.get("prefetch_threads", 2))), len(results))
        if aligned and n_threads > 1:
            with ThreadPoolExecutor(n_threads) as pool:
                list(pool.map(_one, results))
        else:
            for item in results:
                _one(item)

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
