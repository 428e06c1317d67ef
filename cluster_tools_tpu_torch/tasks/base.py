"""Shared plumbing for volume-to-volume block tasks (port of
``cluster_tools_tpu/tasks/base.py::VolumeTask``)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

from ..runtime.task import BlockTask
from ..utils import store
from ..utils.blocking import Blocking

SCRATCH_STORE_NAME = "data.zarr"


def scratch_store_path(tmp_folder: str) -> str:
    """The shared per-tmp-folder scratch store."""
    return os.path.join(tmp_folder, SCRATCH_STORE_NAME)


class VolumeTask(BlockTask):
    """A block task reading ``input_path/input_key`` and writing
    ``output_path/output_key``; the blocking follows the input's last
    ``space_ndim`` axes."""

    output_dtype = None  # subclasses set it to create the output dataset
    space_ndim = 3

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        dependencies: Sequence = (),
        input_path: str = None,
        input_key: str = None,
        output_path: Optional[str] = None,
        output_key: Optional[str] = None,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key

    def input_ds(self, mode: str = "r"):
        return store.file_reader(self.input_path, mode)[self.input_key]

    def output_ds(self, mode: str = "a"):
        return store.file_reader(self.output_path, mode)[self.output_key]

    def get_shape(self) -> Sequence[int]:
        shape = self.input_ds().shape
        return shape[-self.space_ndim:] if len(shape) > self.space_ndim else shape

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        """Create the output dataset: block-shaped chunks, gzip (the
        reference's default codec, readable by vanilla n5 readers)."""
        if self.output_path is None or self.output_dtype is None:
            return
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype=self.output_dtype,
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )

    @property
    def tmp_store_path(self) -> str:
        return scratch_store_path(self.tmp_folder)

    def tmp_store(self):
        return store.file_reader(self.tmp_store_path, "a")

    def tmp_ragged(self, key: str, grid_size: int, dtype):
        return self.tmp_store().create_ragged_dataset(key, (grid_size,), dtype)
