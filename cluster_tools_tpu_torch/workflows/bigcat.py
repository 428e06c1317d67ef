"""Legacy bigcat export (port of ``cluster_tools_tpu/workflows/bigcat.py``,
host numpy and h5py as there; reference bigcat/bigcat_workflow.py:15-130).

Bigcat reads an HDF5 container with raw + fragment labels + a
``fragment_segment_lut`` [2, n] uint64 table (fragment id → segment id, both
in one id namespace, segments offset past the fragments) and
``next_id``/resolution/offset attributes."""

from __future__ import annotations

import numpy as np

from ..runtime.task import SimpleTask
from ..runtime.workflow import WorkflowBase


class BigcatLabelAssignmentTask(SimpleTask):
    """fragment_segment_lut from a 1d assignment vector
    (reference bigcat_workflow.py:15-45)."""

    task_name = "bigcat_label_assignment"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None,
                 dependencies=(), input_path=None, input_key=None,
                 output_path=None):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path

    def run_impl(self) -> None:
        import h5py

        from ..utils import store

        if self.input_path.endswith((".h5", ".hdf5", ".hdf")):
            with h5py.File(self.input_path, "r") as f:
                assignments = f[self.input_key][:]
        else:
            assignments = store.file_reader(self.input_path, "r")[
                self.input_key
            ][:]
        if assignments.ndim != 1:
            raise ValueError("bigcat assignments must be a 1d vector")

        n = len(assignments)
        lut = np.zeros((2, n), dtype="uint64")
        lut[0] = np.arange(n, dtype="uint64")
        # segment ids live past the fragment id range (reference :31-33)
        lut[1] = assignments.astype("uint64") + np.uint64(n)
        with h5py.File(self.output_path, "a") as f:
            ds = f.require_dataset(
                "fragment_segment_lut", shape=lut.shape, dtype="uint64",
                compression="gzip", maxshape=(2, None),
            )
            ds[:] = lut


class BigcatMetadataTask(SimpleTask):
    """next_id + resolution/offset attrs (reference bigcat_workflow.py:48-90)."""

    task_name = "bigcat_metadata"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None,
                 dependencies=(), input_path=None, raw_key=None, seg_key=None,
                 resolution=(1, 1, 1), offset=None):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.input_path = input_path
        self.raw_key = raw_key
        self.seg_key = seg_key
        self.resolution = list(resolution)
        self.offset = list(offset) if offset is not None else [0, 0, 0]

    def run_impl(self) -> None:
        import h5py

        with h5py.File(self.input_path, "a") as f:
            if "fragment_segment_lut" in f:
                next_id = int(f["fragment_segment_lut"][:].max()) + 1
            else:
                next_id = int(f[self.seg_key][:].max()) + 1
            f.attrs["next_id"] = next_id
            f[self.raw_key].attrs["resolution"] = self.resolution
            f[self.raw_key].attrs["offset"] = [0, 0, 0]
            f[self.seg_key].attrs["resolution"] = self.resolution
            f[self.seg_key].attrs["offset"] = self.offset


class BigcatWorkflow(WorkflowBase):
    """Assemble a bigcat h5 container from raw, watershed and assignments.

    The heavy volumes must already live in the h5 container (bigcat is a
    legacy h5-only viewer; our chunk store is zarr/n5) — this workflow adds
    the fragment-segment LUT and metadata."""

    task_name = "bigcat_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 assignment_path=None, assignment_key=None,
                 output_path=None, raw_key: str = "volumes/raw",
                 seg_key: str = "volumes/labels/fragments",
                 resolution=(1, 1, 1), offset=None):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        self.output_path = output_path
        self.raw_key = raw_key
        self.seg_key = seg_key
        self.resolution = list(resolution)
        self.offset = offset

    def requires(self):
        lut = BigcatLabelAssignmentTask(
            self.tmp_folder, self.config_dir,
            input_path=self.assignment_path, input_key=self.assignment_key,
            output_path=self.output_path,
        )
        meta = BigcatMetadataTask(
            self.tmp_folder, self.config_dir,
            dependencies=[lut],
            input_path=self.output_path,
            raw_key=self.raw_key, seg_key=self.seg_key,
            resolution=self.resolution, offset=self.offset,
        )
        return [lut, meta]
