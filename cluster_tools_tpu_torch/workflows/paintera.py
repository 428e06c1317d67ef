"""Paintera export workflows: label multisets, per-block lookups, metadata
(port of ``cluster_tools_tpu/workflows/paintera.py``, host numpy as there;
reference label_multisets/label_multiset_workflow.py:10 and
paintera/conversion_workflow.py:20-97)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..runtime.task import SimpleTask
from ..tasks.label_multisets import CreateMultisetTask, DownscaleMultisetTask
from ..tasks.paintera import LabelBlockMappingTask, UniqueBlockLabelsTask
from ..runtime.workflow import WorkflowBase
from ..utils import store


def _accumulate(scale_factors) -> List[List[int]]:
    eff = [1, 1, 1]
    out = []
    for sf in scale_factors:
        sf3 = [sf] * 3 if isinstance(sf, int) else list(sf)
        eff = [e * s for e, s in zip(eff, sf3)]
        out.append(list(eff))
    return out


class LabelMultisetWorkflow(WorkflowBase):
    """Multiset pyramid under ``output_prefix/s{level}``
    (reference label_multiset_workflow.py:10)."""

    task_name = "label_multiset_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, output_path=None,
                 output_prefix: str = "data",
                 scale_factors: Sequence = (),
                 restrict_sets: Optional[Sequence[int]] = None):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_prefix = output_prefix
        self.scale_factors = list(scale_factors)
        self.restrict_sets = (
            list(restrict_sets)
            if restrict_sets is not None
            else [-1] * len(self.scale_factors)
        )
        if len(self.restrict_sets) != len(self.scale_factors):
            raise ValueError("need one restrict_set per scale factor")

    def requires(self):
        s0_key = os.path.join(self.output_prefix, "s0")
        create = CreateMultisetTask(
            self.tmp_folder, self.config_dir, self.max_jobs,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=s0_key,
        )
        tasks = [create]
        dep = create
        in_key = s0_key
        effective = _accumulate(self.scale_factors)
        for i, (sf, restrict) in enumerate(
            zip(self.scale_factors, self.restrict_sets)
        ):
            out_key = os.path.join(self.output_prefix, f"s{i + 1}")
            dep = DownscaleMultisetTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[dep],
                input_path=self.output_path, input_key=in_key,
                output_path=self.output_path, output_key=out_key,
                scale_factor=sf, restrict_set=restrict,
                effective_scale_factor=effective[i],
                scale_prefix=f"s{i + 1}",
            )
            tasks.append(dep)
            in_key = out_key
        return tasks

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["create_multiset"] = CreateMultisetTask.default_task_config()
        conf["downscale_multiset"] = DownscaleMultisetTask.default_task_config()
        return conf


class WritePainteraMetadataTask(SimpleTask):
    """Top-level paintera label-group metadata
    (reference conversion_workflow.py:20-97)."""

    task_name = "write_paintera_metadata"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None,
                 dependencies=(), path=None, raw_key=None, label_group=None,
                 raw_resolution=(1, 1, 1), label_resolution=(1, 1, 1),
                 n_scales: int = 1, offset=(0, 0, 0), max_id: int = 0):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.path = path
        self.raw_key = raw_key
        self.label_group = label_group
        self.raw_resolution = list(raw_resolution)
        self.label_resolution = list(label_resolution)
        self.n_scales = n_scales
        self.offset = list(offset)
        self.max_id = max_id

    def run_impl(self) -> None:
        f = store.file_reader(self.path, "a")
        g = f.require_group(self.label_group)
        g.attrs["painteraData"] = {"type": "label"}
        g.attrs["maxId"] = int(self.max_id)
        g.attrs["labelBlockLookup"] = {
            "type": "n5-filesystem-relative",
            "scaleDatasetPattern": "label-to-block-mapping/s%d",
        }
        data_group = g.require_group("data")
        data_group.attrs["maxId"] = int(self.max_id)
        data_group.attrs["multiScale"] = True
        # java XYZ axis order
        data_group.attrs["offset"] = self.offset[::-1]
        data_group.attrs["resolution"] = self.label_resolution[::-1]

        for aux in ("unique-labels", "label-to-block-mapping"):
            if aux in g:
                aux_group = g.require_group(aux)
                aux_group.attrs["multiScale"] = True
                for scale in range(1, self.n_scales):
                    key = f"s{scale}"
                    factors = data_group[key].attrs.get("downsamplingFactors")
                    if factors and key in aux_group:
                        aux_group[key].attrs["downsamplingFactors"] = factors
        if self.raw_key:
            f.require_group(self.raw_key).attrs["resolution"] = (
                self.raw_resolution[::-1]
            )


class PainteraConversionWorkflow(WorkflowBase):
    """Full paintera label container: multiset pyramid + per-scale
    unique-labels + label-to-block lookup + metadata
    (reference conversion_workflow.py ConversionWorkflow)."""

    task_name = "paintera_conversion_workflow"

    def __init__(self, tmp_folder, config_dir=None, max_jobs=None, target=None,
                 input_path=None, input_key=None, output_path=None,
                 label_group: str = "paintera", raw_key: str = None,
                 scale_factors: Sequence = (),
                 restrict_sets: Optional[Sequence[int]] = None,
                 resolution=(1, 1, 1), offset=(0, 0, 0)):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.label_group = label_group
        self.raw_key = raw_key
        self.scale_factors = list(scale_factors)
        self.restrict_sets = restrict_sets
        self.resolution = list(resolution)
        self.offset = list(offset)

    def requires(self):
        data_prefix = os.path.join(self.label_group, "data")
        multisets = LabelMultisetWorkflow(
            self.tmp_folder, self.config_dir, self.max_jobs, self.target,
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_prefix=data_prefix,
            scale_factors=self.scale_factors, restrict_sets=self.restrict_sets,
        )
        tasks = [multisets]
        n_scales = len(self.scale_factors) + 1
        # per-scale unique labels + block lookup: s0 reads the original
        # labels, coarser scales read the multiset levels (the metadata
        # declares the lookup pattern for every scale, so every scale must
        # exist — reference conversion_workflow.py emits all of them too)
        mappings = []
        for scale in range(n_scales):
            if scale == 0:
                in_path, in_key = self.input_path, self.input_key
            else:
                in_path = self.output_path
                in_key = os.path.join(data_prefix, f"s{scale}")
            uniques_key = os.path.join(
                self.label_group, "unique-labels", f"s{scale}"
            )
            uniques = UniqueBlockLabelsTask(
                self.tmp_folder, self.config_dir, self.max_jobs,
                dependencies=[multisets],
                input_path=in_path, input_key=in_key,
                output_path=self.output_path, output_key=uniques_key,
                prefix=f"s{scale}",
            )
            tasks.append(uniques)
            mapping = LabelBlockMappingTask(
                self.tmp_folder, self.config_dir,
                dependencies=[uniques],
                input_path=self.output_path, input_key=uniques_key,
                output_path=self.output_path,
                output_key=os.path.join(
                    self.label_group, "label-to-block-mapping", f"s{scale}"
                ),
                prefix=f"s{scale}",
            )
            tasks.append(mapping)
            mappings.append(mapping)

        max_id = int(
            store.file_reader(self.input_path, "r")[self.input_key].attrs.get(
                "maxId", 0
            )
        )
        meta = WritePainteraMetadataTask(
            self.tmp_folder, self.config_dir,
            dependencies=mappings,
            path=self.output_path, raw_key=self.raw_key,
            label_group=self.label_group,
            raw_resolution=self.resolution,
            label_resolution=self.resolution,
            n_scales=n_scales, offset=self.offset, max_id=max_id,
        )
        tasks.append(meta)
        return tasks
