"""Scale-pyramid workflows: multiscale export with paintera / bdv.n5 metadata
(port of ``cluster_tools_tpu/workflows/downscaling.py``; the resampling runs
in ``tasks/downscaling.py`` on the task's device, the metadata on the host).

Reference downscaling/downscaling_workflow.py: chain one DownscalingTask per
pyramid level (each reading the previous level), link/copy the initial scale
into the multiscale group, then write format metadata:

  * ``paintera``  — n5 group with per-scale ``downsamplingFactors`` (reversed
    to java axis order), root ``multiScale``/``resolution``/``offset`` attrs,
    and a mirrored ``maxId`` (reference downscaling_workflow.py:42-71);
  * ``bdv.n5``    — setup/timepoint key layout with per-scale n5 metadata and
    a BigDataViewer XML sidecar (reference downscaling_workflow.py:73-86 via
    pybdv; the XML here is written directly);
  * ``bdv`` / ``bdv.hdf5`` — the classic h5 layout
    (``t00000/s00/<scale>/cells`` datasets plus root ``s00/resolutions`` and
    ``s00/subdivisions`` tables in xyz order, reference
    downscaling_workflow.py:73-86 via pybdv.write_h5_metadata) through the
    store's h5 backend.

``PainteraToBdvWorkflow`` converts an existing paintera multiscale group to
either bdv flavor (reference downscaling_workflow.py:272-330).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from ..runtime.task import SimpleTask
from ..runtime.workflow import WorkflowBase
from ..tasks.copy_volume import CopyVolumeTask
from ..tasks.downscaling import DownscalingTask
from ..utils import store


H5_EXTS = (".h5", ".hdf5", ".hdf")


def is_h5_path(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in H5_EXTS


def bdv_scale_key(
    scale: int, setup: int = 0, timepoint: int = 0, h5: bool = False
) -> str:
    """Scale-dataset key of the bdv layouts (reference get_scale_key,
    downscaling_workflow.py:160-168 via pybdv.util.get_key)."""
    if h5:
        return f"t{timepoint:05d}/s{setup:02d}/{scale}/cells"
    return f"setup{setup}/timepoint{timepoint}/s{scale}"


def _accumulate_scales(scale_factors) -> List[List[int]]:
    """Effective (cumulative) per-level factors."""
    eff = [1, 1, 1]
    out = []
    for sf in scale_factors:
        sf3 = [sf] * 3 if isinstance(sf, int) else list(sf)
        eff = [e * s for e, s in zip(eff, sf3)]
        out.append(list(eff))
    return out


def write_bdv_xml(
    xml_path: str, data_path: str, shape, resolution, unit, h5: bool = False
) -> None:
    """Minimal single-setup, single-timepoint BigDataViewer XML."""
    sz = " ".join(str(s) for s in shape[::-1])
    res = " ".join(str(r) for r in resolution[::-1])
    affine = []
    for row in range(3):
        vals = [0.0] * 4
        vals[row] = float(resolution[::-1][row])
        affine.extend(vals)
    affine_s = " ".join(str(v) for v in affine)
    rel = os.path.basename(data_path)
    loader = (
        f'<ImageLoader format="bdv.hdf5">\n'
        f'      <hdf5 type="relative">{rel}</hdf5>'
        if h5
        else f'<ImageLoader format="bdv.n5" version="1.0">\n'
        f'      <n5 type="relative">{rel}</n5>'
    )
    xml = f"""<?xml version="1.0" encoding="UTF-8"?>
<SpimData version="0.2">
  <BasePath type="relative">.</BasePath>
  <SequenceDescription>
    {loader}
    </ImageLoader>
    <ViewSetups>
      <ViewSetup>
        <id>0</id>
        <name>setup0</name>
        <size>{sz}</size>
        <voxelSize>
          <unit>{unit}</unit>
          <size>{res}</size>
        </voxelSize>
      </ViewSetup>
    </ViewSetups>
    <Timepoints type="pattern">
      <integerpattern>0</integerpattern>
    </Timepoints>
  </SequenceDescription>
  <ViewRegistrations>
    <ViewRegistration timepoint="0" setup="0">
      <ViewTransform type="affine">
        <affine>{affine_s}</affine>
      </ViewTransform>
    </ViewRegistration>
  </ViewRegistrations>
</SpimData>
"""
    with open(xml_path, "w") as f:
        f.write(xml)


class WriteDownscalingMetadataTask(SimpleTask):
    """Multiscale metadata for a completed pyramid
    (reference downscaling_workflow.py:17-99)."""

    task_name = "write_downscaling_metadata"

    def __init__(
        self,
        tmp_folder: str,
        config_dir=None,
        max_jobs=None,
        dependencies=(),
        output_path: str = None,
        scale_factors: Sequence = (),
        metadata_format: str = "paintera",
        metadata_dict: Optional[Dict[str, Any]] = None,
        output_key_prefix: str = "",
        scale_offset: int = 0,
        prefix: str = "downscaling",
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.output_path = output_path
        self.scale_factors = list(scale_factors)
        self.metadata_format = metadata_format
        self.metadata_dict = metadata_dict or {}
        self.output_key_prefix = output_key_prefix
        self.scale_offset = scale_offset
        self.prefix = prefix

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}"

    def _base_factor(self, f) -> List[int]:
        """Cumulative factor of the existing level s{scale_offset} relative to
        s0 (identity when starting from scratch)."""
        if self.scale_offset == 0:
            return [1, 1, 1]
        key = (
            os.path.join(self.output_key_prefix, f"s{self.scale_offset}")
            if self.metadata_format == "paintera"
            else bdv_scale_key(self.scale_offset)
        )
        prior = f[key].attrs.get("downsamplingFactors")
        return list(prior[::-1]) if prior else [1, 1, 1]

    def _paintera_metadata(self) -> None:
        f = store.file_reader(self.output_path, "a")
        g = f.require_group(self.output_key_prefix)
        base = self._base_factor(f)
        effective = [
            [b * e for b, e in zip(base, eff)]
            for eff in _accumulate_scales(self.scale_factors)
        ]
        for scale, eff in enumerate(effective, 1):
            # java (xyz) axis order: reverse
            g[f"s{scale + self.scale_offset}"].attrs["downsamplingFactors"] = (
                eff[::-1]
            )
        resolution = self.metadata_dict.get("resolution", [1.0] * 3)
        offsets = self.metadata_dict.get("offsets", [0.0] * 3)
        g.attrs["multiScale"] = True
        g.attrs["resolution"] = resolution[::-1]
        g.attrs["offset"] = offsets[::-1]
        s0 = g[f"s{self.scale_offset}"]
        if "maxId" in s0.attrs:
            g.attrs["maxId"] = s0.attrs["maxId"]

    def _bdv_metadata(self) -> None:
        f = store.file_reader(self.output_path, "a")
        resolution = self.metadata_dict.get("resolution", [1.0] * 3)
        unit = self.metadata_dict.get("unit", "pixel")
        base = self._base_factor(f)
        new = [
            [b * e for b, e in zip(base, eff)]
            for eff in _accumulate_scales(self.scale_factors)
        ]
        # existing levels 0..scale_offset keep their factors; read them back
        # so the setup-level list covers the full pyramid
        existing = []
        for scale in range(self.scale_offset + 1):
            prior = f[bdv_scale_key(scale)].attrs.get("downsamplingFactors")
            existing.append(
                list(prior) if prior else [1, 1, 1]
            )
        factors = existing + [e[::-1] for e in new]
        for scale, eff in enumerate(factors):
            f[bdv_scale_key(scale)].attrs["downsamplingFactors"] = eff
        s_ref = f[bdv_scale_key(0)]
        setup = f["setup0"]
        setup.attrs["downsamplingFactors"] = factors
        setup.attrs["dataType"] = str(s_ref.dtype)
        xml_path = os.path.splitext(self.output_path)[0] + ".xml"
        write_bdv_xml(xml_path, self.output_path, s_ref.shape, resolution, unit)

    def _bdv_h5_metadata(self) -> None:
        """Classic bdv.hdf5 metadata (reference via pybdv.write_h5_metadata):
        ``s00/resolutions`` — absolute per-scale downsampling factors — and
        ``s00/subdivisions`` — per-scale chunk shapes — both xyz-ordered
        tables at the file root, plus the XML sidecar."""
        import numpy as np

        f = store.file_reader(self.output_path, "a")
        resolution = self.metadata_dict.get("resolution", [1.0] * 3)
        unit = self.metadata_dict.get("unit", "pixel")
        # existing levels 0..scale_offset keep their factor rows (read back
        # from a prior s00/resolutions, like the n5 writer's _base_factor
        # path); new levels accumulate on top of the last existing row
        existing = []
        if self.scale_offset > 0 and "s00/resolutions" in f:
            prior = np.asarray(f["s00/resolutions"][:])
            existing = [
                list(map(float, row)) for row in prior[: self.scale_offset + 1]
            ]
        while len(existing) < self.scale_offset + 1:
            existing.append([1.0, 1.0, 1.0])
        base = existing[-1][::-1]  # xyz row → zyx for accumulation
        new = [
            [b * e for b, e in zip(base, eff)][::-1]
            for eff in _accumulate_scales(self.scale_factors)
        ]
        factors = existing + new  # xyz rows covering the whole pyramid
        res_rows, sub_rows = [], []
        for scale, eff in enumerate(factors):
            key = bdv_scale_key(scale, h5=True)
            if key not in f:
                break
            ds = f[key]
            chunks = ds.chunks or ds.shape
            res_rows.append(list(map(float, eff)))
            sub_rows.append(list(map(int, chunks))[::-1])
        g = f.require_group("s00")
        for name, rows, dt in (
            ("resolutions", res_rows, "float64"),
            ("subdivisions", sub_rows, "int32"),
        ):
            if name in g:
                del g[name]
            g.create_dataset(name, data=np.asarray(rows, dtype=dt))
        s_ref = f[bdv_scale_key(0, h5=True)]
        xml_path = os.path.splitext(self.output_path)[0] + ".xml"
        write_bdv_xml(
            xml_path, self.output_path, s_ref.shape, resolution, unit, h5=True
        )

    def run_impl(self) -> None:
        if self.metadata_format == "paintera":
            self._paintera_metadata()
        elif self.metadata_format == "bdv.n5":
            self._bdv_metadata()
        elif self.metadata_format in ("bdv", "bdv.hdf5"):
            self._bdv_h5_metadata()
        else:
            raise ValueError(
                f"metadata format {self.metadata_format!r} is not supported "
                "(paintera, bdv.n5, bdv/bdv.hdf5 are)"
            )


class DownscalingWorkflow(WorkflowBase):
    """Full pyramid build (reference downscaling_workflow.py:102-270)."""

    task_name = "downscaling_workflow"

    def __init__(
        self,
        tmp_folder: str,
        config_dir=None,
        max_jobs=None,
        target=None,
        input_path: str = None,
        input_key: str = None,
        scale_factors: Sequence = (2,),
        halos: Optional[Sequence] = None,
        metadata_format: str = "paintera",
        metadata_dict: Optional[Dict[str, Any]] = None,
        output_path: str = "",
        output_key_prefix: str = "",
        force_copy: bool = False,
        scale_offset: int = 0,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target)
        self.input_path = input_path
        self.input_key = input_key
        self.scale_factors = list(scale_factors)
        self.halos = list(halos) if halos is not None else [[]] * len(
            self.scale_factors
        )
        if len(self.halos) != len(self.scale_factors):
            raise ValueError("need one halo per scale factor")
        self.metadata_format = metadata_format
        self.metadata_dict = metadata_dict or {}
        self.output_path = output_path or input_path
        self.output_key_prefix = output_key_prefix
        self.force_copy = force_copy
        self.scale_offset = scale_offset
        if metadata_format not in ("paintera", "bdv", "bdv.hdf5", "bdv.n5"):
            raise ValueError(f"unknown metadata format {metadata_format!r}")
        if metadata_format == "paintera" and not output_key_prefix:
            raise ValueError("paintera format needs output_key_prefix")
        # extension/format pairing (reference validate_format,
        # downscaling_workflow.py:143-158)
        if metadata_format in ("bdv", "bdv.hdf5") and not is_h5_path(
            self.output_path
        ):
            raise ValueError(f"{metadata_format} needs an .h5/.hdf5 output")
        if metadata_format in ("paintera", "bdv.n5") and is_h5_path(
            self.output_path
        ):
            raise ValueError(f"{metadata_format} needs an n5/zarr output")

    def get_scale_key(self, scale: int) -> str:
        if self.metadata_format == "paintera":
            return os.path.join(self.output_key_prefix, f"s{scale}")
        return bdv_scale_key(
            scale, h5=self.metadata_format in ("bdv", "bdv.hdf5")
        )

    def _have_initial_scale(self, in_key: str) -> bool:
        try:
            return in_key in store.file_reader(self.output_path, "r")
        except FileNotFoundError:
            return False

    def requires(self):
        in_key = self.get_scale_key(self.scale_offset)
        tasks = []
        # initial scale: copy into the pyramid group unless it is already
        # there (reference links instead when input==output; a copy is the
        # store-agnostic equivalent and force_copy always re-copies)
        if self.force_copy or not self._have_initial_scale(in_key):
            dep = CopyVolumeTask(
                self.tmp_folder,
                self.config_dir,
                self.max_jobs,
                input_path=self.input_path,
                input_key=self.input_key,
                output_path=self.output_path,
                output_key=in_key,
                prefix="initial_scale",
            )
            tasks.append(dep)
        else:
            dep = None
        effective = _accumulate_scales(self.scale_factors)
        for i, (sf, halo) in enumerate(zip(self.scale_factors, self.halos)):
            scale = self.scale_offset + 1 + i
            out_key = self.get_scale_key(scale)
            dep = DownscalingTask(
                self.tmp_folder,
                self.config_dir,
                self.max_jobs,
                dependencies=[dep] if dep is not None else [],
                input_path=self.output_path,
                input_key=in_key,
                output_path=self.output_path,
                output_key=out_key,
                scale_factor=sf,
                scale_prefix=f"s{scale}",
                halo=halo,
                effective_scale_factor=effective[i],
            )
            tasks.append(dep)
            in_key = out_key
        meta = WriteDownscalingMetadataTask(
            self.tmp_folder,
            self.config_dir,
            dependencies=[dep],
            output_path=self.output_path,
            scale_factors=self.scale_factors,
            metadata_format=self.metadata_format,
            metadata_dict=self.metadata_dict,
            output_key_prefix=self.output_key_prefix,
            scale_offset=self.scale_offset,
        )
        tasks.append(meta)
        return tasks

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["downscaling"] = DownscalingTask.default_task_config()
        conf["copy_volume"] = CopyVolumeTask.default_task_config()
        return conf


class PainteraToBdvWorkflow(WorkflowBase):
    """Convert an existing paintera multiscale group to a bdv container
    (reference downscaling_workflow.py:272-330): copy every ``s<i>`` scale
    dataset into the bdv key layout, derive the relative scale factors from
    the paintera ``downsamplingFactors`` attributes, inherit
    ``resolution``/``offset`` group attributes into the metadata, and write
    the bdv metadata + XML sidecar.  The output flavor follows the output
    extension: .h5/.hdf5 → classic bdv.hdf5, else bdv.n5 (the reference
    supports only the h5 flavor here)."""

    task_name = "paintera_to_bdv"

    def __init__(
        self,
        tmp_folder: str,
        config_dir=None,
        max_jobs=None,
        target=None,
        input_path: str = None,
        input_key_prefix: str = None,
        output_path: str = None,
        dtype: Optional[str] = None,
        metadata_dict: Optional[Dict[str, Any]] = None,
        skip_existing_levels: bool = True,
        dependencies=(),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, target, dependencies)
        self.input_path = input_path
        self.input_key_prefix = input_key_prefix
        self.output_path = output_path
        self.dtype = dtype
        self.metadata_dict = metadata_dict or {}
        self.skip_existing_levels = skip_existing_levels

    def _scales(self) -> List[int]:
        try:
            g = store.file_reader(self.input_path, "r")[self.input_key_prefix]
        except (OSError, KeyError) as e:
            # requires() builds the task graph EAGERLY (as the reference's
            # luigi requires() does), so the paintera group must already
            # exist — a dependency that would create it cannot gate this
            raise ValueError(
                f"PainteraToBdvWorkflow needs the paintera group "
                f"{self.input_key_prefix!r} in {self.input_path!r} to exist "
                "when the workflow is constructed — build the pyramid first"
            ) from e
        return sorted(int(name[1:]) for name in g.keys())

    def requires(self):
        h5 = is_h5_path(self.output_path)
        fin = store.file_reader(self.input_path, "r")
        scales = self._scales()
        tasks: List = []
        dep = None
        prev = None
        rel_factors = []
        for scale in scales:
            in_key = os.path.join(self.input_key_prefix, f"s{scale}")
            out_key = bdv_scale_key(scale, h5=h5)
            # paintera attrs are xyz (java) order; internal convention is
            # python zyx — reverse on read (the metadata writers reverse
            # again on their way out)
            eff = fin[in_key].attrs.get("downsamplingFactors", [1, 1, 1])
            eff = (
                [eff] * 3 if isinstance(eff, (int, float)) else list(eff)[::-1]
            )
            if scale > 0 and prev is not None:
                rel_factors.append([e / p for e, p in zip(eff, prev)])
            prev = list(eff)
            if self.skip_existing_levels and os.path.exists(self.output_path):
                try:
                    if out_key in store.file_reader(self.output_path, "r"):
                        continue
                except (OSError, KeyError):
                    pass
            dep = CopyVolumeTask(
                self.tmp_folder,
                self.config_dir,
                self.max_jobs,
                dependencies=[dep] if dep is not None else self.dependencies,
                input_path=self.input_path,
                input_key=in_key,
                output_path=self.output_path,
                output_key=out_key,
                prefix=f"paintera_to_bdv_s{scale}",
                dtype=self.dtype,
                effective_scale_factor=eff,
            )
            tasks.append(dep)

        metadata_dict = {**self.metadata_dict}
        attrs = fin[self.input_key_prefix].attrs
        for src, dst in (("offset", "offsets"), ("resolution", "resolution")):
            val = attrs.get(src)
            if dst not in metadata_dict and val is not None:
                metadata_dict[dst] = list(val)[::-1]  # java xyz → python zyx
        meta = WriteDownscalingMetadataTask(
            self.tmp_folder,
            self.config_dir,
            dependencies=[dep] if dep is not None else list(self.dependencies),
            output_path=self.output_path,
            scale_factors=rel_factors,
            metadata_format="bdv.hdf5" if h5 else "bdv.n5",
            metadata_dict=metadata_dict,
            prefix="paintera_to_bdv",
        )
        tasks.append(meta)
        return tasks

    @classmethod
    def get_config(cls):
        conf = super().get_config()
        conf["copy_volume"] = CopyVolumeTask.default_task_config()
        return conf
