"""High-level assembly: config + flags -> device-resident split datasets
(counterpart of the JAX package's pipeline.py:32-241).

The modalities are loaded eagerly into cohort-level arrays, joined on the
intersection of their UIDs, split by UID lists (loaded or freshly
stratified) and placed on one device once per split. Every target comes
from the one cleaned clinical table.

With ``TPU.device_resident_dataset: false`` a split stays in host memory
instead (``data/streaming.HostDataset``, pinned for the card) and its
batches are streamed to the device (pipeline.py:214-231).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import Config, get_image_path
from .data.images import ImageCohort, build_image_cohort
from .data.loader import build_device_dataset
from .data.streaming import build_host_dataset
from .data.radiomics import load_radiomics
from .data.split import stratified_split
from .data.tabular import ClinicalArrays, load_clinical_arrays
from .exceptions import ConfigurationError
from .infer.export import resolve_device
from .parallel.mesh import is_writer
from .utils.store import load_uids_any


@dataclass
class TaskFlags:
    """The CLI's task and modality switches."""

    preop: bool = False
    postop: bool = False
    radiomics: bool = False
    images: bool = False
    classification: bool = False
    survival: bool = False
    segmentation: bool = False
    blend: bool = False
    split: bool = False
    inference: bool = False
    bootstrap: bool = False
    no_gradcam: bool = False
    lr_finder: bool = False

    @property
    def multimodal(self) -> bool:
        return self.images and (self.preop or self.postop)


@dataclass
class CohortBundle:
    """All host-side cohort arrays, pre-split."""

    clinical: ClinicalArrays | None
    images: ImageCohort | None
    radiomics_features: np.ndarray | None
    uids: np.ndarray  # joined cohort UIDs (intersection across modalities)


def load_cohort(cfg: Config, flags: TaskFlags) -> CohortBundle:
    if not (flags.classification or flags.survival or flags.segmentation):
        raise ConfigurationError(
            "Must specify one of --classification , --survival , or --segmentation"
        )

    clinical = None
    if flags.preop or flags.postop or flags.images or flags.radiomics:
        # targets always come from the clinical table, even for image-only
        # runs
        clinical = load_clinical_arrays(
            cfg.data.data_loc,
            preop=flags.preop or not flags.postop,
            postop=flags.postop,
            clinical_cfg=cfg.clinical_model,
            header_pairs=cfg.preprocessing.header_pairs,
            uid_col=cfg.preprocessing.uid,
        )

    images = None
    if flags.images:
        image_path = get_image_path(cfg)
        images = build_image_cohort(
            image_path if isinstance(image_path, tuple) else [image_path],
            cfg.data.key_loc,
            spatial_size=tuple(cfg.image_model.spatial_size),
            zero_slices="fill" if flags.survival else "crop",
            image_format=cfg.data.image_format,
        )

    radiomics = None
    if flags.radiomics:
        radiomics = load_radiomics(cfg.data.rad_loc,
                                   cfg.radiomics_model.exclude_columns,
                                   cfg.preprocessing.uid)

    # UID join: intersection across active modalities
    uid_sets = [set(int(u) for u in m.uids)
                for m in (clinical, images, radiomics) if m is not None]
    uids = np.asarray(sorted(set.intersection(*uid_sets)), dtype=np.int64)

    rad_features = None
    if radiomics is not None:
        order = {int(u): i for i, u in enumerate(radiomics.uids)}
        rad_features = radiomics.features[[order[int(u)] for u in uids]]

    return CohortBundle(
        clinical=clinical, images=images, radiomics_features=rad_features, uids=uids
    )


def standardize_bundle(bundle: CohortBundle, train_uids) -> CohortBundle:
    """Standardize tabular predictors (clinical + radiomics) in place using
    TRAIN-split statistics only (no leakage); NaNs are imputed to the train
    mean (0 after standardization)."""
    train_set = set(int(u) for u in train_uids)

    def _fit_apply(matrix, uids):
        rows = [i for i, u in enumerate(uids) if int(u) in train_set]
        train = matrix[rows]
        mu = np.nanmean(train, axis=0)
        sd = np.nanstd(train, axis=0) + 1e-6
        out = (matrix - mu) / sd
        return np.nan_to_num(out, nan=0.0).astype(np.float32)

    if bundle.clinical is not None:
        bundle.clinical.predictors = _fit_apply(
            bundle.clinical.predictors, bundle.clinical.uids
        )
    if bundle.radiomics_features is not None:
        bundle.radiomics_features = _fit_apply(
            bundle.radiomics_features, bundle.uids
        )
    return bundle


def resolve_splits(cfg: Config, flags: TaskFlags, bundle: CohortBundle, seed: int):
    """(train_uids, val_uids, test_uids): a fresh stratified split with
    --split (its txt files written to the working directory, by rank 0
    alone under a mesh of ranks), else the configured UID files."""
    pp = cfg.preprocessing
    if flags.split:
        return stratified_split(
            bundle.clinical.raw,
            bundle.uids,
            seed=seed,
            targets_binary=cfg.clinical_model.targets_binary,
            uid_col=pp.uid,
            output_dir=".",
            write_files=is_writer(),
        )
    train = load_uids_any(pp.train_uid_location)
    val = load_uids_any(pp.val_uid_location)
    try:
        test = load_uids_any(pp.test_uid_location)
    except FileNotFoundError:
        test = []
    return train, val, test


def make_split_dataset(
    cfg: Config,
    flags: TaskFlags,
    bundle: CohortBundle,
    uids,
    device=None,
):
    """The dataset of one UID list (those in the cohort) for ``device``
    (default: the card; raises without one): device-resident, or with
    ``TPU.device_resident_dataset: false`` a ``HostDataset`` whose batches
    go to ``device``."""
    device = resolve_device(device)
    cohort = set(int(x) for x in bundle.uids)
    uids = np.asarray([int(u) for u in uids if int(u) in cohort],
                      dtype=np.int64)

    clinical_mat = None
    labels = events = durations = None
    if bundle.clinical is not None:
        order = {int(u): i for i, u in enumerate(bundle.clinical.uids)}
        rows = [order[int(u)] for u in uids]
        labels = bundle.clinical.binary_targets[rows]
        events = bundle.clinical.events[rows]
        durations = bundle.clinical.durations[rows]
        if flags.preop or flags.postop:
            clinical_mat = bundle.clinical.predictors[rows]

    if flags.radiomics and bundle.radiomics_features is not None:
        order = {int(u): i for i, u in enumerate(bundle.uids)}
        rad_rows = bundle.radiomics_features[[order[int(u)] for u in uids]]
        clinical_mat = (
            rad_rows
            if clinical_mat is None
            else np.concatenate([clinical_mat, rad_rows], axis=1)
        )

    volumes = None
    if bundle.images is not None:
        img_order = {int(u): i for i, u in enumerate(bundle.images.uids)}
        volumes = bundle.images.volumes[[img_order[int(u)] for u in uids]]

    build = (build_device_dataset if cfg.tpu.device_resident_dataset
             else build_host_dataset)
    return build(
        uids,
        device,
        image_volumes=volumes,
        clinical=clinical_mat,
        labels=None if flags.survival else labels,
        events=events if flags.survival else None,
        durations=durations if flags.survival else None,
    )
