"""Two-level configuration: CLI flags + YAML config file.

A copy of the JAX package's config.py, so that both packages read the same YAML
files into the same typed dataclasses. The only difference: ``yaml`` is
imported inside ``parse_config``, so a ``Config`` built from the dataclass
defaults needs no PyYAML.

Validation: t1t2 modality requires in_channels == 2.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from . import constants as C
from .exceptions import ConfigurationError


@dataclass
class DataConfig:
    data_loc: str = ""
    image_loc: str = ""
    key_loc: str = ""
    rad_loc: str = ""
    t1_path: str = "t1"
    t2_path: str = "t2"
    # on-disk image format under image_loc: "nifti" or "dicom"
    image_format: str = "nifti"
    # post-run artifact upload target; empty = disabled
    bucket: str = ""


@dataclass
class ImageModelConfig:
    name: str = "densenet121"
    modality: str = "t1t2"
    feature_layers: int = 12
    num_classes: int = 2
    spatial_dims: int = 3
    in_channels: int = 2
    dropout_prob: float = 0.2
    # model input grid, fixed at cohort-build time
    spatial_size: list[int] = field(default_factory=lambda: [64, 64, 64])


@dataclass
class ClinicalModelConfig:
    headers_to_convert: list[str] = field(
        default_factory=lambda: list(C.HEADERS_TO_CONVERT)
    )
    pre_op_predictors: list[str] = field(
        default_factory=lambda: list(C.PRE_OP_PREDICTORS)
    )
    post_op_predictors: list[str] = field(
        default_factory=lambda: list(C.POST_OP_PREDICTORS)
    )
    targets_binary: list[str] = field(default_factory=lambda: list(C.TARGETS_BINARY))
    targets_time: list[str] = field(default_factory=lambda: list(C.TARGETS_TIME))
    survival_start_date: str = "Surgery_Date"
    # standardize predictors with TRAIN-split mean/std before training
    standardize: bool = False


@dataclass
class RadiomicsModelConfig:
    exclude_columns: list[str] = field(
        default_factory=lambda: list(C.RADIOMICS_EXCLUDE_COLUMNS)
    )
    label_columns: list[str] = field(
        default_factory=lambda: list(C.RADIOMICS_LABEL_COLUMNS)
    )
    surv_label_columns: list[str] = field(
        default_factory=lambda: list(C.RADIOMICS_SURV_LABEL_COLUMNS)
    )


@dataclass
class PreprocessingConfig:
    uid: str = C.UID
    header_pairs: list[tuple[str, str]] = field(
        default_factory=lambda: list(C.HEADER_PAIRS)
    )
    train_uid_location: str = "./stratified_train_uids.txt"
    val_uid_location: str = "./stratified_val_uids.txt"
    test_uid_location: str = "./stratified_test_uids.txt"
    output_dir: str = "models"
    num_workers: int = 4


@dataclass
class HyperparametersConfig:
    epochs: int = 100
    learning_rate: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    train_batch_size: int = 8
    test_batch_size: int = 4
    seed: int = 42
    log_interval: int = 100
    num_gpus: int = 1  # kept for YAML contract parity
    pretrained_weights: str = ""
    model_weights: str = ""
    # Cox partial-likelihood tie handling: "breslow" or "efron"
    cox_ties: str = "breslow"


@dataclass
class TPUConfig:
    """The JAX package's ``TPU:`` section, read so that one YAML file serves
    both packages. Of these fields the port reads only ``compute_dtype``."""

    mesh_shape: list[int] = field(default_factory=lambda: [-1])
    mesh_axes: list[str] = field(default_factory=lambda: ["data"])
    compute_dtype: str = "float32"  # or "bfloat16"
    device_resident_dataset: bool = True
    eval_chunk_size: int = 0
    fused_epoch: bool = False
    microbatch_group: int = 1
    debug_nans: bool = False
    profile_dir: str = ""
    use_pallas_fused_dense: bool = False
    remat: bool = False


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    image_model: ImageModelConfig = field(default_factory=ImageModelConfig)
    clinical_model: ClinicalModelConfig = field(default_factory=ClinicalModelConfig)
    radiomics_model: RadiomicsModelConfig = field(default_factory=RadiomicsModelConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    hyperparameters: HyperparametersConfig = field(
        default_factory=HyperparametersConfig
    )
    tpu: TPUConfig = field(default_factory=TPUConfig)


_YAML_SECTION_KEYS = {
    "Data": ("data", DataConfig, {}),
    "ImageModel": ("image_model", ImageModelConfig, {}),
    "ClinicalModel": (
        "clinical_model",
        ClinicalModelConfig,
        {
            "HEADERS_TO_CONVERT": "headers_to_convert",
            "PRE_OP_PREDICTORS": "pre_op_predictors",
            "POST_OP_PREDICTORS": "post_op_predictors",
            "TARGETS_BINARY": "targets_binary",
            "TARGETS_TIME": "targets_time",
            "SURVIVAL_START_DATE": "survival_start_date",
        },
    ),
    "RadiomicsModel": (
        "radiomics_model",
        RadiomicsModelConfig,
        {
            "RADIOMICS_EXCLUDE_COLUMNS": "exclude_columns",
            "RADIOMICS_LABEL_COLUMNS": "label_columns",
            "RADIOMICS_SURV_LABEL_COLUMNS": "surv_label_columns",
        },
    ),
    "Preprocessing": (
        "preprocessing",
        PreprocessingConfig,
        {"UID": "uid", "HEADER_PAIRS": "header_pairs"},
    ),
    "Hyperparameters": ("hyperparameters", HyperparametersConfig, {}),
    "TPU": ("tpu", TPUConfig, {}),
}


def _build_section(cls, raw: dict[str, Any], aliases: dict[str, str]):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        name = aliases.get(key, key)
        if name in known:
            if name == "header_pairs":
                value = [tuple(v) for v in value]
            kwargs[name] = value
    return cls(**kwargs)


def parse_config(path: str) -> Config:
    """Load + validate a YAML config file into a typed Config."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    for section, (attr, cls, aliases) in _YAML_SECTION_KEYS.items():
        if section in raw and isinstance(raw[section], dict):
            setattr(cfg, attr, _build_section(cls, raw[section], aliases))
    validate_config(cfg)
    return cfg


def validate_config(cfg: Config) -> None:
    if (
        cfg.image_model.modality.lower().startswith("t1t2")
        and cfg.image_model.in_channels != 2
    ):
        raise ConfigurationError(
            "T1T2 ImageModel modality requires 2 input channels - current "
            f"number of in_channels: {cfg.image_model.in_channels}"
        )
    if cfg.data.image_format not in ("nifti", "dicom"):
        raise ConfigurationError(
            f"Unsupported Data.image_format: {cfg.data.image_format} "
            "(options: 'nifti', 'dicom')"
        )
    if cfg.tpu.compute_dtype not in ("float32", "bfloat16"):
        raise ConfigurationError(
            f"Unsupported compute_dtype: {cfg.tpu.compute_dtype}"
        )
    if cfg.hyperparameters.cox_ties not in ("breslow", "efron"):
        raise ConfigurationError(
            f"Unsupported cox_ties: {cfg.hyperparameters.cox_ties} "
            "(options: 'breslow', 'efron')"
        )
