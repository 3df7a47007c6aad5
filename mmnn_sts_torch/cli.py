"""CLI entry point (counterpart of the JAX package's cli.py:21-367):

    python -m mmnn_sts_torch --images --preop --survival --blend --split \\
        --config config.yaml [--device cuda]
    python -m mmnn_sts_torch --inference --images --preop --survival \\
        --blend [--bootstrap] [--no_gradcam] --config config.yaml
    python -m mmnn_sts_torch --images --preop --classification --blend \\
        --split --config config.yaml
    python -m torch.distributed.run --nproc_per_node 2 -m mmnn_sts_torch \\
        --images --preop --survival --blend --split --config config.yaml

The same flags, string-boolean mirrors (``--use_images`` etc.) and
flag-combination asserts as the JAX package's CLI, its config overrides
and its weight loading (a ``.npz`` in the JAX key scheme, or the BHB-10K
``.pth`` backbone; a file that fails to load is logged and training goes on
from the random init). One flag more: ``--device`` (default ``cuda``; the
CLI raises when the card is asked for and there is none, and runs on the
CPU only with ``--device cpu``). The config may be YAML or JSON.

Ported: survival and classification training (``train/loop``) with
``--checkpoint_dir`` / ``--resume``; ``--inference`` on the test split
(``infer/run``: C-indices or F1s, ``--bootstrap`` confidence intervals,
Grad-CAM attention maps unless ``--no_gradcam``, the prediction CSVs) with
``Hyperparameters.model_weights``; ``--lr_finder`` (``train/lr_finder``,
where the JAX CLI runs it: after the split, the standardisation and
``--resume``); and ``--export_path`` (the servable of ``infer/export``).
Under ``torch.distributed.run`` each process is a rank of the mesh of
``TPU.mesh_shape`` / ``mesh_axes`` (``parallel/mesh.py``): its device is
``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``), the ranks train as
one program over the ``data`` axis (rows) and the ``space`` axis (volume
depth, where it divides the configured depth; else replicated over
``space``, as the JAX loop runs it), the ``model`` axis holds replicas,
and rank 0 alone writes files.
Cohorts may be NIfTI or DICOM (``Data.image_format``), local or under
``s3://`` (with boto3); with ``Data.bucket`` set, training uploads its
artifacts and survival inference its prediction CSV there, under
``Preprocessing.output_dir``.
``--segmentation`` raises ``NotImplementedError``, as the JAX CLI does
(cli.py:109-120): neither package has a segmentation loop, and the message
names the cohort builder, ``data/images.build_segmentation_cohort``.
"""

from __future__ import annotations

import argparse
import os

def str_to_bool(arg: str) -> bool:
    if arg.lower() == "false":
        return False
    if arg.lower() == "true":
        return True
    raise ValueError(f"Unexpected value for boolean conversion: {arg}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mmnn_sts_torch")
    p.add_argument("--preop", action="store_true",
                   help="Use dataset consisting of clinical features available preoperation")
    p.add_argument("--postop", action="store_true",
                   help="Use dataset consisting of clinical features available pre and post operation")
    p.add_argument("--radiomics", action="store_true",
                   help="Use dataset consisting of extracted radiomic features")
    p.add_argument("--images", action="store_true",
                   help="Use dataset consisting of image data")
    p.add_argument("--classification", action="store_true",
                   help="Binary classification for Survival & DM")
    p.add_argument("--survival", action="store_true",
                   help="Time to Event model for survival & DM")
    p.add_argument("--segmentation", action="store_true",
                   help="Perform tumor segmentation")
    p.add_argument("--lr_finder", action="store_true",
                   help="Run LR range test (Smith 2015)")
    p.add_argument("--no_gradcam", action="store_true",
                   help="Disable gradcam for inference")

    # SageMaker string-boolean mirrors
    p.add_argument("--use_images", type=str, default="false")
    p.add_argument("--use_preop", type=str, default="false")
    p.add_argument("--use_postop", type=str, default="false")
    p.add_argument("--classification_task", type=str, default="false")
    p.add_argument("--inference_task", type=str, default="false")
    p.add_argument("--survival_task", type=str, default="false")
    p.add_argument("--use_blend", type=str, default="false")

    p.add_argument("--weights", type=str,
                   default="./weights/DenseNet121_BHB-10K_yAwareContrastive.pth",
                   help="Path to pretrained weights")
    p.add_argument("--output_path", type=str, default=".",
                   help="Directory for storing outputs")
    p.add_argument("--inference", action="store_true",
                   help="Inference using test set")
    p.add_argument("--data_loc", type=str, help="path to clinical data")
    p.add_argument("--image_loc", type=str, help="path to image data")
    p.add_argument("--key_loc", type=str, help="path to patient key")
    p.add_argument("--rad_loc", type=str, help="path to radiomic features")
    p.add_argument("--epochs", type=int, default=None, help="Number of epochs")
    p.add_argument("--lr", type=float, default=None, help="Learning rate")
    p.add_argument("--split", action="store_true",
                   help="Create a new dataset split instead of loading uid files")
    p.add_argument("--train_uid_location", type=str, default=None)
    p.add_argument("--val_uid_location", type=str, default=None)
    p.add_argument("--config", type=str, default="./config.yaml",
                   help="YAML or JSON config file")
    p.add_argument("--blend", action="store_true",
                   help="Use gradient blending (multimodal models only)")
    p.add_argument("--blend_update_interval", type=int, default=5)
    p.add_argument("--bootstrap", action="store_true", help="Bootstrap evaluation")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint")
    p.add_argument("--export_path", type=str, default="",
                   help="Write the eval forward with the weights as a "
                        "servable (infer/export) and exit")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="Full-train-state checkpoint directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "must be asked for)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    args.images = args.images or str_to_bool(args.use_images)
    args.classification = args.classification or str_to_bool(args.classification_task)
    args.inference = args.inference or str_to_bool(args.inference_task)
    args.survival = args.survival or str_to_bool(args.survival_task)
    args.preop = args.preop or str_to_bool(args.use_preop)
    args.postop = args.postop or str_to_bool(args.use_postop)
    args.blend = args.blend or str_to_bool(args.use_blend)

    task_flags = [args.classification, args.survival, args.segmentation]
    assert not all(task_flags), (
        "Can only specify one of --classification , --survival , or --segmentation"
    )
    assert any(task_flags), (
        "Must specify one of --classification , --survival , or --segmentation"
    )
    if args.segmentation:
        raise NotImplementedError(
            "segmentation training is not implemented (the reference has no "
            "segmentation loop either); use "
            "mmnn_sts_torch.data.images.build_segmentation_cohort to load "
            "aligned image/mask cohorts"
        )

    # heavy imports deferred so --help stays fast
    import torch

    from .config import parse_config
    from .constants import SUPER_BATCH_SIZE
    from .infer.export import resolve_device
    from .models import build_model
    from .models.registry import npz_layout
    from .parallel.mesh import (
        is_writer, make_mesh, maybe_initialize_distributed, rank_device,
        settle_space)
    from .pipeline import (
        TaskFlags,
        load_cohort,
        make_split_dataset,
        resolve_splits,
        standardize_bundle,
    )
    from .train import checkpoint as ckpt_lib
    from .train.loop import LoopConfig, train_classification, train_survival
    from .train.schedule import make_optimizer, steps_per_epoch
    from .train.state import create_train_state
    from .utils.logging import get_logger

    logger = get_logger()
    device = resolve_device(args.device)

    cfg = parse_config(args.config)
    for cli_name, target in [
        ("data_loc", ("data", "data_loc")),
        ("image_loc", ("data", "image_loc")),
        ("key_loc", ("data", "key_loc")),
        ("rad_loc", ("data", "rad_loc")),
    ]:
        v = getattr(args, cli_name)
        if v:
            setattr(getattr(cfg, target[0]), target[1], v)
    if args.epochs is not None:
        cfg.hyperparameters.epochs = args.epochs
    if args.lr is not None:
        cfg.hyperparameters.learning_rate = args.lr
    if args.train_uid_location:
        cfg.preprocessing.train_uid_location = args.train_uid_location
    if args.val_uid_location:
        cfg.preprocessing.val_uid_location = args.val_uid_location

    if cfg.tpu.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    flags = TaskFlags(
        preop=args.preop,
        postop=args.postop,
        radiomics=args.radiomics,
        images=args.images,
        classification=args.classification,
        survival=args.survival,
        blend=args.blend and args.images and (args.preop or args.postop),
        split=args.split,
        inference=args.inference,
        bootstrap=args.bootstrap,
        no_gradcam=args.no_gradcam,
    )

    hp = cfg.hyperparameters
    os.makedirs(args.output_path, exist_ok=True)
    if maybe_initialize_distributed(device):
        device = rank_device(device)
    mesh = settle_space(
        make_mesh(cfg.tpu.mesh_shape, tuple(cfg.tpu.mesh_axes)),
        cfg.image_model.spatial_size[0]
        if flags.images and cfg.image_model.spatial_dims == 3 else None)
    logger.info(f"device: {device}; mesh {list(mesh.shape)} over "
                f"{list(mesh.axis_names)}, rank {mesh.rank}, backend "
                f"{mesh.backend or 'none (one process)'}")

    bundle = load_cohort(cfg, flags)
    train_uids, val_uids, test_uids = resolve_splits(cfg, flags, bundle,
                                                     hp.seed)
    if cfg.clinical_model.standardize:
        standardize_bundle(bundle, train_uids)
        logger.info("standardized tabular predictors with train-split stats")

    train_ds = make_split_dataset(cfg, flags, bundle, train_uids, device,
                                  mesh)
    val_ds = make_split_dataset(cfg, flags, bundle, val_uids, device, mesh)
    num_tabular = (
        int(train_ds.inputs["clinical"].shape[-1])
        if "clinical" in train_ds.inputs
        else None
    )
    torch.manual_seed(hp.seed)
    model = build_model(
        cfg, flags.images, flags.preop, flags.postop, flags.blend,
        num_tabular_inputs=num_tabular,
    ).to(device)
    logger.info(
        f"Training count = {train_ds.num_samples} "
        f"Validation count = {val_ds.num_samples}"
    )

    step_batch = SUPER_BATCH_SIZE if flags.survival else hp.train_batch_size
    spe = steps_per_epoch(train_ds.num_samples, step_batch)
    optimizer, schedule = make_optimizer(
        model.parameters(), hp.learning_rate, spe, hp.epochs, hp.momentum,
        hp.weight_decay)
    state = create_train_state(model, optimizer, schedule, seed=hp.seed,
                               mesh=mesh)

    # weights: the trained ones for inference and an export, pretrained
    # ones otherwise
    weights_path = (hp.model_weights if (args.inference or args.export_path)
                    else hp.pretrained_weights) or args.weights
    if weights_path and os.path.exists(weights_path):
        try:
            if weights_path.endswith(".npz"):
                ckpt_lib.load_params_npz(weights_path, model)
                logger.info("Loaded weights from npz")
            elif weights_path.endswith(".pth"):
                backbone = model.image_model if flags.multimodal else model
                n = ckpt_lib.import_bhb10k_backbone(weights_path, backbone)
                logger.info(f"Loaded pretrained backbone ({n} tensors)")
        except Exception as e:  # noqa: BLE001 — as the JAX CLI: warn, go on
            logger.error(
                f"Loading pretrained weights failed - continuing with "
                f"randomized weights ({e})"
            )

    loop_cfg = LoopConfig(
        epochs=hp.epochs,
        batch_size=hp.train_batch_size,
        blend=flags.blend,
        blend_update_interval=args.blend_update_interval,
        seed=hp.seed,
        output_dir=args.output_path,
        checkpoint_dir=args.checkpoint_dir,
        save_params_name=("best_surv_model.npz" if flags.survival
                          else "model.npz"),
        profile_dir=cfg.tpu.profile_dir,
        ties=hp.cox_ties,
        eval_chunk=cfg.tpu.eval_chunk_size,
        fused_epoch=cfg.tpu.fused_epoch,
        npz_layout=npz_layout(cfg),
    )

    if args.resume and args.checkpoint_dir:
        restored = ckpt_lib.CheckpointManager(args.checkpoint_dir).restore(state)
        if restored is not None:
            logger.info(f"Resumed from step {state.step} (epoch {state.epoch})")

    if args.lr_finder:
        from .train.lr_finder import find_lr

        find_lr(cfg, flags, bundle, device, mesh=mesh)
        return 0

    if args.export_path:
        from .infer.export import export_forward, model_spec

        if not is_writer():
            return 0

        spec = model_spec(cfg, flags.images, flags.preop, flags.postop,
                          flags.blend, num_tabular)
        export_forward(model, spec, args.export_path)
        logger.info(f"Exported serving artifact to {args.export_path}")
        return 0

    if args.inference:
        from .infer.run import (
            InferenceConfig,
            inference_classification,
            inference_survival,
        )

        test_ds = make_split_dataset(cfg, flags, bundle,
                                     test_uids or val_uids, device, mesh)
        icfg = InferenceConfig(
            blend=flags.blend,
            bootstrap=args.bootstrap,
            gradcam=(not args.no_gradcam) and flags.images,
            output_dir=args.output_path,
            seed=hp.seed,
            eval_chunk=cfg.tpu.eval_chunk_size,
            bucket=cfg.data.bucket,
            dest_prefix=cfg.preprocessing.output_dir,
            ties=hp.cox_ties,
        )
        if flags.survival:
            inference_survival(state, test_ds, icfg)
        else:
            inference_classification(state, test_ds, icfg)
        return 0

    if flags.survival:
        train_survival(state, train_ds, val_ds, loop_cfg)
    else:
        train_classification(state, train_ds, val_ds, loop_cfg)

    if cfg.data.bucket and is_writer():
        # the artifacts' upload: best effort, failures logged
        from .utils.store import train_artifact_names, upload_artifacts

        upload_artifacts(cfg.data.bucket, args.output_path,
                         train_artifact_names(flags.survival, flags.blend),
                         cfg.preprocessing.output_dir)
    return 0
