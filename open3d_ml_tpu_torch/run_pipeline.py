"""The port's command line: train, validate or test a pipeline from a
config file.

Counterpart of the JAX package's ``scripts/run_pipeline.py``, with the
same arguments, the same dotted ``--section.key value`` overrides (coerced
to bool, None, int or float where they read as one), the same seed draws
(``np.random.default_rng(--seed)`` gives the model's seed, then the
pipeline's, where the config sets neither) and the same split dispatch:
``train`` runs ``run_train``, ``valid`` runs ``run_valid`` where the
pipeline has one and ``run_test`` otherwise, and any other split
``run_test``. Without ``-c``, ``-d``, ``-m`` and ``-p`` name the
classes, built as the JAX command line builds them: the dataset from
``--dataset_path``, the model from ``--ckpt_path``, the pipeline from
``--main_log_dir`` (default ``./logs``) and, in the port only, the
device; the dotted extras, ``--seed`` and the ``--cfg_dataset``,
``--cfg_model`` and ``--cfg_pipeline`` files are parsed and ignored
there, as in JAX.

It runs on ``--device cuda`` (the default) or ``cpu``, and on no other
device: ``tpu`` raises, as does ``cuda`` with no card visible; nothing
falls back to the CPU. ``--distributed`` trains data-parallel over
``torch.distributed``, one process a rank started by ``torchrun``
(``parallel.mesh``): each rank runs its share of every global batch
(``batch_size`` is the global batch, as in the JAX package) on
``cuda:<LOCAL_RANK>``, and rank 0 writes the logs and checkpoints; a
dataset with no seed gets one from ``--seed``, drawn after the model's
and the pipeline's, so that every rank draws the same batches;
``--dist_backend`` is ``nccl`` on cuda and ``gloo`` on the CPU unless
given. Only RandLA-Net and PointPillars run on more than one rank; any
other model raises (ROADMAP queue 1 item 7). SparseConvUnet's,
PointTransformer's and PVCNN's test and valid splits raise in the pipeline (``run_test_on_split``): their
``transform`` never advances the possibility map, so the loop would not
end. Three shipped PointPillars configs fail as the JAX package fails
(ROADMAP.md queue 3): ``pointpillars_waymo.yml``'s net cannot join its
neck (``NECK_FAULT``), an Argoverse frame has the 3 columns that
``transform`` cannot take (``COLUMNS_FAULT``), and the nuScenes, Lyft
and Argoverse test splits cannot write their boxes as KITTI lines
(``datasets/utils/bev_box.py`` ``NO_CAMERA_FAULT``).

    python -m open3d_ml_tpu_torch.run_pipeline \\
        -c open3d_ml_tpu_torch/configs/randlanet_semantickitti.yml \\
        --dataset.dataset_path <root> --split train [--section.key value]

    python -m open3d_ml_tpu_torch.run_pipeline \\
        -c open3d_ml_tpu_torch/configs/pointpillars_nuscenes.yml \\
        --dataset.dataset_path <root of infos_*.pkl> --split train

    torchrun --nproc-per-node 2 -m open3d_ml_tpu_torch.run_pipeline \\
        -c open3d_ml_tpu_torch/configs/randlanet_semantickitti.yml \\
        --dataset.dataset_path <root> --split train --distributed
"""

import argparse
import logging

import numpy as np
import torch
import torch.distributed as dist

from .parallel.mesh import init_distributed
from .utils import Config, get_module

TRAIN_SPLITS = ("train", "training")
VALID_SPLITS = ("valid", "validation")


def parse_args(argv=None):
    """(the known arguments, {dotted key: string} of the others)."""
    parser = argparse.ArgumentParser(
        description="Train, validate or test a 3D perception pipeline",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--framework", default="torch",
                        help="ignored (one backend); kept for the JAX "
                             "command line's arguments")
    parser.add_argument("-c", "--cfg_file", help="path to the config file")
    parser.add_argument("-m", "--model", help="network model name")
    parser.add_argument("-p", "--pipeline", default="SemanticSegmentation",
                        help="pipeline name")
    parser.add_argument("-d", "--dataset", help="dataset name")
    parser.add_argument("--cfg_model", help="path to model config")
    parser.add_argument("--cfg_pipeline", help="path to pipeline config")
    parser.add_argument("--cfg_dataset", help="path to dataset config")
    parser.add_argument("--dataset_path", help="path to the dataset root")
    parser.add_argument("--ckpt_path", help="path to a checkpoint")
    parser.add_argument("--device", default="cuda", help="cuda | cpu")
    parser.add_argument("--split", default="train",
                        help="train | valid | test")
    parser.add_argument("--mode", default=None,
                        help="model-specific mode (sets model.mode)")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--main_log_dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--distributed", action="store_true",
                        help="data parallelism over torch.distributed, "
                             "one process a rank (start with torchrun)")
    parser.add_argument("--dist_backend", default=None,
                        help="nccl | gloo (default: nccl on cuda, gloo on "
                             "cpu)")

    args, unknown = parser.parse_known_args(argv)

    parser_extra = argparse.ArgumentParser(add_help=False)
    for arg in unknown:
        if arg.startswith("--"):
            parser_extra.add_argument(arg.split("=")[0])
    extra_ns, _ = parser_extra.parse_known_args(unknown)
    extra = {k: v for k, v in vars(extra_ns).items() if v is not None}
    return args, extra


def resolve_device(device):
    """``device`` if the port can run there: 'cpu', or 'cuda' (or
    'cuda:<n>') with a card visible."""
    name = str(device).lower()
    if name == "cpu":
        return name
    if name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device is "
                               "visible (--device cpu runs on the CPU)")
        return name
    raise ValueError(f"--device {device}: the port runs on cuda or cpu")


def build_pipeline(args, extra_dict):
    """(the pipeline the arguments describe, the split to run)."""
    args.device = resolve_device(args.device)
    if args.cfg_file is None:
        if args.model is None or args.dataset is None:
            raise ValueError("Provide -c cfg.yml or all of "
                             "--pipeline/--model/--dataset")
        dataset = get_module("dataset", args.dataset)(
            dataset_path=args.dataset_path)
        model = get_module("model", args.model)(ckpt_path=args.ckpt_path)
        pipeline = get_module("pipeline", args.pipeline)(
            model, dataset, main_log_dir=args.main_log_dir or "./logs",
            device=args.device)
        return pipeline, args.split

    rng = np.random.default_rng(args.seed)
    cfg = Config.load_from_file(args.cfg_file)
    extra_dict = dict(extra_dict)
    if args.mode is not None:
        extra_dict["model.mode"] = args.mode
    cfg_dataset, cfg_model, cfg_pipeline = Config.merge_cfg_file(
        cfg, args, extra_dict)
    model_kwargs = cfg_model.to_dict()
    pipe_kwargs = cfg_pipeline.to_dict()
    model_kwargs.setdefault("seed", int(rng.integers(1 << 31)))
    pipe_kwargs.setdefault("seed", int(rng.integers(1 << 31)))
    dataset_cls = get_module("dataset", cfg_dataset.name)
    dataset = dataset_cls(**cfg_dataset.to_dict())
    if args.distributed and dataset.cfg.get("seed") is None:
        # every rank draws the same global batches
        dataset = dataset_cls(**dict(cfg_dataset.to_dict(),
                                     seed=int(rng.integers(1 << 31))))
    model = get_module("model", cfg_model.name)(**model_kwargs)
    pipeline = get_module("pipeline", cfg_pipeline.name)(
        model, dataset, **pipe_kwargs)
    return pipeline, args.split


def run(pipeline, split):
    """Run ``split`` on ``pipeline``: train, validate or test."""
    if split in TRAIN_SPLITS:
        return pipeline.run_train()
    if split in VALID_SPLITS and hasattr(pipeline, "run_valid"):
        return pipeline.run_valid()
    return pipeline.run_test()


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s - %(asctime)s - %(module)s - %(message)s")
    args, extra_dict = parse_args(argv)
    joined = False
    if args.distributed and not dist.is_initialized():
        init_distributed(args.dist_backend, resolve_device(args.device))
        joined = True
    try:
        pipeline, split = build_pipeline(args, extra_dict)
        run(pipeline, split)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
