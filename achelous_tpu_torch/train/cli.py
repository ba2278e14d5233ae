"""Training CLI with the reference's train.py flags (counterpart of
achelous_tpu/train/cli.py; reference train.py:32-57).

Usage:
  python -m achelous_tpu_torch.train.cli --backbone en --neck gdf --phi S0 \\
      --resolution 320 --bs 32 --epoch 100 --data_root /path/to/WaterScenes

It trains on the GPU unless `--device cpu` is given.  Started by torchrun,
it trains across the ranks torchrun starts, as the JAX package's CLI does
on a mesh of several processes (train/loop.fit with a group; `--bs` is
the global batch):

  torchrun --nproc_per_node=N -m achelous_tpu_torch.train.cli \\
      --dist_backend nccl --data_root /path/to/WaterScenes

`--device cuda` then means cuda:LOCAL_RANK, a GPU a rank (nccl); ranks
that share one GPU give it explicitly with `--device cuda:0
--dist_backend gloo` (NCCL refuses two ranks on one device), and ranks on
the CPU take gloo.  Rank 0 prints, writes the history and the
checkpoints.  Started without torchrun, it is one process.  `--backbone`,
`--neck` and `--phi` take every value the model configuration takes
(`BACKBONES`, `NECKS`, `WIDTHS`), as the JAX package's CLI does, and
`--spp false` trains SPPF.  The training step is held against JAX's for
EN-GDF-PN-S0, S1 and S2, EN-GDF-PN-S0 with SPPF and with the base-256
head (`--nd false`), EF-GDF-PN-S0 and -L, EN-GDF-PN2-S0, EN-CDF-PN2-S2,
MV-GDF-PN-S1, EV-GDF-PN-S0 and PF-GDF-PN-S0, and for the
reparameterizable RV-GDF-PN-S0, MO-RDF-PN-S0 and FV-RDF-PN-S0, which
train in their train form (every branch unfolded, as JAX trains them);
their checkpoints serve folded through `predict_cli --ckpt ... --deploy`:

  python -m achelous_tpu_torch.train.cli --backbone mo --neck rdf \
      --data_root /path/to/WaterScenes --log_dir logs
  python -m achelous_tpu_torch.predict_cli --backbone mo --neck rdf \
      --ckpt logs/ckpt/last_epoch_weights --deploy --image img.jpg \
      --radar_csv r.csv

The tests that hold these steps: tests/test_torch_port_train_configs.py,
tests/test_torch_port_train_modules.py, tests/test_torch_port_trained_fold.py
and the slow tests/test_torch_port_train_steps.py.  `--is_pc` takes True
alone: the JAX package's losses take the point-cloud output.
"""
from __future__ import annotations

import argparse
import os

from achelous_tpu_torch.core.config import (BACKBONES, NECKS, PC_MODELS,
                                            WIDTHS)


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def parse_band(text: str):
    """--deform_band: 'auto' (the config's default), 'none' (no clip) or a
    cell radius."""
    t = text.strip().lower()
    if t in ("auto", "none"):
        return None if t == "none" else "auto"
    band = int(t)
    if band < 0:
        raise argparse.ArgumentTypeError("--deform_band must be >= 0")
    return band


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Achelous trainer (PyTorch)")
    p.add_argument("--backbone", default="en", choices=BACKBONES)
    p.add_argument("--neck", default="gdf", choices=NECKS)
    p.add_argument("--phi", default="S0", choices=sorted(WIDTHS))
    p.add_argument("--pc_model", default="pn", choices=PC_MODELS)
    p.add_argument("--is_pc", type=str2bool, default=True)
    p.add_argument("--nd", type=str2bool, default=True,
                   help="nano (lightweight) detection head")
    p.add_argument("--spp", type=str2bool, default=True)
    p.add_argument("--resolution", type=int, default=320)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches of bs/N "
                        "(one optimizer update a step)")
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--lr_init", type=float, default=0.03)
    p.add_argument("--lr_decay", default="cos", choices=["cos", "step"])
    p.add_argument("--opt", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--pc_num", type=int, default=512)
    p.add_argument("--dice", type=str2bool, default=True)
    p.add_argument("--focal", type=str2bool, default=True)
    p.add_argument("--bf16", type=str2bool, default=True,
                   help="bf16 compute on float32 parameters")
    p.add_argument("--mtl", default="sum",
                   choices=["uncertainty", "sum", "mgda", "cagrad"],
                   help="multi-task weighting; 'sum' is the reference's "
                        "effective behaviour and the default")
    p.add_argument("--data_root", required=True,
                   help="WaterScenes-format root (see WaterScenesPaths)")
    p.add_argument("--annotation", default="train.txt")
    p.add_argument("--val_annotation", default="val.txt")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--eval_period", type=int, default=10)
    p.add_argument("--save_period", type=int, default=10)
    p.add_argument("--freeze_epoch", type=int, default=0,
                   help="freeze the vision backbone for the first N epochs")
    p.add_argument("--init_type", default="none",
                   choices=["none", "normal", "xavier", "kaiming",
                            "orthogonal"],
                   help="weights_init scheme (reference "
                        "detection_loss.py:466-485); 'none' keeps the flax "
                        "default initialisation")
    p.add_argument("--init_gain", type=float, default=0.02)
    p.add_argument("--augment", type=str2bool, default=False,
                   help="HSV jitter + horizontal flip of every modality on "
                        "the train set (data/augment.py)")
    p.add_argument("--mosaic", type=float, default=0.0, metavar="PROB",
                   help="probability of the 4-sample radar-consistent "
                        "mosaic (data/augment.mosaic_samples); implies "
                        "--augment")
    p.add_argument("--resume", default="",
                   help="checkpoint name under <log_dir>/ckpt to resume from")
    p.add_argument("--deform_band", default="auto", type=parse_band,
                   help="deformable-conv offset band: 'auto' (the config's "
                        "default), 'none' (unclipped offsets, for weights "
                        "from the reference) or an integer cell radius")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the GPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="process group backend under torchrun: nccl for a "
                        "GPU a rank, gloo for the CPU or a shared GPU")
    return p


def main(argv=None):
    import torch

    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.waterscenes import (WaterScenesDataset,
                                                     WaterScenesPaths)
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.train.checkpoints import CheckpointManager
    from achelous_tpu_torch.train.loop import fit
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state)

    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.is_pc:
        parser.error("the port trains the point-cloud branch too, as the "
                     "JAX package's losses take its output: --is_pc takes "
                     "True")
    cfg_kw = {} if args.deform_band == "auto" else \
        {"deform_band": args.deform_band}
    cfg = AchelousConfig(
        backbone=args.backbone, neck=args.neck, phi=args.phi,
        pc_model=args.pc_model, nano_head=args.nd, use_spp=args.spp,
        resolution=args.resolution, pc_points=args.pc_num,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, **cfg_kw)
    tcfg = TrainConfig(batch_size=args.bs, epochs=args.epoch,
                       lr_init=args.lr_init, lr_decay=args.lr_decay,
                       optimizer=args.opt, focal=args.focal, dice=args.dice,
                       mtl=args.mtl, freeze_epochs=args.freeze_epoch,
                       init_type=None if args.init_type == "none"
                       else args.init_type, init_gain=args.init_gain,
                       grad_accum=args.grad_accum)

    def paths(annotation):
        return WaterScenesPaths.under(args.data_root, annotation)

    acfg = None
    if args.augment or args.mosaic > 0:
        from achelous_tpu_torch.data.augment import AugmentConfig
        acfg = AugmentConfig(mosaic_prob=args.mosaic)
    train_ds = WaterScenesDataset(cfg, paths(args.annotation), augment=acfg)
    val_path = os.path.join(args.data_root, args.val_annotation)
    val_ds = WaterScenesDataset(cfg, paths(args.val_annotation)) \
        if os.path.exists(val_path) else None

    device, group, rank = args.device, None, 0
    if "WORLD_SIZE" in os.environ:
        from achelous_tpu_torch.parallel.dist import (init_from_env,
                                                      rank_device)
        device = rank_device(args.device, args.dist_backend,
                             int(os.environ.get("LOCAL_RANK", 0)),
                             int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        group, rank, _, _ = init_from_env(args.dist_backend)
    state = None
    if args.resume:
        model = create_model(cfg, device,
                             torch.Generator().manual_seed(args.seed),
                             train=True)
        state = create_train_state(model, cfg, tcfg, args.seed)
        state = CheckpointManager(os.path.join(args.log_dir, "ckpt")).restore(
            args.resume, state)
    say = print if rank == 0 else (lambda msg: None)
    say(f"training {cfg.name} on {len(train_ds)} samples ({device}"
        + (f", {torch.distributed.get_world_size()} ranks over "
           f"{args.dist_backend}" if group is not None else "") + ")")
    try:
        return fit(cfg, tcfg, train_ds, val_ds, log_dir=args.log_dir,
                   eval_period=args.eval_period,
                   save_period=args.save_period, state=state,
                   seed=args.seed, device=device, progress=say, group=group)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
