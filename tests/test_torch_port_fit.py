"""`fit`, `evaluate_epoch` and the CLI of the PyTorch port on a small
WaterScenes tree, on the CPU (the port alone: the JAX package's own `fit`
test compiles for minutes).

EN-GDF-PN-S0 at 64x64, float32, batch 2, on 4 training and 2 validation
frames with raw radar CSVs, so every batch's radar map is splatted by
`device_batch`:

  * `fit` for 2 epochs: history.jsonl has both epochs with the training
    and validation losses and, at the last epoch, the online evaluation's
    metrics; the periodic, best and last checkpoints exist;
  * a run stopped after its first epoch and resumed from that epoch's
    checkpoint, with new datasets as a new process builds them, ends with
    the parameters, BatchNorm statistics, optimizer trace and EMA of the
    uninterrupted run, equal (the frames carry fewer radar points than
    `pc_points`, so every sample draws its resampling from the dataset's
    generator: the checkpoint must carry the generators' states);
  * `python -m achelous_tpu_torch.train.cli --device cpu` trains one epoch,
    evaluates and checkpoints, and `--resume` carries it to a second, with
    the backbone frozen in the first (`--freeze_epoch 1`).
"""
import json
import os

import pytest
import torch

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.example import write_tree
from achelous_tpu_torch.data.waterscenes import (WaterScenesDataset,
                                                 WaterScenesPaths)
from achelous_tpu_torch.train import checkpoints, cli
from achelous_tpu_torch.train.loop import fit
from achelous_tpu_torch.train.train_state import BACKBONE, TrainConfig

RES, PTS, BATCH = 64, 64, 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("ws_fit")), frames=6,
                      size=(96, 54), points=40)


def datasets(cfg, tree):
    return (WaterScenesDataset(cfg, WaterScenesPaths.under(tree)),
            WaterScenesDataset(cfg, WaterScenesPaths.under(tree, "val.txt")))


def run(tree, log_dir, stop_after=None):
    cfg = AchelousConfig(resolution=RES, pc_points=PTS)
    tcfg = TrainConfig(batch_size=BATCH, epochs=2, max_gt=8, lr_init=0.01)
    train_ds, val_ds = datasets(cfg, tree)
    msgs = []

    def progress(msg):
        msgs.append(msg)
        if stop_after is not None and len(msgs) == stop_after:
            raise KeyboardInterrupt

    kw = dict(log_dir=log_dir, save_period=1, device="cpu", progress=progress)
    try:
        state = fit(cfg, tcfg, train_ds, val_ds, **kw)
    except KeyboardInterrupt:
        # a resume builds everything anew, as `cli --resume` in a new
        # process does
        ckpt = checkpoints.CheckpointManager(os.path.join(log_dir, "ckpt"))
        name = ckpt.periodic()[-1]
        assert name.startswith("ep001")
        from achelous_tpu_torch.models.achelous import create_model
        from achelous_tpu_torch.train.train_state import create_train_state
        state = create_train_state(
            create_model(cfg, "cpu", torch.Generator().manual_seed(9),
                         train=True), cfg, tcfg)
        state = ckpt.restore(name, state)
        assert state.epoch == 1
        state = fit(cfg, tcfg, *datasets(cfg, tree), state=state, **kw)
    return state, msgs


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    whole = tmp_path_factory.mktemp("whole")
    parts = tmp_path_factory.mktemp("parts")
    return (str(whole), run(tree, str(whole))), \
        (str(parts), run(tree, str(parts), stop_after=1))


def test_fit_logs_evaluates_and_checkpoints(runs):
    (log_dir, (state, msgs)), _ = runs
    assert state.epoch == 2 and state.step == 2 * (4 // BATCH)
    assert len(msgs) == 2
    hist = [json.loads(line) for line in
            open(os.path.join(log_dir, "history.jsonl"))]
    assert [h["epoch"] for h in hist] == [0, 1]
    for h in hist:
        for k in ("lr", "loss", "loss_det", "grad_norm", "val_loss"):
            assert k in h and h[k] == h[k], k
    for k in ("mAP50", "miou_sem", "miou_wl", "miou_pc", "n_images"):
        assert k in hist[1] and k not in hist[0], k
    assert hist[1]["n_images"] == 2
    ckpt = checkpoints.CheckpointManager(os.path.join(log_dir, "ckpt"))
    assert len(ckpt.periodic()) == 2
    assert ckpt.exists("best_epoch_weights")
    assert ckpt.exists("last_epoch_weights")


def test_resumed_run_equals_the_uninterrupted_one(runs):
    (_, (whole, _)), (log_dir, (resumed, msgs)) = runs
    assert len(msgs) == 2 and resumed.epoch == 2
    a, b = checkpoints.state_dict(whole), checkpoints.state_dict(resumed)
    for key in ("model", "ema_params", "ema_batch_stats"):
        for n, v in a[key].items():
            assert torch.equal(v, b[key][n]), (key, n)
    for n, v in a["opt_state"]["trace"].items():
        assert torch.equal(v, b["opt_state"]["trace"][n]), n
    assert (a["step"], a["ema_updates"]) == (b["step"], b["ema_updates"])
    hist = [json.loads(line) for line in
            open(os.path.join(log_dir, "history.jsonl"))]
    assert [h["epoch"] for h in hist] == [0, 1]


def test_cli_trains_evaluates_and_resumes(tree, tmp_path):
    log_dir = str(tmp_path / "logs")
    argv = ["--data_root", tree, "--device", "cpu", "--bf16", "false",
            "--resolution", str(RES), "--pc_num", str(PTS), "--bs",
            str(BATCH), "--lr_init", "0.01", "--save_period", "1",
            "--log_dir", log_dir, "--freeze_epoch", "1"]
    first = cli.main(argv + ["--epoch", "1"])
    assert first.epoch == 1
    model = first.model
    saved = torch.load(os.path.join(log_dir, "ckpt", "last_epoch_weights.pt"),
                       weights_only=True)
    second = cli.main(argv + ["--epoch", "2", "--resume",
                              "last_epoch_weights"])
    assert second.epoch == 2 and second.step == 2 * first.step
    hist = [json.loads(line) for line in
            open(os.path.join(log_dir, "history.jsonl"))]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert "mAP50" in hist[0] and "mAP50" in hist[1]
    # epoch 0 ran frozen: the backbone kept its initial values there, and
    # moved in epoch 1
    init = cli_initial_backbone(tree)
    for n, p in model.named_parameters():
        if n.startswith(BACKBONE):
            assert torch.equal(saved["model"][n], init[n]), n
    moved = [n for n, p in second.model.named_parameters()
             if n.startswith(BACKBONE) and not torch.equal(p, init[n])]
    assert moved
    with pytest.raises(SystemExit):
        cli.main(argv + ["--is_pc", "false"])


def cli_initial_backbone(tree):
    from achelous_tpu_torch.models.achelous import create_model
    cfg = AchelousConfig(resolution=RES, pc_points=PTS)
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                         train=True)
    return {n: p.detach() for n, p in model.named_parameters()
            if n.startswith(BACKBONE)}
