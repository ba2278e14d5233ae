"""`fit` across two ranks of a gloo group on the CPU
(`torch_port_ranks.run_ranks`, the ranks running `torch_port_ranks.fit_rank`
/ `resume_rank`), held against the port's single-process `fit` (which
test_torch_port_fit.py runs) fed the same global batches.

EN-GDF-PN-S0 at 64x64, float32, global batch 4 (2 a rank), 2 epochs on a
temporary WaterScenes tree of 8 training and 4 validation frames with raw
radar CSVs:
  * the history of rank 0 (rank 1 writes nothing): the losses and
    validation losses rtol 1e-4, the detection and segmentation metrics
    of the online evaluation (rank 0, the whole validation set) within
    1e-6; the point-cloud ones are left out: the evaluation resamples each
    frame's points from the dataset's generator, which the two runs have
    drawn differently;
  * grad_norm and the final state within the step's gates
    (test_torch_port_distributed.py) plus twice the single process's own
    spread, read from its run with each batch's rows reversed: PointNet's
    fully connected BatchNorms over a batch of 4 make float32 chaotic, and
    the reversal alone moves its momentum trace by tens of percent;
  * a resume in new processes from rank 0's epoch-1 checkpoint, whose
    final state equals the uninterrupted run's on both ranks, bit for bit,
    each rank with its own data generators back; the same checkpoint
    resumed by one process is refused;
  * the train CLI under torchrun (two ranks, gloo, the CPU) trains an
    epoch, rank 0 alone printing and writing.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as R
from achelous_tpu_torch.data.example import write_tree
from achelous_tpu_torch.data.sampler import DistributedSampler
from achelous_tpu_torch.train import checkpoints, loop
from achelous_tpu_torch.train import train_state as tts

WORLD = 2


def close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def global_batches(per_rank, reverse=False):
    """The ranks' batches of one loop, each pair concatenated in rank
    order (with `reverse`, its rows in reverse order)."""
    out = []
    for parts in zip(*per_rank):
        b = {k: np.concatenate([p[k] for p in parts])
             for k in parts[0] if k != "n_valid"}
        if reverse:
            b = {k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
        b["n_valid"] = sum(p["n_valid"] for p in parts)
        out.append(b)
    return out


def replayed_fit(log_dir, tree, calls, reverse=False):
    """A single-process `fit` whose training and validation loops draw the
    global batches of the ranks' recorded `calls`."""
    loops = [global_batches(per_rank, reverse) for per_rank in
             zip(*[[b for _, b in c] for c in calls])]
    real = loop.batches_from

    def replay(dataset, *a, **kw):
        if not kw.get("drop_last", True):       # the online evaluation
            return real(dataset, *a, **kw)
        return iter(loops.pop(0))
    loop.batches_from = replay
    try:
        state, _, _ = R.recorded_fit(log_dir, tree)
    finally:
        loop.batches_from = real
    assert not loops
    return R.state_arrays(state), history(log_dir)


def history(path):
    return [json.loads(line) for line in open(os.path.join(path,
                                                           "history.jsonl"))]


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """The 2-rank run, its resume from rank 0's epoch-1 checkpoint in new
    processes, and one process fed the same global batches, in order and
    with each batch's rows reversed: at global batch 4 PointNet's fully
    connected BatchNorms make float32 chaotic (test_torch_port_train.py),
    and the reversal reads that spread as chip_smoke.py's T2 does."""
    torch.set_num_threads(R.THREADS)
    tree = write_tree(str(tmp_path_factory.mktemp("ws_dist")), frames=12,
                      size=(96, 54), points=40, val=4)
    root = str(tmp_path_factory.mktemp("fit_dist"))
    ranks = R.run_ranks(R.fit_rank, WORLD, root, tree)
    resumed = R.run_ranks(R.resume_rank, WORLD, root, tree)
    calls = [r["calls"] for r in ranks]
    single = replayed_fit(os.path.join(root, "single"), tree, calls)
    spread = replayed_fit(os.path.join(root, "reversed"), tree, calls, True)
    return dict(root=root, tree=tree, ranks=ranks, resumed=resumed,
                single=single, spread=spread,
                kinds=[k for k, _ in ranks[0]["calls"]])


def test_two_rank_fit_history_equals_the_single_process_one(fit_runs):
    """Losses rtol 1e-4; grad_norm rtol 1e-3 plus twice the single
    process's own move under the reversal; the evaluation's detection and
    segmentation metrics within 1e-6."""
    root = fit_runs["root"]
    assert fit_runs["kinds"] == ["train", "val"] * 2
    assert not os.path.exists(os.path.join(root, "full", "r1"))
    got = history(os.path.join(root, "full", "r0"))
    want, rev = fit_runs["single"][1], fit_runs["spread"][1]
    assert [h["epoch"] for h in got] == [0, 1]
    for g, w, r in zip(got, want, rev):
        assert set(g) == set(w)
        for k, v in w.items():
            if "pc" in k.split("/")[0]:
                continue          # miou_pc, iou_pc/*, but not loss_pc
            if k == "grad_norm":
                close(g[k], v, 1e-3, 2 * abs(r[k] - v), k)
            elif k.startswith(("loss", "val_")):
                close(g[k], v, 1e-4, 0, k)
            else:
                close(g[k], v, 0, 1e-6, k)
    assert "mAP50" in got[1] and got[1]["n_images"] == 4
    ckpt = checkpoints.CheckpointManager(os.path.join(root, "full", "r0",
                                                      "ckpt"))
    assert len(ckpt.periodic()) == 2 and ckpt.exists("last_epoch_weights")


def test_two_rank_fit_state_equals_the_single_process_one(fit_runs):
    """Both ranks' states equal; each tensor's change over the run within
    `torch_port_ranks.assert_state_gate` plus twice the single process's
    own move under the reversal."""
    ranks = fit_runs["ranks"]
    (single, _), (rev, _) = fit_runs["single"], fit_runs["spread"]
    assert ranks[0]["counters"] == ranks[1]["counters"] == (4, 2, 4)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)
    cfg, tcfg, _, _ = R.fit_setup(fit_runs["tree"])
    from achelous_tpu_torch.models.achelous import create_model
    start = R.state_arrays(tts.create_train_state(
        create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                     train=True), cfg, tcfg))
    R.assert_state_gate(start, ranks[0]["state"], single,
                      {k: np.abs(rev[k] - v).max() for k, v in
                       single.items()})
    rngs = ranks[0]["data_rng"]["ranks"]
    assert len(rngs) == WORLD
    assert all(set(r) == {"shuffle", "train", "val"} for r in rngs)


def test_two_rank_resume_equals_the_uninterrupted_run(fit_runs):
    for full, resumed in zip(fit_runs["ranks"], fit_runs["resumed"]):
        assert resumed["counters"] == full["counters"]
        for k, v in full["state"].items():
            np.testing.assert_array_equal(v, resumed["state"][k], err_msg=k)
        assert [m.split("(")[0] for m in resumed["msgs"]] == \
            [m.split("(")[0] for m in full["msgs"][1:]]
    hist = history(os.path.join(fit_runs["root"], "resume", "r0"))
    assert [h["epoch"] for h in hist] == [1]
    assert not os.path.exists(os.path.join(fit_runs["root"], "resume", "r1"))


def test_resume_at_another_number_of_ranks_is_refused(fit_runs):
    root, tree = fit_runs["root"], fit_runs["tree"]
    cfg, tcfg, _, _ = R.fit_setup(tree)
    from achelous_tpu_torch.models.achelous import create_model
    state = tts.create_train_state(
        create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                     train=True), cfg, tcfg)
    ckpt = checkpoints.CheckpointManager(os.path.join(root, "full", "r0",
                                                      "ckpt"))
    state = ckpt.restore(ckpt.periodic()[0], state)
    with pytest.raises(ValueError, match="2 rank.*not 1"):
        R.recorded_fit(os.path.join(root, "refused"), tree, state=state)


def test_validation_smaller_than_a_batch_gives_no_loss_batches(fit_runs):
    """`fit`'s validation-loss loop takes whole batches only (drop_last,
    as JAX's loop and the reference's validation loader): 4 frames at a
    global batch of 8 give none, in one process and on each of 2 ranks
    (4 rows a rank), so the progress line prints val=nan and the history
    holds no val_* key; at a global batch of 4, one batch."""
    cfg, tcfg, _, val_ds = R.fit_setup(fit_runs["tree"])
    rng = np.random.RandomState(0)

    def n_batches(bs, sampler=None):
        return len(list(loop.batches_from(val_ds, cfg, bs, tcfg.max_gt,
                                          False, rng, sampler=sampler)))

    assert len(val_ds) == 4
    assert (n_batches(8), n_batches(4)) == (0, 1)
    for r in range(WORLD):
        sampler = DistributedSampler(len(val_ds), WORLD, r, shuffle=False)
        assert (n_batches(4, sampler), n_batches(2, sampler)) == (0, 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_trains_across_ranks_under_torchrun(fit_runs, tmp_path):
    log_dir = str(tmp_path / "logs")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node=2", "--master_addr=localhost",
           f"--master_port={free_port()}", "-m",
           "achelous_tpu_torch.train.cli", "--data_root", fit_runs["tree"],
           "--device", "cpu", "--dist_backend", "gloo", "--bf16", "false",
           "--resolution", "64", "--bs", "4", "--pc_num", "64",
           "--epoch", "1", "--log_dir", log_dir]
    env = {**os.environ, "OMP_NUM_THREADS": str(R.THREADS)}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("2 ranks over gloo") == 1
    assert proc.stdout.count("epoch 1/1") == 1
    hist = history(log_dir)
    assert [h["epoch"] for h in hist] == [0] and "mAP50" in hist[0]
    assert np.isfinite(hist[0]["val_loss"]), hist[0]
    assert checkpoints.CheckpointManager(
        os.path.join(log_dir, "ckpt")).exists("last_epoch_weights")
