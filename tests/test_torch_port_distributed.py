"""The port's data-parallel training across ranks, on the CPU: two processes
in a gloo group (`torch_port_ranks.run_ranks`, spawned, a file rendezvous),
each running `torch_port_ranks`' functions on its rows of a global batch.

Held against the JAX package on the global batch:
  * `data/sampler.DistributedSampler`: JAX's indices over a grid of (n,
    replicas, rank, shuffle, drop_last, seed, epoch), the interleaved
    split and the wrap padding;
  * `broadcast_` into a RadarConv whose K1 weight pack is cached: the
    next call computes with the broadcast weights;
  * `gather_rows` and `jax_micro_layout`: the rows a rank takes for each
    of JAX's global micro-batches under grad_accum;
  * training BatchNorm across 2 ranks against `F32BatchNorm` on the
    concatenated batch: output, running statistics and the vjp of a random
    cotangent, float32, rtol 1e-5 / atol 1e-5 (the two-pass variance
    against JAX's one-pass, ops/norm.py), gradients rtol 1e-4, atol 1e-5
    of the largest;
  * `YoloXLoss` (with a global batch whose rank-1 images have no ground
    truth, so that rank's own foreground count is 0), CE (with and
    without class weights), focal, dice and the point-cloud NLL: every
    rank's value is the global batch's (rtol 1e-5), and its gradient is W
    times the global gradient w.r.t. its rows (rtol 1e-4, atol 1e-6 of the
    largest), the factor the step's mean over ranks cancels.

Held against the port's single-process step (which
tests/test_torch_port_train.py holds against JAX's `make_train_step`) on
the same global batch from the same weights:
  * one EN-GDF-PN-S0 step at 64^2, float32, global batch 8, for mtl sum,
    uncertainty and cagrad and for grad_accum 2 (the ranks exchange rows
    so that micro-batch m is the global batch's m-th slice, as the single
    process and JAX's scan take it): losses rtol 1e-5,
    grad_norm rtol 1e-3, and each tensor of the state (parameters,
    BatchNorm statistics, log_vars, momentum trace, EMA) within
    test_torch_port_train.py's `update_errors` gate of the single
    process's change plus twice the single process's own spread when the
    rows of each micro-batch are reversed (`torch_port_ranks.
    assert_state_gate`; with grad_accum 2 the first RadarConv's offset
    bias moves by less than that spread); both ranks' states equal;
    log_vars move under uncertainty alone.

`fit` across ranks is in test_torch_port_distributed_fit.py.
"""
import jax
import numpy as np
import pytest
import torch

from achelous_tpu.data.sampler import DistributedSampler as JaxSampler
from achelous_tpu.losses import detection as jdet
from achelous_tpu.losses import segmentation as jseg
from achelous_tpu.ops.norm import F32BatchNorm

import torch_port_ranks as R
from achelous_tpu_torch.data.sampler import DistributedSampler
from achelous_tpu_torch.parallel.dist import local_batch_size, rank_device
from achelous_tpu_torch.train import loop
from achelous_tpu_torch.train import train_state as tts

WORLD = 2


def close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [7, 64, 103])
def test_sampler_matches_jax(n, replicas, shuffle, drop_last):
    for rank in range(replicas):
        for seed in (0, 9):
            for epoch in (0, 1, 5):
                want = JaxSampler(n, replicas, rank, shuffle, seed,
                                  drop_last).epoch_indices(epoch)
                got = DistributedSampler(n, replicas, rank, shuffle, seed,
                                         drop_last).epoch_indices(epoch)
                np.testing.assert_array_equal(got, want)


def test_sampler_split_padding_and_defaults():
    """rank r takes perm[r::R] of RandomState(seed + epoch)'s permutation;
    103 over 4 ranks pads by wrapping to 104 (one index twice), drop_last
    truncates to 100 disjoint ones; without a process group the sampler is
    the only replica; a rank outside the replicas and a global batch the
    ranks do not divide raise."""
    perm = np.random.RandomState(9 + 3).permutation(64)
    for r in range(4):
        np.testing.assert_array_equal(
            DistributedSampler(64, 4, r, seed=9).epoch_indices(3),
            perm[r::4])
    shards = [DistributedSampler(103, 4, r, seed=5).epoch_indices(2)
              for r in range(4)]
    union = np.concatenate(shards)
    assert {len(s) for s in shards} == {26}
    assert len(union) == 104 and len(np.unique(union)) == 103
    shards = [DistributedSampler(103, 4, r, drop_last=True).epoch_indices(0)
              for r in range(4)]
    union = np.concatenate(shards)
    assert len(union) == len(np.unique(union)) == 100
    alone = DistributedSampler(10, shuffle=False)
    assert (alone.num_replicas, alone.rank) == (1, 0)
    np.testing.assert_array_equal(alone.epoch_indices(0), np.arange(10))
    with pytest.raises(ValueError, match="rank 2 not in"):
        DistributedSampler(10, 2, 2)
    assert local_batch_size(32, 2) == 16
    with pytest.raises(ValueError, match="global batch 6 not divisible by "
                                         "4 processes"):
        local_batch_size(6, 4)


def test_rank_devices():
    """`cuda` is cuda:LOCAL_RANK; NCCL refuses ranks that share a device
    or sit on the CPU; gloo takes both."""
    assert rank_device("cpu", "gloo", 1, 2) == torch.device("cpu")
    assert rank_device("cuda:0", "gloo", 1, 2) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        rank_device("cuda:0", "nccl", 1, 2)
    with pytest.raises(ValueError, match="nccl backend needs a GPU"):
        rank_device("cpu", "nccl", 0, 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="has no GPU of its own"):
            rank_device("cuda", "nccl", 1, 2)


def test_batches_from_takes_the_sampler_shard():
    """With a sampler, batches_from yields this rank's shard in order,
    in batches of the rank's size, and draws nothing from `rng`."""
    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i

    seen = []
    real = loop.collate
    loop.collate = lambda samples, cfg, max_gt: {"s": np.asarray(samples)}
    try:
        rng = np.random.RandomState(0)
        state = rng.get_state()[1].copy()
        sampler = DistributedSampler(10, 2, 1, seed=3)
        for b in loop.batches_from(Items(), None, 2, 8, True, rng,
                                   sampler=sampler, epoch=4):
            seen.extend(b["s"])
    finally:
        loop.collate = real
    np.testing.assert_array_equal(seen, sampler.epoch_indices(4)[:4])
    np.testing.assert_array_equal(rng.get_state()[1], state)


# ---------------------------------------------------------------------------
# BatchNorm and the losses across two ranks against JAX
# ---------------------------------------------------------------------------

BN_CASES = [((8, 6), 0.9), ((8, 6, 10), 0.97), ((8, 6, 5, 7), 0.9),
            ((8, 6, 5, 7), 0.97)]


def bn_case(shape, momentum, seed):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    params = {"weight": 1 + 0.1 * rng.randn(c), "bias": rng.randn(c),
              "running_mean": rng.randn(c), "running_var": rng.rand(c) + 0.5}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    ct = rng.randn(*shape).astype(np.float32)
    return x, params, 1.0 - momentum, ct


@pytest.fixture(scope="module")
def bn_runs():
    cases = [bn_case(s, m, i) for i, (s, m) in enumerate(BN_CASES)]
    return cases, R.run_ranks(R.batchnorm_rank, WORLD, cases)


def test_broadcast_rebuilds_the_cached_kernel_weights(bn_runs):
    """`broadcast_` writes rank 0's weights by `copy_`, which moves each
    parameter's version, so a RadarConv whose K1 pack was cached before
    the broadcast (as `fit`'s starts) computes with the new weights."""
    _, ranks = bn_runs
    first, second = ranks[0][0], ranks[1][0]
    np.testing.assert_array_equal(first["conv_after"], first["conv_before"])
    np.testing.assert_array_equal(second["conv_after"], first["conv_before"])
    assert not np.allclose(second["conv_before"], first["conv_before"])


def test_rows_cross_ranks_into_the_jax_micro_batches(bn_runs):
    """`gather_rows` gives every rank the global batch (rank 0's rows,
    then rank 1's) in each dtype; with grad_accum 2, `jax_micro_layout`
    gives rank r its half of each of JAX's micro-batches (global rows 0-3,
    then 4-7), so the rank's m-th slice is its share of micro-batch m."""
    _, ranks = bn_runs
    glob = R.layout_batch()
    for r, want_rows in enumerate(([0, 1, 4, 5], [2, 3, 6, 7])):
        got = ranks[r][0]
        for k, v in glob.items():
            np.testing.assert_array_equal(got["gathered"][k], v, err_msg=k)
            np.testing.assert_array_equal(got["layout"][k], v[want_rows],
                                          err_msg=k)
            assert got["layout"][k].dtype == v.dtype


@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batchnorm_across_ranks_matches_jax_on_the_global_batch(bn_runs,
                                                                case):
    cases, ranks = bn_runs
    ranks = [r[1:] for r in ranks]
    x, params, momentum, ct = cases[case]
    last = lambda a: np.moveaxis(a, 1, -1)  # noqa: E731  NC... -> N...C
    v = {"params": {"scale": params["weight"], "bias": params["bias"]},
         "batch_stats": {"mean": params["running_mean"],
                         "var": params["running_var"]}}
    bn = F32BatchNorm(use_running_average=False, momentum=1.0 - momentum)

    @jax.jit
    def fwd_vjp(p, xx, cot):
        def fwd(p, xx):
            return bn.apply({**v, "params": p}, xx, mutable=["batch_stats"])
        y, pull, mut = jax.vjp(fwd, p, xx, has_aux=True)
        return y, mut, pull(cot)
    want, mut, (g_params, g_x) = fwd_vjp(v["params"], last(x), last(ct))
    y = np.concatenate([r[case]["y"] for r in ranks])
    close(last(y), want, 1e-5, 1e-5, "y")
    for r in ranks:
        close(r[case]["mean"], mut["batch_stats"]["mean"], 1e-5, 1e-5)
        close(r[case]["var"], mut["batch_stats"]["var"], 1e-5, 1e-5)
        np.testing.assert_array_equal(r[case]["mean"], ranks[0][case]["mean"])
        np.testing.assert_array_equal(r[case]["var"], ranks[0][case]["var"])
    gx = np.concatenate([r[case]["x_grad"] for r in ranks])
    scale = np.abs(np.asarray(g_x)).max()
    close(last(gx), g_x, 1e-4, 1e-5 * scale, "x grad")
    # the affine's gradient is each rank's share of the global one
    for key, name in (("w_grad", "scale"), ("b_grad", "bias")):
        close(sum(r[case][key] for r in ranks), g_params[name], 1e-4,
              1e-5 * np.abs(np.asarray(g_params[name])).max(), key)


def det_cases(rng):
    """Head maps (NHWC, 3 levels at 64^2) and padded GTs for a global batch
    of 4: every image with GTs, or rank 1's two images with none."""
    k, g = 7, 8
    out = {}
    for kind, n in (("gts", (3, 2, 1, 2)), ("rank1_no_gt", (3, 2, 0, 0))):
        maps = [(rng.randn(4, s, s, 5 + k) * 0.5).astype(np.float32)
                for s in (8, 4, 2)]
        boxes = np.zeros((4, g, 4), np.float32)
        classes = np.zeros((4, g), np.int32)
        mask = np.zeros((4, g), bool)
        for i, ni in enumerate(n):
            boxes[i, :ni, :2] = rng.uniform(8, 56, (ni, 2))
            boxes[i, :ni, 2:] = rng.uniform(6, 30, (ni, 2))
            classes[i, :ni] = rng.randint(0, k, ni)
            mask[i, :ni] = True
        out[kind] = (maps, boxes, classes, mask)
    return out


@pytest.fixture(scope="module")
def loss_runs():
    rng = np.random.RandomState(21)
    dets = det_cases(rng)
    n_cls = 9
    labels = rng.randint(0, n_cls + 1, (4, 16, 16)).astype(np.int32)
    seg = {"n_cls": n_cls,
           "logits": rng.randn(4, 16, 16, n_cls).astype(np.float32) * 2,
           "labels": labels,
           "onehot": np.eye(n_cls + 1, dtype=np.float32)[labels],
           "weights": rng.rand(n_cls).astype(np.float32) + 0.5,
           "logp": np.asarray(jax.nn.log_softmax(rng.randn(4, 32, 8), -1),
                              np.float32),
           "pc_labels": rng.randint(0, 8, (4, 32)).astype(np.int32)}
    port = {k: v for k, v in seg.items() if k != "logits"}
    port["logits"] = np.ascontiguousarray(seg["logits"].transpose(0, 3, 1, 2))
    det_port = {k: ([np.ascontiguousarray(m.transpose(0, 3, 1, 2))
                     for m in maps], b, c, m_)
                for k, (maps, b, c, m_) in dets.items()}
    ranks = R.run_ranks(R.losses_rank, WORLD, det_port, port)

    lg, lab, oh, w = (seg[k] for k in ("logits", "labels", "onehot",
                                       "weights"))
    det = jax.jit(jax.value_and_grad(
        lambda ms, b, c, m: jdet.YoloXLoss(7)(ms, b, c, m)))
    want = {f"det/{k}": det(*case) for k, case in dets.items()}
    for name, fn in (
            ("ce", lambda x: jseg.ce_loss(x, lab, None, n_cls)),
            ("ce_weighted", lambda x: jseg.ce_loss(x, lab, w, n_cls)),
            ("focal", lambda x: jseg.focal_loss(x, lab, None, n_cls)),
            ("dice", lambda x: jseg.dice_loss(x, oh))):
        v, g = jax.jit(jax.value_and_grad(fn))(lg)
        want[name] = (v, [g])
    v, g = jax.jit(jax.value_and_grad(
        lambda x: jseg.pc_nll_loss(x, seg["pc_labels"])))(seg["logp"])
    want["pc_nll"] = (v, [g])
    return ranks, want, dets


LOSSES = ("det/gts", "det/rank1_no_gt", "ce", "ce_weighted", "focal",
          "dice", "pc_nll")


@pytest.mark.parametrize("name", LOSSES)
def test_losses_across_ranks_match_jax_on_the_global_batch(loss_runs, name):
    ranks, want, dets = loss_runs
    if name == "det/rank1_no_gt":
        assert not dets["rank1_no_gt"][3][2:].any()
    value, grads = want[name]
    for r in ranks:
        close(r[name][0], value, 1e-5, 1e-6, "value")
    channels_first = name != "pc_nll"
    for i, g in enumerate(grads):
        g = np.asarray(g)
        got = np.concatenate([r[name][1][i] for r in ranks]) / WORLD
        if channels_first:
            got = np.moveaxis(got, 1, -1)
        close(got, g, 1e-4, 1e-6 * np.abs(g).max(), f"gradient {i}")


# ---------------------------------------------------------------------------
# the whole step: two ranks against one process on the global batch
# ---------------------------------------------------------------------------


def single_step(mtl, accum, order=None):
    cfg, tcfg, state, batch = R.step_setup(mtl, accum)
    before = R.state_arrays(state)
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
    state, m = tts.make_train_step(cfg, tcfg)(state, batch, R.STEP_LR)
    return before, {k: float(v) for k, v in m.items()}, R.state_arrays(state)


@pytest.fixture(scope="module")
def step_runs():
    """Each case's single-process step, and its spread: how far the same
    step moves each tensor with the rows of every micro-batch reversed
    (the same arithmetic in another float32 order, as the ranks' sums
    are), which the gate adds twice, as the fit test's does."""
    torch.set_num_threads(R.THREADS)
    single = {}
    for name, (mtl, accum) in R.STEP_CASES.items():
        before, m, want = single_step(mtl, accum)
        mb = R.STEP_BATCH // accum
        rev = single_step(mtl, accum, [i * mb + mb - 1 - j
                                       for i in range(accum)
                                       for j in range(mb)])[2]
        single[name] = (before, m, want,
                        {k: np.abs(rev[k] - v).max() for k, v in want.items()})
    return single, R.run_ranks(R.step_rank, WORLD, list(R.STEP_CASES))


@pytest.mark.parametrize("name", list(R.STEP_CASES))
def test_two_rank_step_equals_the_single_process_step(step_runs, name):
    single, ranks = step_runs
    before, want_m, want, spread = single[name]
    got_m, got = ranks[0][name]
    assert got_m["skipped_nonfinite"] == want_m["skipped_nonfinite"] == 0.0
    for k in ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc"):
        close(got_m[k], want_m[k], 1e-5, 0, k)
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-3, 0, "grad_norm")
    for k, v in got.items():
        np.testing.assert_array_equal(v, ranks[1][name][1][k], err_msg=k)
    assert ranks[1][name][0] == got_m
    moved = np.abs(got["param/log_vars"] - before["param/log_vars"]).max()
    assert (moved > 0) == (name == "uncertainty")
    R.assert_state_gate(before, got, want, spread)


