"""Training EF-GDF-PN-S0 and EN-GDF-PN2-S0 in the PyTorch port against the
JAX package, on the CPU.

For each of the two configurations, at 64x64, float32, from the same
numpy-seeded variables and batch (the constants of
test_torch_port_train.py: bs 8 in two micro-batches, point clouds scaled
per sample, `mtl="uncertainty"`):

  * one step of JAX `make_train_step` (one compile per configuration)
    against the port's, the JAX state carried across by
    `weights.load_train_state_from_jax` (`achelous_mapping(..., "ef", ...)`,
    or the mapping without PointNet plus `weights.pointnet2_entries`):
    every loss and grad_norm within rtol 1e-3, and each tensor's change
    (parameters, BatchNorm statistics, EMA, log_vars) within
    `update_errors`' bound of JAX's plus twice float32's own spread on
    that tensor (`SPREAD_FLOOR`, as chip_smoke.py's T2 holds the card to
    the CPU): both sides take the step again on the batch with the image,
    radar map and points scaled by 1 + 1e-6 and with the samples of each
    micro-batch reversed, and the spread is the largest change that moves a
    tensor's update on either side.  The EN test's bound alone does not
    hold here: in EF's neck and decoders and in PointNet++'s smallest
    levels (4-8 points under a BatchNorm) JAX's own update moves by as
    much as the port's differs from it under these perturbations;
  * that widened gate still fails a wrong step: the port's step taken
    again with a fault planted (one micro-batch dropped, the other taken
    twice; K1's output cut from the graph, as the CUDA kernel's was before
    its autograd Function; no weight decay) moves tensors past it;
  * the weight-decay set against JAX's `_wd_mask` through the mapping;
  * the tensors `core/init.weights_init` re-draws against those JAX's
    `weights_init` re-draws (conv kernels of rank >= 3 and BatchNorm
    scales), and each scheme's spread on the large kernels.

EF's attention trains through K3's autograd Function; on the CPU its
forward is the plain version, and its backward is the one that runs on
the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.core import init as jinit
from achelous_tpu.data.synthetic import synthetic_batch as jax_synthetic
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.train import train_state as jts
from achelous_tpu.utils.torch_import import achelous_mapping

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.core.init import flax_conv_weights, weights_init
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops import hopper_deform
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.train import train_state as tts
from achelous_tpu_torch.weights import (load_train_state_from_jax,
                                        pointnet2_entries)
from test_torch_port_slice import random_variables
from test_torch_port_train import (LR, MAX_GT, PC_SCALES, RES, STEP_BATCH,
                                   close, jax_state, numpy_state,
                                   update_errors)

FAMILIES = {"ef": dict(backbone="ef", pc_model="pn"),
            "pn2": dict(backbone="en", pc_model="pn2")}
SPREAD_FLOOR = 2.0
# the perturbations of the batch that measure float32's spread: the
# inputs of the three branches scaled by 1 + 1e-6, each micro-batch of 4
# reversed.  Each alone leaves a PointNet++ tensor past the gate, the two
# together none; each costs both sides a step
INPUTS = ("image", "radar", "pc")
PERTURB = (lambda k, v: v * (1 + 1e-6) if k in INPUTS else v,
           lambda k, v: v[[3, 2, 1, 0, 7, 6, 5, 4]])
FAULTS = ("micro_batch_dropped", "k1_graph_cut", "no_weight_decay")


def mapping(family):
    axes = FAMILIES[family]
    if axes["pc_model"] == "pn2":
        return list(achelous_mapping("S0", axes["backbone"], "gdf",
                                     with_pc=False)) + pointnet2_entries()
    return list(achelous_mapping("S0", axes["backbone"], "gdf"))


def flax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def plant(fault, monkeypatch):
    """Plant `fault` in the port's step; returns the change it makes to
    the step's batch."""
    if fault == "micro_batch_dropped":
        return lambda k, v: torch.cat([v[:STEP_BATCH // 2]] * 2)
    if fault == "k1_graph_cut":
        forward = hopper_deform.fused_radarconv

        def graphless(*args):
            with torch.no_grad():
                return forward(*args)
        monkeypatch.setattr(hopper_deform, "fused_radarconv", graphless)
    else:
        monkeypatch.setattr(tts, "decay_mask", lambda model: set())
    return lambda k, v: v


def gate_failures(r, got):
    """name -> err / bound of each tensor past the state gate: its bound
    of JAX's change (`update_errors`) plus `SPREAD_FLOOR` times its float32
    spread."""
    bad = {}
    for k, (err, bound) in update_errors(r["before"], got, r["want"]).items():
        bound = bound + SPREAD_FLOOR * r["spread"][k]
        if err > bound:
            bad[k] = float(err / bound)
    return bad


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def step_run(request):
    return run_family(request.param)


def run_family(family):
    """JAX: one jitted step from random variables, on the batch and on its
    perturbations; the port: the same state carried across, the same
    steps; JAX's states after its steps carried across as the reference.
    `spreads`: per perturbation and tensor, the largest change it makes to
    either side's state after the step; `spread` the largest of them.
    `port_run(change)` takes the port's step again on the changed batch."""
    axes = FAMILIES[family]
    jcfg = JaxConfig(phi="S0", neck="gdf", resolution=RES, **axes)
    jmodel = jax_create_model(jcfg)
    tcfg_j = jts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty", grad_accum=2)
    arrays = jax_synthetic(jcfg, STEP_BATCH, MAX_GT, seed=5)
    arrays["pc"] = arrays["pc"] * PC_SCALES[:, None, None]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            arrays["image"][:2], arrays["radar"][:2],
                            arrays["pc"][:2])
    s0 = jax_state(random_variables(shapes, seed=2), tcfg_j)
    step = jax.jit(jts.make_train_step(jmodel, jcfg, tcfg_j))

    cfg = AchelousConfig(resolution=RES, **axes)
    tcfg = tts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty", grad_accum=2)
    entries = mapping(family)
    port_step = tts.make_train_step(cfg, tcfg)

    def port_state(jstate):
        state = tts.create_train_state(create_model(cfg, "cpu", train=True),
                                       cfg, tcfg)
        load_train_state_from_jax(state, jstate, entries)
        return state

    batch = synthetic_batch(cfg, STEP_BATCH, MAX_GT, seed=5, device="cpu")
    batch["pc"] = batch["pc"] * torch.from_numpy(PC_SCALES)[:, None, None]

    def port_run(change):
        state = port_state(s0)
        state, metrics = port_step(state, {k: change(k, v)
                                           for k, v in batch.items()}, LR)
        return state, metrics

    runs = []
    for change in (lambda k, v: v,) + PERTURB:
        s1, m1 = step(s0, {k: jnp.asarray(change(k, v))
                           for k, v in arrays.items()}, jnp.float32(LR))
        state, metrics = port_run(change)
        runs.append((numpy_state(state), numpy_state(port_state(s1)),
                     state, metrics, m1))
    (got, want, state, metrics, m1), others = runs[0], runs[1:]
    spreads = [{k: max(np.abs(o[0][k] - got[k]).max(),
                       np.abs(o[1][k] - want[k]).max()) for k in got}
               for o in others]
    return dict(family=family, shapes=shapes, entries=entries, state=state,
                before=numpy_state(port_state(s0)), got=got, want=want,
                spreads=spreads,
                spread={k: max(s[k] for s in spreads) for k in got},
                metrics=metrics, port_run=port_run,
                want_metrics={k: float(v) for k, v in m1.items()})


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_weights_init_schemes(init_type):
    """Each re-drawn kernel of >= 4096 values has the scheme's standard
    deviation within 10 % (normal: gain; xavier: gain * sqrt(2 / (fan_in +
    fan_out)); kaiming: sqrt(2 / fan_in); orthogonal: gain /
    sqrt(max(out, fan_in))); the Dense-like convs, biases and BatchNorm
    biases keep or take their values; BatchNorm scales ~ N(1, 0.02)."""
    cfg = AchelousConfig(resolution=RES, backbone="en", pc_model="pn2")
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(1),
                         train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gain = 0.05
    weights_init(model, init_type, gain, torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    redrawn = flax_conv_weights(model)
    checked = 0
    for name in redrawn:
        w = params[name].detach()
        recep = int(np.prod(w.shape[2:]))
        fan_in, fan_out = w.shape[1] * recep, w.shape[0] * recep
        want = {"normal": gain,
                "xavier": gain * np.sqrt(2.0 / (fan_in + fan_out)),
                "kaiming": np.sqrt(2.0 / fan_in),
                "orthogonal": gain / np.sqrt(max(w.shape[0], fan_in))
                }[init_type]
        if w.numel() >= 4096:
            assert abs(float(w.std()) / want - 1) < 0.1, name
            checked += 1
    assert checked >= 10
    bn = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    scales = {f"{n}.weight" for n in bn}
    biases = {f"{n}.bias" for n in bn}
    for n, p in params.items():
        if n in biases:
            assert torch.count_nonzero(p) == 0, n
        elif n not in redrawn and n not in scales:
            assert torch.equal(p, before[n]), n
    assert any("mlp_convs" in n for n in params)
    scales = torch.cat([params[n].detach() for n in scales])
    assert abs(float(scales.mean()) - 1) < 5e-3
    assert abs(float(scales.std()) / 0.02 - 1) < 0.1


def test_train_step_metrics_match_jax(step_run):
    """Every loss and grad_norm, rtol 1e-3 (float32, with discrete
    SimOTA decisions on both sides)."""
    r = step_run
    assert r["metrics"]["skipped_nonfinite"] == 0.0
    assert r["want_metrics"]["skipped_nonfinite"] == 0.0
    for k in ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
              "grad_norm"):
        close(r["metrics"][k], r["want_metrics"][k], 1e-3, 0, k)


def test_train_step_state_matches_jax(step_run):
    """Each tensor's change over the step within its bound of JAX's
    (`update_errors`) plus `SPREAD_FLOOR` times its float32 spread;
    log_vars within rtol 1e-3."""
    r = step_run
    assert set(r["got"]) == set(r["want"])
    bad = gate_failures(r, r["got"])
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    close(r["got"]["log_vars"] - r["before"]["log_vars"],
          r["want"]["log_vars"] - r["before"]["log_vars"], 1e-3, 1e-7)


def test_weight_decay_set_matches_jax_mask(step_run):
    """The port's decayed parameters are exactly those whose flax leaf
    JAX's `_wd_mask` marks, carried through the mapping."""
    mask = jts._wd_mask(step_run["shapes"]["params"])
    want = {key for path, coll, key, *_ in step_run["entries"]
            if coll == "params" and flax_leaf(mask, path)}
    assert tts.decay_mask(step_run["state"].model) == want


def test_weights_init_redraws_what_jax_redraws(step_run):
    """`flax_conv_weights` names exactly the tensors whose flax leaf is a
    `kernel` of rank >= 3, and the BatchNorm scales are exactly those of
    the modules with running statistics (JAX's `_bn_paths`)."""
    params = step_run["shapes"]["params"]
    bn = jinit._bn_paths(step_run["shapes"]["batch_stats"])
    convs, scales = set(), set()
    for path, coll, key, *_ in step_run["entries"]:
        if coll != "params":
            continue
        if path[-1] == "kernel" and flax_leaf(params, path).ndim >= 3:
            convs.add(key)
        if path[-1] == "scale" and tuple(path[:-1]) in bn:
            scales.add(key)
    model = step_run["state"].model
    assert set(flax_conv_weights(model)) == convs
    assert {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, BatchNorm)} == scales


@pytest.mark.parametrize("fault", FAULTS)
def test_state_gate_fails_a_planted_fault(step_run, fault, monkeypatch):
    """The port's step taken again with `fault` planted moves tensors past
    the gate of `test_train_step_state_matches_jax`: one micro-batch
    dropped (the other taken twice) moves every gradient; K1's output cut
    from the graph leaves the RadarConvs' offset, modulator and projection
    weights without a gradient; no weight decay moves every decayed
    kernel by lr * wd * its value."""
    state, _ = step_run["port_run"](plant(fault, monkeypatch))
    bad = gate_failures(step_run, numpy_state(state))
    assert bad
    if fault == "k1_graph_cut":
        assert any(".regular_conv." in k for k in bad), sorted(bad)
