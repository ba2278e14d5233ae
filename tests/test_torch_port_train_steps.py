"""One whole training step of each of the port's newly held configurations
against JAX's `make_train_step`, on the CPU (slow: a JAX step compile and
six steps on each side take 57-308 s a configuration on an 8-core CPU).

The twelve configurations of test_torch_port_train_configs.py, at 64x64,
float32, batch 8 (`grad_accum=1`), `mtl="uncertainty"`, point clouds
scaled per sample (test_torch_port_train.py's `PC_SCALES`), from the same
numpy-seeded variables and batch, the JAX state carried across by
`weights.load_train_state_from_jax`.  The gate is
test_torch_port_train_ef_pn2.py's: every loss and grad_norm within rtol
1e-3, and each tensor's change (parameters, BatchNorm statistics, EMA,
log_vars) within `update_errors`' bound of JAX's plus `SPREAD_FLOOR`
times the float32 spread measured on both sides (the step taken again on
the batch with image, radar map and points scaled by 1 + 1e-6 and by
1 - 1e-6, and on the batch in reverse order, as chip_smoke.py's T2 reads
the card's spread; and from the variables with every deformable offset
moved by +- 2e-5 cells, float32's reach at the offsets).

Each planted fault of a family, taken in each of its configurations, must
fail that gate: EN (no weight decay),
MobileViT (the transformer's layers run in reverse order), the CSP neck
(the bottlenecks' shortcut dropped), EdgeViT (stages 1-3 read after their
blocks, not after the patch embeddings), PoolFormer (pooling counts the
padding), EfficientFormerV2-L (K3's output cut from the graph), RepViT
(RepVGGDW's identity dropped), MobileOne (the 1x1 `rbr_scale` branch
dropped), FastViT (RepMixer's layer scale applied to `mixer` instead of
`mixer - norm`) and the RepVGG neck (`rdf`: RepVGG's 1x1 branch dropped).

The reparameterizable configurations (RV-GDF-PN-S0, MO-RDF-PN-S0,
FV-RDF-PN-S0) are trained in their train form; after the step each
side's EMA (parameters and the statistics the step moved) is folded by
its package's `reparameterize` and served in the deploy form, in eval
mode: JAX's EMA carried across and folded by the port against JAX's fold
of it; the port's fold of its own EMA against JAX's of its own, within
STEP_MOVE of the most the step moved JAX's outputs plus SPREAD_FLOOR
times the spread the perturbed steps read; the port's deploy form
against its train form on the same EMA.  MobileOne-S0's whole backbone
is held in train mode against the flax module here too
(test_torch_port_train_modules.py's harness and gates, with the spread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.core.reparam import reparameterize as jax_reparameterize
from achelous_tpu.data.synthetic import synthetic_batch as jax_synthetic
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.train import train_state as jts

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.models import edgevit, efficientformer, fastvit
from achelous_tpu_torch.models import mobilevit, poolformer, repvit
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops import blocks, mobileone_block
from achelous_tpu_torch.train import train_state as tts
from achelous_tpu_torch.weights import load_train_state_from_jax
from test_torch_port_configs import jax_entries
from test_torch_port_slice import nchw, random_variables
from test_torch_port_train import (LR, MAX_GT, PC_SCALES, RES, STEP_BATCH,
                                   close, jax_state, numpy_state)
from test_torch_port_train_configs import CONFIGS
from test_torch_port_train_ef_pn2 import SPREAD_FLOOR, gate_failures
import test_torch_port_train_modules as train_modules

pytestmark = pytest.mark.slow

INPUTS = ("image", "radar", "pc")
# chip_smoke.py T2's perturbations: the inputs scaled by 1 +- 1e-6, the
# batch reversed.  With the +1e-6 scaling and the reversal alone,
# MobileViT-S1's first neck ghost module's BatchNorm bias stayed past the
# gate, though scaling by 1 - 1e-6 moves the port's own update of it by
# as much as the port's differs from JAX's (1.57e-4 against 1.56e-4)
PERTURB = (lambda k, v: v * (1 + 1e-6) if k in INPUTS else v,
           lambda k, v: v * (1 - 1e-6) if k in INPUTS else v,
           lambda k, v: v[list(range(STEP_BATCH - 1, -1, -1))])
# Every deformable offset moved by +- OFFSET_NUDGE cells, on both sides:
# the two forwards' offsets differ by float32 rounding, and where one lies
# that close to an integer the sampling's slope jumps between the two.
# PoolFormer-S0's RadarConv block 5 has an offset 1.38e-5 below an
# integer that JAX's forward puts past it: moving the port's offsets there
# by +2e-5 moves that offset conv's update by 6.23e-5, the port's whole
# difference from JAX's (and by -2e-5, 5.2e-7)
OFFSET_NUDGE = 2e-5
# For RV-GDF-PN-S0 (NORM_NUDGED), also every normalisation's bias
# (BatchNorm, GroupNorm, LayerNorm: each flax leaf "bias" beside a
# "scale") moved by +- NORM_NUDGE on both sides, which moves every ReLU
# input behind a norm by that much.  Their train-mode forwards differ
# between the packages by up to ~1e-4 at O(1) pre-activations (RepViT's
# residual stages amplify float32 rounding; the RV backbone's outputs in
# test_torch_port_train_modules.py), where the inputs' scaling is undone
# by the first BatchNorm and the reversal reaches ~1e-7: in RV-GDF-PN-S0
# one ReLU input of the head's level-1 class tower lies 6.0e-5 from 0
# and on the other side of it in JAX's forward, and flipping that one
# element's sign in the port's step brings every tensor inside the gate
# (det_head.cls_convs.1.0: its pointwise weight's update 1.53x the gate
# before).  MO-RDF-PN-S0 and FV-RDF-PN-S0 pass their gates without it.
NORM_NUDGE = 1e-4
NORM_NUDGED = ("RV-GDF-PN-S0",)
# configuration -> the faults planted in its families (backbone, neck)
FAULTS = {"EN-GDF-PN-S1": ("no_weight_decay",),
          "EN-GDF-PN-S2": ("no_weight_decay",),
          "EN-GDF-PN-S0-SPPF": ("no_weight_decay",),
          "EN-GDF-PN-S0-HEAD256": ("no_weight_decay",),
          "MV-GDF-PN-S1": ("transformer_layers_reversed",),
          "EN-CDF-PN2-S2": ("csp_shortcut_dropped",),
          "EV-GDF-PN-S0": ("stage_features_after_blocks",),
          "PF-GDF-PN-S0": ("pool_counts_padding",),
          "EF-GDF-PN-L": ("k3_graph_cut",),
          "RV-GDF-PN-S0": ("repvggdw_identity_dropped",),
          "MO-RDF-PN-S0": ("mobileone_scale_dropped", "repvgg_1x1_dropped"),
          "FV-RDF-PN-S0": ("repmixer_scale_on_mixer", "repvgg_1x1_dropped")}
# the reparameterizable configurations: after the step, each side's EMA
# folded (`reparameterize`) and served in the deploy form, in eval mode,
# on the step batch's first DEPLOY_ROWS samples
DEPLOY = ("RV-GDF-PN-S0", "MO-RDF-PN-S0", "FV-RDF-PN-S0")
METRICS = ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
           "grad_norm")
DEPLOY_ROWS = 2
OUTPUTS = ("det0", "det1", "det2", "sem", "lane", "pc")
# A step leaves each BatchNorm's running statistics at 0.9 x its drawn
# ones + 0.1 x the batch's, which in eval mode do not normalise
# MobileOne-S0's six summed branches a block: its maps grow ~2x a block
# (to ~1e9 and beyond, as in the JAX package), so every deploy gate is
# relative to the output's own scale, max(1, max |ref|).
# The fold on one EMA (JAX's, carried across): the slice tolerance
FOLD_REL = 2e-3
# The deploy form against the train form's eval output on the port's own
# EMA: PERF.md's deploy gate (the fold changes float32 rounding only)
DEPLOY_TOL = 1e-4
# The port's fold of its EMA against JAX's fold of JAX's: STEP_MOVE of
# the most the step moved JAX's deploy outputs, FOLD_REL of their scale,
# and SPREAD_FLOOR times the most any perturbation of the step moved
# either side's
STEP_MOVE = 5e-2


def plant(fault, monkeypatch):
    """Plant `fault` in the port's modules (undone by `monkeypatch`)."""
    if fault == "no_weight_decay":
        monkeypatch.setattr(tts, "decay_mask", lambda model: set())
    elif fault == "transformer_layers_reversed":
        def reversed_layers(self, x):
            for attn, ff in reversed(self.layers):
                x = x + attn(x)
                x = x + ff(x)
            return x
        monkeypatch.setattr(mobilevit.Transformer, "forward",
                            reversed_layers)
    elif fault == "csp_shortcut_dropped":
        monkeypatch.setattr(blocks.Bottleneck, "forward",
                            lambda self, x: self.conv2(self.conv1(x)))
    elif fault == "stage_features_after_blocks":
        def after_blocks(self, x):
            feats = []
            for i in range(1, 5):
                x = getattr(self, f"patch_embed{i}")(x)
                for block in getattr(self, f"blocks{i}"):
                    x = block(x)
                if i < 4:
                    feats.append(x)
            feats.append(self.norm(x))
            return tuple(feats)
        monkeypatch.setattr(edgevit.EdgeViT, "forward", after_blocks)
    elif fault == "pool_counts_padding":
        pool = poolformer.F.avg_pool2d
        monkeypatch.setattr(
            poolformer.F, "avg_pool2d",
            lambda *a, **kw: pool(*a, **{**kw, "count_include_pad": True}))
    elif fault == "k3_graph_cut":
        attention = efficientformer.fused_bias_attention

        def graphless(*args):
            with torch.no_grad():
                return attention(*args)
        monkeypatch.setattr(efficientformer, "fused_bias_attention",
                            graphless)
    elif fault == "repvggdw_identity_dropped":
        monkeypatch.setattr(repvit.RepVGGDW, "forward",
                            lambda self, x: self.conv(x) + self.conv1(x))
    elif fault == "mobileone_scale_dropped":
        def no_scale(self, x):
            y = self.rbr_skip(x) if hasattr(self, "rbr_skip") else 0.0
            for branch in getattr(self, "rbr_conv", ()):
                y = y + branch(x)
            if self.se is not None:
                y = self.se(y)
            if not self.use_act:
                return y
            return torch.relu(y) if self.act == "relu" else \
                torch.nn.functional.gelu(y)
        monkeypatch.setattr(mobileone_block.MobileOneBlock, "forward",
                            no_scale)
    elif fault == "repmixer_scale_on_mixer":
        monkeypatch.setattr(
            fastvit.RepMixer, "forward",
            lambda self, x: x + self.layer_scale * self.mixer(x))
    else:
        assert fault == "repvgg_1x1_dropped", fault

        def no_1x1(self, x):
            y = self.rbr_dense(x)
            if hasattr(self, "rbr_identity"):
                y = y + self.rbr_identity(x)
            return torch.relu(y)
        monkeypatch.setattr(blocks.RepVGGBlock, "forward", no_1x1)


# configuration -> its deploy results (`run_config`'s "deploy")
SERVED = {}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def step_run(request):
    r = run_config(request.param)
    if r["deploy"] is not None:
        SERVED[r["name"]] = r["deploy"]
    return r


@pytest.fixture(scope="module", params=DEPLOY)
def deploy_run(request):
    """The deploy results of a reparameterizable configuration: those of
    `step_run` where it ran first."""
    if request.param not in SERVED:
        SERVED[request.param] = run_config(request.param)["deploy"]
    return SERVED[request.param]


def nudge_offsets(variables, d):
    """`variables` with every RadarConv offset conv's bias moved by `d`,
    which moves every deformable offset by `d` cells."""
    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        return a + np.float32(d) if keys[-2:] == ["offset_conv", "bias"] \
            else a
    return {**variables,
            "params": jax.tree_util.tree_map_with_path(leaf,
                                                       variables["params"])}


def nudge_norms(variables, d):
    """`variables` with every normalisation's bias moved by `d`."""
    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: walk(v) for k, v in tree.items()}
        if "scale" in tree and "bias" in tree and "kernel" not in tree:
            out["bias"] = tree["bias"] + np.float32(d)
        return out
    return {**variables, "params": walk(variables["params"])}


def run_config(name):
    """JAX: one jitted step from random variables, on the batch, on its
    perturbations and from the variables with the offsets nudged; the
    port: the same states carried across, the same steps; JAX's states
    after its steps carried across as the reference.  The spread of a
    tensor is the most any of these moves its change over the step on
    either side.  `port_run(change)` takes the port's step again on the
    changed batch."""
    kw = CONFIGS[name]
    jcfg = JaxConfig(resolution=RES, **kw)
    jmodel = jax_create_model(jcfg)
    tcfg_j = jts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty")
    arrays = jax_synthetic(jcfg, STEP_BATCH, MAX_GT, seed=5)
    arrays["pc"] = arrays["pc"] * PC_SCALES[:, None, None]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            arrays["image"][:2], arrays["radar"][:2],
                            arrays["pc"][:2])
    variables = random_variables(shapes, seed=2)
    s0 = jax_state(variables, tcfg_j)
    step = jax.jit(jts.make_train_step(jmodel, jcfg, tcfg_j))

    cfg = AchelousConfig(resolution=RES, **kw)
    tcfg = tts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty")
    entries = jax_entries(jcfg.backbone, jcfg.phi, jcfg.neck, jcfg.pc_model)
    port_step = tts.make_train_step(cfg, tcfg)

    def port_state(jstate):
        state = tts.create_train_state(create_model(cfg, "cpu", train=True),
                                       cfg, tcfg)
        load_train_state_from_jax(state, jstate, entries)
        return state

    batch = synthetic_batch(cfg, STEP_BATCH, MAX_GT, seed=5, device="cpu")
    batch["pc"] = batch["pc"] * torch.from_numpy(PC_SCALES)[:, None, None]

    def port_run(change, jstate=s0):
        state = port_state(jstate)
        return port_step(state, {k: change(k, v) for k, v in batch.items()},
                         LR)

    def same(k, v):
        return v

    cases = [(s0, same)] + [(s0, change) for change in PERTURB] + [
        (jax_state(nudge_offsets(variables, d), tcfg_j), same)
        for d in (OFFSET_NUDGE, -OFFSET_NUDGE)]
    served_cases = len(cases)
    if name in NORM_NUDGED:
        cases += [(jax_state(nudge_norms(variables, d), tcfg_j), same)
                  for d in (NORM_NUDGE, -NORM_NUDGE)]
    runs, ends = [], []
    for jstate, change in cases:
        s1, m1 = step(jstate, {k: jnp.asarray(change(k, v))
                               for k, v in arrays.items()}, jnp.float32(LR))
        state, metrics = port_run(change, jstate)
        # the deploy outputs' spread: the cases from the same variables,
        # and the offsets nudged (a norm's bias moved shifts eval outputs
        # by itself, ~2x a block on MobileOne)
        if name in DEPLOY and len(ends) < served_cases:
            ends.append((state, s1))
        before = numpy_state(port_state(jstate))
        runs.append(({k: v - before[k] for k, v in
                      numpy_state(state).items()},
                     {k: v - before[k] for k, v in
                      numpy_state(port_state(s1)).items()},
                     metrics, m1, before))
    (got, want, metrics, m1, before), others = runs[0], runs[1:]
    spread = {k: max(max(np.abs(o[0][k] - got[k]).max(),
                         np.abs(o[1][k] - want[k]).max()) for o in others)
              for k in got}
    metric_spread = {k: max(max(abs(float(o[2][k]) - float(metrics[k])),
                                abs(float(o[3][k]) - float(m1[k])))
                            for o in others) for k in METRICS}
    return dict(name=name, before=before, metric_spread=metric_spread,
                got={k: before[k] + v for k, v in got.items()},
                want={k: before[k] + v for k, v in want.items()},
                spread=spread, metrics=metrics, port_run=port_run,
                want_metrics={k: float(v) for k, v in m1.items()},
                deploy=served(jcfg, cfg, arrays, batch, s0, ends, port_state)
                if ends else None)


def served(jcfg, cfg, arrays, batch, s0, ends, port_state):
    """The deploy forms of the EMAs after the steps of `ends` ((the port's
    state, JAX's state) of each case, the unperturbed first), in eval mode
    on the batch's first DEPLOY_ROWS samples, each output in the port's
    layout: the port's fold of its own EMA ("got"), JAX's of its own
    ("want"), the port's fold of JAX's EMA carried across ("carried"),
    the port's train form on its own EMA ("train_form"), JAX's deploy
    outputs before the step ("before"), and each output's spread: the most
    any perturbed case moves it on either side."""
    japply = jax.jit(jax_create_model(jcfg, deploy=True).apply)
    keys = ("image", "radar", "pc")

    def jax_side(jstate):
        det, sem, lane, pc = japply(
            jax_reparameterize({"params": jstate.ema_params,
                                "batch_stats": jstate.ema_batch_stats}),
            *(arrays[k][:DEPLOY_ROWS] for k in keys))
        return [nchw(d) for d in det] + [nchw(sem), nchw(lane),
                                         np.asarray(pc)]

    def port_side(state, deploy=True):
        model = create_model(cfg, "cpu", deploy=deploy, state_dict={
            **state.ema_params, **state.ema_batch_stats})
        with torch.inference_mode():
            det, sem, lane, pc = model(*(batch[k][:DEPLOY_ROWS]
                                         for k in keys))
        return [t.numpy() for t in (*det, sem, lane, pc)]

    sides = [(port_side(state), jax_side(s1)) for state, s1 in ends]
    (got, want), others = sides[0], sides[1:]
    return dict(got=got, want=want, before=jax_side(s0),
                carried=port_side(port_state(ends[0][1])),
                train_form=port_side(ends[0][0], deploy=False),
                spread=[max(max(np.abs(g[i] - got[i]).max(),
                                np.abs(w[i] - want[i]).max())
                            for g, w in others) for i in range(len(got))])


def relative(got, want):
    """max |got - want| / max(1, max |want|)."""
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_train_step_metrics_match_jax(step_run):
    """Every loss and grad_norm, rtol 1e-3; for the reparameterizable
    configurations plus SPREAD_FLOOR times the most the perturbed steps
    move it on either side (MobileOne-S0's float32 train-mode forward is
    ill-conditioned: its grad_norm moves by ~1 % between the two
    packages' summation orders)."""
    r = step_run
    assert r["metrics"]["skipped_nonfinite"] == 0.0
    assert r["want_metrics"]["skipped_nonfinite"] == 0.0
    for k in METRICS:
        spread = r["metric_spread"][k] if r["name"] in DEPLOY else 0.0
        close(r["metrics"][k], r["want_metrics"][k], 1e-3,
              SPREAD_FLOOR * spread, k)


def test_train_step_state_matches_jax(step_run):
    """Each tensor's change over the step within its bound of JAX's plus
    `SPREAD_FLOOR` times its float32 spread; log_vars within rtol 1e-3."""
    r = step_run
    assert set(r["got"]) == set(r["want"])
    bad = gate_failures(r, r["got"])
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    close(r["got"]["log_vars"] - r["before"]["log_vars"],
          r["want"]["log_vars"] - r["before"]["log_vars"], 1e-3, 1e-7)


def test_state_gate_fails_the_family_fault(step_run):
    """The port's step taken again with each of its families' faults
    planted moves tensors past the gate."""
    for fault in FAULTS[step_run["name"]]:
        with pytest.MonkeyPatch.context() as monkeypatch:
            plant(fault, monkeypatch)
            state, _ = step_run["port_run"](lambda k, v: v)
        assert gate_failures(step_run, numpy_state(state)), fault


def test_fold_of_the_trained_ema_matches_jax(deploy_run):
    """JAX's EMA after its step, carried across and folded by the port's
    `reparameterize`, serves what JAX's `reparameterize` of it serves:
    each output within FOLD_REL of its scale."""
    r = deploy_run
    for name, g, w in zip(OUTPUTS, r["carried"], r["want"]):
        assert g.shape == w.shape
        assert relative(g, w) <= FOLD_REL, (name, relative(g, w))


def test_folded_ema_serves_what_jax_serves_after_the_step(deploy_run):
    """The port's fold of its own EMA after its step against JAX's fold of
    JAX's: each output within STEP_MOVE of the most the step moved JAX's,
    FOLD_REL of its scale and SPREAD_FLOOR times its spread."""
    r = deploy_run
    for i, (name, g, w) in enumerate(zip(OUTPUTS, r["got"], r["want"])):
        bound = (STEP_MOVE * np.abs(w - r["before"][i]).max()
                 + FOLD_REL * max(1.0, np.abs(w).max())
                 + SPREAD_FLOOR * r["spread"][i])
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


def test_folded_ema_matches_the_train_form(deploy_run):
    """On the port alone, the deploy form of its EMA after the step (whose
    BatchNorm statistics the step moved) against the train form's eval
    output on the same EMA: within DEPLOY_TOL of each output's scale."""
    r = deploy_run
    for name, d, t in zip(OUTPUTS, r["got"], r["train_form"]):
        assert relative(d, t) <= DEPLOY_TOL, (name, relative(d, t))


@pytest.mark.parametrize("check", ["forward", "gradients", "statistics"])
def test_mobileone_backbone_trains_as_flax(check):
    """MobileOne-S0's backbone in train mode against the flax module
    (test_torch_port_train_modules.py's harness; its JAX compile alone
    takes ~2 min): each gate widened by the spread it reads, as MobileOne
    sums six branches a block and its float32 forward at 64x64 moves by
    ~1e-3 of its scale against its own float64 one."""
    getattr(train_modules, f"check_{check}")("MO-S0 backbone")
