"""One whole training step of each of the port's newly held configurations
against JAX's `make_train_step`, on the CPU (slow: a JAX step compile and
six steps on each side take 57-308 s a configuration on an 8-core CPU).

The nine configurations of test_torch_port_train_configs.py, at 64x64,
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

One planted fault a family, taken in each of its configurations, must
fail that gate: EN (no weight decay),
MobileViT (the transformer's layers run in reverse order), the CSP neck
(the bottlenecks' shortcut dropped), EdgeViT (stages 1-3 read after their
blocks, not after the patch embeddings), PoolFormer (pooling counts the
padding) and EfficientFormerV2-L (K3's output cut from the graph).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.data.synthetic import synthetic_batch as jax_synthetic
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.train import train_state as jts

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.models import edgevit, efficientformer, mobilevit
from achelous_tpu_torch.models import poolformer
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops import blocks
from achelous_tpu_torch.train import train_state as tts
from achelous_tpu_torch.weights import load_train_state_from_jax
from test_torch_port_configs import jax_entries
from test_torch_port_slice import random_variables
from test_torch_port_train import (LR, MAX_GT, PC_SCALES, RES, STEP_BATCH,
                                   close, jax_state, numpy_state)
from test_torch_port_train_configs import CONFIGS
from test_torch_port_train_ef_pn2 import SPREAD_FLOOR, gate_failures

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
# configuration -> the fault planted in its family
FAULTS = {"EN-GDF-PN-S1": "no_weight_decay",
          "EN-GDF-PN-S2": "no_weight_decay",
          "EN-GDF-PN-S0-SPPF": "no_weight_decay",
          "EN-GDF-PN-S0-HEAD256": "no_weight_decay",
          "MV-GDF-PN-S1": "transformer_layers_reversed",
          "EN-CDF-PN2-S2": "csp_shortcut_dropped",
          "EV-GDF-PN-S0": "stage_features_after_blocks",
          "PF-GDF-PN-S0": "pool_counts_padding",
          "EF-GDF-PN-L": "k3_graph_cut"}


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
    else:
        attention = efficientformer.fused_bias_attention

        def graphless(*args):
            with torch.no_grad():
                return attention(*args)
        monkeypatch.setattr(efficientformer, "fused_bias_attention",
                            graphless)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def step_run(request):
    return run_config(request.param)


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
    runs = []
    for jstate, change in cases:
        s1, m1 = step(jstate, {k: jnp.asarray(change(k, v))
                               for k, v in arrays.items()}, jnp.float32(LR))
        state, metrics = port_run(change, jstate)
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
    return dict(name=name, before=before,
                got={k: before[k] + v for k, v in got.items()},
                want={k: before[k] + v for k, v in want.items()},
                spread=spread, metrics=metrics, port_run=port_run,
                want_metrics={k: float(v) for k, v in m1.items()})


def test_train_step_metrics_match_jax(step_run):
    """Every loss and grad_norm, rtol 1e-3."""
    r = step_run
    assert r["metrics"]["skipped_nonfinite"] == 0.0
    assert r["want_metrics"]["skipped_nonfinite"] == 0.0
    for k in ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
              "grad_norm"):
        close(r["metrics"][k], r["want_metrics"][k], 1e-3, 0, k)


def test_train_step_state_matches_jax(step_run):
    """Each tensor's change over the step within its bound of JAX's plus
    `SPREAD_FLOOR` times its float32 spread; log_vars within rtol 1e-3."""
    r = step_run
    assert set(r["got"]) == set(r["want"])
    bad = gate_failures(r, r["got"])
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    close(r["got"]["log_vars"] - r["before"]["log_vars"],
          r["want"]["log_vars"] - r["before"]["log_vars"], 1e-3, 1e-7)


def test_state_gate_fails_the_family_fault(step_run, monkeypatch):
    """The port's step taken again with its family's fault planted moves
    tensors past the gate."""
    plant(FAULTS[step_run["name"]], monkeypatch)
    state, _ = step_run["port_run"](lambda k, v: v)
    assert gate_failures(step_run, numpy_state(state))
