"""A trained checkpoint of each reparameterizable configuration served in
its deploy form through `predict_cli --ckpt --deploy`, on the CPU, in
float32.

For RV-GDF-PN-S0, MO-RDF-PN-S0 and FV-RDF-PN-S0 at 64x64: the trainer's
CLI (`train.cli.main`) trains one epoch (one step at batch 2) on a tiny
WaterScenes tree (`data/example.write_tree`) and writes its checkpoint;
then the predictor CLI's `load_predictor` reads the checkpoint's EMA
(parameters and the BatchNorm statistics the step moved) with and
without `--deploy`, in float32.  On one of the tree's frames, prepared
by the predictor (letterbox, the radar CSV splatted, the points
resampled):

  * the deploy form holds exactly the deploy model's keys;
  * its request outputs (the three detection maps before decode, the
    semantic and waterline probabilities, the point-cloud logits) against
    the train form's eval outputs on the same EMA, within DEPLOY_TOL of
    each output's scale (PERF.md's deploy gate);
  * the same EMA carried into the JAX package (`transplant` through
    `achelous_mapping`) and served by JAX's `AchelousPredictor(cfg,
    variables, deploy=True)`: the same outputs within SLICE_REL of each
    output's scale;
  * `predict_cli.main` in predict mode with `--ckpt --deploy` (bf16, as
    the CLI serves) writes the frame's summary, masks and rendering.

One step leaves each BatchNorm's running statistics at 0.9 x (0, 1) +
0.1 x the batch's, which in eval mode barely normalise MobileOne-S0's six
summed branches a block: its outputs grow to ~1e9 (as in the JAX
package), so every gate is relative to the output's own scale,
max(1, max |ref|).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.predict import AchelousPredictor as JaxPredictor
from achelous_tpu.utils.torch_import import achelous_mapping, transplant

from achelous_tpu_torch import predict_cli
from achelous_tpu_torch.data.example import write_tree
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.train import cli as train_cli
from test_torch_port_slice import nchw, random_variables

RES, CONF = 64, 0.35
# name -> (backbone, neck)
CONFIGS = {"RV-GDF-PN-S0": ("rv", "gdf"), "MO-RDF-PN-S0": ("mo", "rdf"),
           "FV-RDF-PN-S0": ("fv", "rdf")}
OUTPUTS = ("det0", "det1", "det2", "sem", "lane", "pc")
DEPLOY_TOL = 1e-4
SLICE_REL = 2e-3
FRAME = "frame000"


def relative(got, want):
    """max |got - want| / max(1, max |want|)."""
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("ws")), frames=4,
                      size=(96, 54), points=40)


def request_outputs(outputs):
    """`infer`'s (Detections, sem_prob, lane_prob, pc, det maps) -> the
    OUTPUTS as numpy, in the port's layout."""
    _, sem, lane, pc, det = outputs
    return [np.asarray(t) for t in (*det, sem, lane, pc)]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trained(request, tree, tmp_path_factory):
    """One epoch of the train CLI, then the checkpoint served by the
    predictor CLI's loader with and without --deploy."""
    name = request.param
    backbone, neck = CONFIGS[name]
    log_dir = str(tmp_path_factory.mktemp(name))
    state = train_cli.main(
        ["--data_root", tree, "--backbone", backbone, "--neck", neck,
         "--device", "cpu", "--bf16", "false", "--resolution", str(RES),
         "--pc_num", "64", "--bs", "2", "--epoch", "1", "--eval_period",
         "5", "--save_period", "5", "--log_dir", log_dir])
    assert state.step == 1
    argv = ["--backbone", backbone, "--neck", neck, "--device", "cpu",
            "--resolution", str(RES), "--confidence",
            str(CONF), "--ckpt",
            os.path.join(log_dir, "ckpt", "last_epoch_weights")]

    def load(*extra):
        return predict_cli.load_predictor(
            predict_cli.build_parser().parse_args(argv + list(extra)),
            torch.float32)

    train_form, deploy = load(), load("--deploy")
    image = os.path.join(tree, "images", FRAME + ".jpg")
    csv = os.path.join(tree, "radar", FRAME + ".csv")
    inputs = deploy.prepare(Image.open(image), radar_csv=csv)
    return dict(name=name, state=state, argv=argv, image=image, csv=csv,
                train_form=train_form, deploy=deploy, inputs=inputs,
                got=request_outputs(deploy.infer(*inputs)),
                train_out=request_outputs(train_form.infer(*inputs)))


def test_deploy_form_serves_the_folded_ema(trained):
    """The served model is the deploy form (its keys exactly those of
    `create_model(..., deploy=True)`), from an EMA whose statistics the
    step moved off their initial (0, 1)."""
    served = trained["deploy"].model
    assert served.deploy
    want = create_model(served.cfg, "cpu", deploy=True).state_dict()
    assert set(served.state_dict()) == set(want)
    stats = trained["state"].ema_batch_stats
    moved = [k for k, v in stats.items() if k.endswith("running_var")
             and not torch.allclose(v, torch.ones_like(v))]
    assert len(moved) > 0.9 * sum(k.endswith("running_var") for k in stats)


def test_deploy_form_matches_the_train_form(trained):
    """--ckpt --deploy against --ckpt on the same EMA: each request output
    within DEPLOY_TOL of its scale."""
    for name, d, t in zip(OUTPUTS, trained["got"], trained["train_out"]):
        assert d.shape == t.shape and np.isfinite(d).all(), name
        assert relative(d, t) <= DEPLOY_TOL, (name, relative(d, t))


def test_deploy_form_matches_jax_predictor(trained):
    """The checkpoint's EMA carried into the JAX package and served by
    JAX's `AchelousPredictor(..., deploy=True)`: each request output
    within SLICE_REL of its scale."""
    backbone, neck = CONFIGS[trained["name"]]
    jcfg = JaxConfig(backbone=backbone, neck=neck, resolution=RES,
                     dtype=jnp.float32)
    image, radar, points = (t.numpy() for t in trained["inputs"])
    shapes = jax.eval_shape(jax_create_model(jcfg).init,
                            jax.random.PRNGKey(0),
                            image.transpose(0, 2, 3, 1), radar, points)
    state = trained["state"]
    variables = transplant(
        random_variables(shapes, seed=0),
        {k: v.numpy() for k, v in {**state.ema_params,
                                   **state.ema_batch_stats}.items()},
        achelous_mapping("S0", backbone, neck))
    jpred = JaxPredictor(jcfg, variables, confidence=CONF, deploy=True)
    _, jsem, jlane, jpc, jdet = jpred._infer(
        jpred.variables, image.transpose(0, 2, 3, 1), radar, points)
    want = [nchw(d) for d in jdet] + [nchw(jsem), nchw(jlane),
                                      np.asarray(jpc)]
    for name, g, w in zip(OUTPUTS, trained["got"], want):
        assert g.shape == w.shape, name
        assert relative(g, w) <= SLICE_REL, (name, relative(g, w))


def test_cli_predicts_with_the_folded_ema(trained, tmp_path):
    """predict_cli.main, predict mode, --ckpt --deploy, bf16: the frame's
    summary, masks and rendering."""
    out = str(tmp_path / "out")
    summary = predict_cli.main(trained["argv"] + [
        "--deploy", "--image", trained["image"], "--radar_csv",
        trained["csv"], "--out", out])
    assert summary["image"] == trained["image"]
    assert summary["num_detections"] == len(summary["detections"])
    for suffix in (".json", "_masks.npz", "_vis.jpg"):
        assert os.path.exists(os.path.join(out, FRAME + suffix)), suffix
