"""The port's predictor, its CLI, rendering and export against the JAX
package's, on the CPU.

EN-GDF-PN-S0 at 64x64 with 16 points, float32, as tests/test_predictor.py
sizes it: one set of numpy-seeded flax variables serves the JAX
`AchelousPredictor` and, through `weights.state_dict_from_jax` and the
port's weight file (`save_weights` / `load_weights`), the port's.  Held:

  - the request function's outputs: valid detections equal in count and
    class, boxes within 1e-4, probabilities and point-cloud logits within
    rtol 2e-3 / atol 1e-3 (the slice tolerance, test_torch_port_slice.py);
  - the prepared inputs (letterbox, radar CSV splat, npz, min-max, point
    cloud) equal element for element;
  - `detect` on a 96x128 frame: boxes within 1e-3 px, masks equal wherever
    a pixel's top two probabilities are 1e-3 apart, drivable in {0, 8};
    `detect_heatmap` within 1e-5;
  - the provenance stamp (`from_weights`), `deploy` as a no-op, `--ckpt`
    serving a checkpoint's EMA, `render_detection` pixel for pixel,
    `pc_projection`;
  - the CLI's predict, dir_predict, heatmap, export, fps and video modes;
  - the export round trip: the loaded program within 1e-5 of eager, and
    the exported NMS (a `while_loop`) picking what the eager early-exit
    loop picks, on a suppression chain longer than 2.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from achelous_tpu import visualize as jax_visualize
from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.predict import AchelousPredictor as JaxPredictor
from achelous_tpu.utils import pc_projection as jax_pc
from achelous_tpu.utils.torch_import import achelous_mapping

from achelous_tpu_torch import predict, predict_cli, visualize
from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.example import write_radar_csv
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops.postprocess import non_max_suppression
from achelous_tpu_torch.utils import pc_projection
from achelous_tpu_torch.weights import (load_weights, save_weights,
                                        state_dict_from_jax)
from test_torch_port_slice import nchw, random_variables

RES, POINTS = 64, 16
CONF, NMS = 0.01, 0.5
TOL = dict(rtol=2e-3, atol=1e-3)
FRAME_HW = (96, 128)


def port_config(**kw):
    return AchelousConfig(resolution=RES, pc_points=POINTS,
                          dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A frame, a radar CSV and an npz map on disk, and the weight file."""
    d = tmp_path_factory.mktemp("predict")
    rng = np.random.RandomState(0)
    img = str(d / "frame.png")
    Image.fromarray(rng.randint(0, 255, FRAME_HW + (3,), np.uint8)).save(img)
    csv = write_radar_csv(str(d / "frame.csv"), 24, rng)
    npz = str(d / "frame.npz")
    np.savez(npz, arr_0=rng.rand(3, RES, RES).astype(np.float32) * 5)
    return dict(dir=d, image=img, csv=csv, npz=npz)


@pytest.fixture(scope="module")
def pair(files):
    """(JAX predictor, port predictor) on one set of weights."""
    jcfg = JaxConfig(resolution=RES, pc_points=POINTS, dtype=jnp.float32)
    jmodel = jax_create_model(jcfg)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, RES, RES, 3)), jnp.zeros((1, 3, RES, RES)),
        jnp.zeros((1, POINTS, 5)))
    variables = random_variables(shapes, seed=1)
    jpred = JaxPredictor(jcfg, variables, confidence=CONF, nms_iou=NMS)
    like = create_model(port_config(), "cpu").state_dict()
    sd = state_dict_from_jax(variables, achelous_mapping("S0", "en", "gdf"),
                             like)
    path = save_weights(str(files["dir"] / "weights.pt"), sd)
    port = predict.AchelousPredictor.from_weights(
        port_config(), path, confidence=CONF, nms_iou=NMS, device="cpu")
    return jpred, port


@pytest.fixture(scope="module")
def request_outputs(pair):
    jpred, port = pair
    rng = np.random.RandomState(1)
    img = rng.rand(1, RES, RES, 3).astype(np.float32)
    rad = rng.rand(1, 3, RES, RES).astype(np.float32)
    pc = rng.rand(1, POINTS, 5).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray,
                                  jpred._infer(jpred.variables, img, rad, pc))
    got = port.infer(*(torch.from_numpy(a) for a in (nchw(img), rad, pc)))
    return want, got


def test_request_detections_match_jax(request_outputs):
    (jdets, *_), (dets, *_) = request_outputs
    valid = jdets.valid[0]
    assert valid.sum() > 2
    np.testing.assert_array_equal(dets.valid[0].numpy(), valid)
    np.testing.assert_array_equal(dets.cls_idx[0].numpy()[valid],
                                  jdets.cls_idx[0][valid])
    np.testing.assert_allclose(dets.boxes[0].numpy()[valid],
                               jdets.boxes[0][valid], rtol=0, atol=1e-4)


@pytest.mark.parametrize("i,name", [(1, "sem"), (2, "lane"), (3, "pc")])
def test_request_outputs_match_jax(request_outputs, i, name):
    want, got = request_outputs
    w = want[i] if name == "pc" else nchw(want[i])
    np.testing.assert_allclose(got[i].numpy(), w, **TOL)


def test_prepared_inputs_match_jax(pair, files):
    """Letterbox, point cloud, and the radar map from the CSV (splat), the
    npz and each with min-max: equal element for element."""
    jpred, port = pair
    pil = Image.open(files["image"])
    np.testing.assert_array_equal(port.prepare_image(pil).numpy(),
                                  nchw(jpred.prepare_image(pil)))
    np.testing.assert_array_equal(
        port.prepare_pointcloud(files["csv"]).numpy(),
        np.asarray(jpred.prepare_pointcloud(files["csv"])))
    for kw in (dict(csv_path=files["csv"]), dict(npz_path=files["npz"]), {}):
        for minmax in (False, True):
            port.minmax_radar = jpred.minmax_radar = minmax
            try:
                got = port.prepare_radar(**kw).numpy()
                want = np.asarray(jpred.prepare_radar(**kw))
            finally:
                port.minmax_radar = jpred.minmax_radar = False
            assert got.shape == (1, 3, RES, RES)
            np.testing.assert_array_equal(got, want, err_msg=f"{kw} {minmax}")
    splat = port.prepare_radar(csv_path=files["csv"])
    assert int((splat != 0).sum()) > 20            # the points landed


def _top2_gap(prob):
    top = np.sort(prob, axis=-1)
    return top[..., -1] - top[..., -2]


def test_detect_matches_jax(pair, files):
    jpred, port = pair
    pil = Image.open(files["image"])
    kw = dict(radar_csv=files["csv"])
    want, got = jpred.detect(pil, **kw), port.detect(pil, **kw)
    assert len(want["boxes"]) > 2 and len(got["boxes"]) == len(want["boxes"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    np.testing.assert_array_equal(got["pc_pred"], want["pc_pred"])
    # where the two top probabilities are 1e-3 apart the argmax is stable
    # under the port's rounding; compare there
    _, jsem, jlane, _, _ = jpred._infer(jpred.variables,
                                        *(jpred.prepare_image(pil),
                                          jpred.prepare_radar(None,
                                                              files["csv"]),
                                          jpred.prepare_pointcloud(
                                              files["csv"])))
    for key, prob in (("semantic", jsem), ("waterline", jlane)):
        probs = jpred._unletterbox_mask(np.asarray(prob[0]), FRAME_HW)
        sure = _top2_gap(probs) > 1e-3
        assert sure.mean() > 0.5
        assert got[key].shape == FRAME_HW
        np.testing.assert_array_equal(got[key][sure], want[key][sure])
    assert set(np.unique(got["drivable"])) <= {0, 8}
    np.testing.assert_array_equal(got["drivable"] == 8,
                                  got["semantic"] == 8)


def test_unletterboxed_probabilities_match_jax(pair):
    """The crop and bilinear resize back to the frame, on one map."""
    jpred, port = pair
    prob = np.random.RandomState(2).rand(9, RES, RES).astype(np.float32)
    want = jpred._unletterbox_mask(prob.transpose(1, 2, 0), FRAME_HW)
    got = port._unletterbox_mask(torch.from_numpy(prob), FRAME_HW)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_detect_heatmap_matches_jax(pair, files):
    jpred, port = pair
    pil = Image.open(files["image"])
    want = jpred.detect_heatmap(pil, radar_npz=files["npz"])
    got = port.detect_heatmap(pil, radar_npz=files["npz"])
    assert got.shape == (RES, RES) and want.max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_detection_matches_jax_pixel_for_pixel(pair, files):
    jpred, _ = pair
    pil = Image.open(files["image"])
    result = jpred.detect(pil)
    assert len(result["boxes"])
    want = jax_visualize.render_detection(pil, result, jpred.class_names)
    got = visualize.render_detection(pil, result, jpred.class_names)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pc_projection_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "calib")
    t = np.eye(4) + rng.randn(4, 4) * 0.01
    t[3] = (0, 0, 0, 1)
    proj = np.array([[900, 0, 960, 0], [0, 900, 540, 0], [0, 0, 1, 0]],
                    np.float64)
    with open(tmp_path / "calib" / "f0.txt", "w") as f:
        f.write("T: " + " ".join(repr(float(x)) for x in t.reshape(-1))
                + "\n")
        f.write("P: " + " ".join(repr(float(x)) for x in proj.reshape(-1))
                + "\n")
    for fn in ("get_t_camera_radar", "get_camera_projection_matrix"):
        np.testing.assert_array_equal(getattr(pc_projection, fn)(
            str(tmp_path), "f0"), getattr(jax_pc, fn)(str(tmp_path), "f0"))
    xyz = (rng.rand(20, 3) * [10, 4, 30] + [0, 0, 5]).astype(np.float32)
    args = (xyz, jax_pc.get_t_camera_radar(str(tmp_path), "f0"),
            jax_pc.get_camera_projection_matrix(str(tmp_path), "f0"))
    np.testing.assert_array_equal(pc_projection.project_pcl_to_image(*args),
                                  jax_pc.project_pcl_to_image(*args))
    with pytest.raises(ValueError):
        pc_projection.project_3d_to_2d(xyz, args[2])


def test_from_weights_honours_the_provenance_stamp(pair, files, tmp_path):
    _, port = pair
    sd, meta = load_weights(str(files["dir"] / "weights.pt"))
    assert meta == {}
    assert port.cfg.deform_band == 4
    stamped = save_weights(str(tmp_path / "t.pt"), sd,
                           {"provenance": predict.TRANSPLANT})
    assert load_weights(stamped)[1] == {"provenance": predict.TRANSPLANT}
    exact = predict.AchelousPredictor.from_weights(port_config(), stamped,
                                                   device="cpu")
    assert exact.cfg.deform_band is None
    assert not any(getattr(m, "fused", False)
                   for m in exact.model.modules())    # K2 on every block
    kept = predict.AchelousPredictor.from_weights(port_config(), stamped,
                                                  force_band=True,
                                                  device="cpu")
    assert kept.cfg.deform_band == 4
    with pytest.raises(ValueError, match="not a weight file"):
        torch.save({"x": torch.zeros(1)}, str(tmp_path / "bad.pt"))
        load_weights(str(tmp_path / "bad.pt"))


def test_deploy_changes_nothing(pair, files):
    _, port = pair
    sd, _ = load_weights(str(files["dir"] / "weights.pt"))
    folded = predict.AchelousPredictor(port_config(), sd, confidence=CONF,
                                       nms_iou=NMS, deploy=True, device="cpu")
    args = port.prepare(Image.open(files["image"]), None, files["csv"])
    for g, w in zip(torch.utils._pytree.tree_leaves(folded.infer(*args)),
                    torch.utils._pytree.tree_leaves(port.infer(*args))):
        assert torch.equal(g, w)


def test_predictor_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.AchelousPredictor(port_config())
    args = predict_cli.build_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.load_predictor(args)


def cli(*argv):
    return predict_cli.main(["--device", "cpu", "--resolution", str(RES),
                             "--confidence", str(CONF), *argv])


def test_cli_serves_a_checkpoints_ema(tmp_path):
    """--ckpt: the checkpoint's EMA parameters and statistics, not the
    model's, in the CLI's bf16."""
    from achelous_tpu_torch.train.checkpoints import CheckpointManager
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state)
    cfg = AchelousConfig(resolution=RES, dtype=torch.bfloat16)
    state = create_train_state(create_model(cfg, "cpu", train=True), cfg,
                               TrainConfig())
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for t in list(state.ema_params.values()) + list(
                state.ema_batch_stats.values()):
            t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32)
                                     + 0.5))
    CheckpointManager(str(tmp_path)).save("best_epoch_weights", state)
    pred = predict_cli.load_predictor(predict_cli.build_parser().parse_args(
        ["--device", "cpu", "--resolution", str(RES), "--ckpt",
         str(tmp_path / "best_epoch_weights")]))
    served = pred.model.state_dict()
    ema = {**state.ema_params, **state.ema_batch_stats}
    assert set(served) == set(ema)
    for k, v in ema.items():
        assert torch.equal(served[k], v.to(served[k].dtype)), k
        assert not torch.equal(v, state.model.state_dict()[k]), k


def test_cli_predict_and_dir_predict(files, tmp_path):
    out = str(tmp_path / "out")
    summary = cli("--image", files["image"], "--radar_csv",
                  files["csv"], "--out", out)
    assert summary["num_detections"] == len(summary["detections"]) > 0
    assert json.load(open(os.path.join(out, "frame.json")))["image"] == \
        files["image"]
    assert np.load(os.path.join(out, "frame_masks.npz"))[
        "semantic"].shape == FRAME_HW
    assert os.path.exists(os.path.join(out, "frame_vis.jpg"))
    d = tmp_path / "frames"
    d.mkdir()
    for name in ("a.png", "b.jpg", "skip.txt"):
        Image.open(files["image"]).convert("RGB").save(d / name) \
            if name != "skip.txt" else (d / name).write_text("x")
    summaries = cli("--mode", "dir_predict", "--image_dir", str(d),
                    "--out", str(tmp_path / "dir"))
    assert [os.path.basename(s["image"]) for s in summaries] == ["a.png",
                                                                  "b.jpg"]
    assert sorted(os.listdir(tmp_path / "dir")) == [
        "a.json", "a_masks.npz", "a_vis.jpg", "b.json", "b_masks.npz",
        "b_vis.jpg"]


def test_cli_heatmap_and_fps(files, tmp_path):
    res = cli("--mode", "heatmap", "--image", files["image"],
              "--radar_npz", files["npz"], "--out", str(tmp_path))
    hm = np.load(res["heatmap"])
    assert hm.shape == (RES, RES) and 0.0 <= hm.min() <= hm.max() <= 1.0
    res = cli("--mode", "fps", "--image", files["image"],
              "--test_interval", "2")
    assert res["test_interval"] == 2
    assert res["fps"] > 0 and res["seconds_per_image"] > 0


def test_cli_video_mode(files, tmp_path):
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                        FRAME_HW[::-1])
    rng = np.random.RandomState(0)
    for _ in range(3):
        w.write(rng.randint(0, 255, FRAME_HW + (3,), np.uint8))
    w.release()
    out = str(tmp_path / "out.mp4")
    res = cli("--mode", "video", "--video", src, "--video_out", out,
              "--max_frames", "2")
    assert res["frames"] == 2 and res["mean_fps"] > 0
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 2


def test_export_round_trip(files, tmp_path):
    """The CLI's export mode (bf16, seed-0 weights), reloaded: the same
    outputs as the eager predictor the CLI builds, within 1e-5, and the
    same detections (one export: it takes ~25 s on the CPU)."""
    argv = ["--mode", "export", "--out", str(tmp_path)]
    res = cli(*argv)
    assert res["bytes"] > 1e5 and os.path.exists(res["exported"])
    assert predict.kernel_nodes(res["exported"]) == {}   # plain on the CPU
    port = predict_cli.load_predictor(predict_cli.build_parser().parse_args(
        ["--device", "cpu", "--resolution", str(RES), "--confidence",
         str(CONF), *argv]))
    args = port.prepare(Image.open(files["image"]), files["npz"],
                        files["csv"])
    want = port.infer(*args)
    with torch.no_grad():
        got = predict.unpack(predict.load_program(res["exported"])(*args))
    assert want[0].valid.sum() > 2
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        if w.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=1e-5)


class _NMS(torch.nn.Module):
    def forward(self, decoded):
        return tuple(non_max_suppression(decoded, 3, 0.1, 0.4))


def chain_boxes():
    """Decoded predictions [2, 8, 5+3]: image 0 a chain of 6 same-class
    boxes, each overlapping the next (IoU 0.6 > 0.4) and not the one after
    (IoU 1/3), in
    falling score order, so greedy NMS keeps every other one and its
    fixpoint takes 6 rounds; image 1 two classes of unrelated boxes."""
    d = np.zeros((2, 8, 8), np.float32)
    for i in range(6):
        d[0, i, :4] = (0.1 + 0.025 * i, 0.5, 0.1, 0.1)
        d[0, i, 4], d[0, i, 5] = 1.0, 0.9 - 0.05 * i
    d[0, 6, :6] = (0.8, 0.8, 0.05, 0.05, 1.0, 0.5)
    rng = np.random.RandomState(5)
    d[1, :, :4] = rng.rand(8, 4) * [1, 1, 0.3, 0.3]
    d[1, :, 4] = rng.rand(8)
    d[1, :, 5:] = rng.rand(8, 3)
    return torch.from_numpy(d)


def test_exported_nms_matches_the_eager_early_exit():
    d = chain_boxes()
    want = non_max_suppression(d, 3, 0.1, 0.4)
    assert want.valid[0].tolist()[:4] == [True, True, True, True]
    assert int(want.valid[0].sum()) == 4          # 0, 2, 4 and the loner
    program = torch.export.export(_NMS(), (d,), strict=False)
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    got = program.module()(d)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
