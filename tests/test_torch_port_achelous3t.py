"""The 3-task Achelous3T and the predictor's `sharded_infer`, on the CPU.

  * Achelous3T (`create_model(..., with_pc=False)`, the reference's
    nets/Achelous.py:56-76) against JAX's `create_model(cfg,
    with_pc=False).apply` at 64x64, batch 2, float32, on one set of
    numpy-seeded flax variables carried across by
    `weights.state_dict_from_jax` through `achelous_mapping(...,
    with_pc=False)`: every output within test_torch_port_configs.py's
    rtol 2e-3 / atol 1e-3.  Its state dict has exactly the mapping's keys
    (no `pc_seg_model`), `entry(..., with_pc=False)` serves it on (image,
    radar), and it refuses to train (JAX's losses take four outputs).
  * `AchelousPredictor.sharded_infer` of EN-GDF-PN-S0 over two CPU
    "devices" at batch 8 against the single request on the whole batch:
    discrete outputs (the NMS survivors, their classes) equal, every float
    within 1e-5; a batch the devices do not divide raises.  And against
    JAX's `sharded_infer` over its 8-device CPU mesh (tests/conftest.py) on
    the same weights and inputs, as tests/test_host_sharding.py holds
    JAX's against its single-device program: the survivors and their
    classes equal, boxes within 1e-4, the other outputs within
    test_torch_port_configs.py's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.parallel.mesh import make_mesh
from achelous_tpu.predict import AchelousPredictor as JaxPredictor
from achelous_tpu.utils.torch_import import achelous_mapping

from achelous_tpu_torch.entry import entry, serving_config
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops.postprocess import Detections
from achelous_tpu_torch.predict import AchelousPredictor
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_slice import BATCH, RES, nchw, random_variables

TOL = dict(rtol=2e-3, atol=1e-3)
SHARDED_BATCH = 8
CONF, NMS = 0.05, 0.5


# ---------------------------------------------------------------------------
# Achelous3T
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def three_task():
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", resolution=RES,
                     dtype=jnp.float32)
    jmodel = jax_create_model(jcfg, with_pc=False)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, rad), seed=1)
    want = jax.jit(jmodel.apply)(variables, img, rad)

    cfg = serving_config(torch.float32, RES)
    model = create_model(cfg, "cpu", with_pc=False)
    sd = state_dict_from_jax(variables, achelous_mapping("S0", "en", "gdf",
                                                         with_pc=False),
                             model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        got = model(torch.from_numpy(nchw(img)), torch.from_numpy(rad))
    return model, sd, got, want


@pytest.mark.parametrize("i,name", [(0, "det0"), (1, "det1"), (2, "det2"),
                                    (3, "sem"), (4, "lane")])
def test_achelous3t_outputs_match_jax(three_task, i, name):
    _, _, (gdet, gsem, glane), (jdet, jsem, jlane) = three_task
    got = [*gdet, gsem, glane][i].numpy()
    want = nchw(np.asarray([*jdet, jsem, jlane][i]))
    assert got.shape == want.shape
    if name.startswith("det"):
        assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


def test_achelous3t_has_no_point_cloud_branch_and_serves(three_task):
    model, sd, _, _ = three_task
    assert set(model.state_dict()) == set(sd)
    assert not any(k.startswith("pc_seg_model") for k in sd)
    full = create_model(serving_config(torch.float32, RES), "cpu")
    pc_keys = {k for k in full.state_dict() if k.startswith("pc_seg_model.")}
    assert pc_keys and set(full.state_dict()) - pc_keys == set(sd)
    fn, args = entry("cpu", with_pc=False)
    assert len(args) == 2
    dets, sem, lane = fn(*args)
    assert isinstance(dets, Detections)
    assert sem.shape[1:] == (9, 320, 320) and lane.shape[1:] == (2, 320, 320)
    with pytest.raises(ValueError, match="serves only"):
        create_model(serving_config(torch.float32, RES), "cpu", train=True,
                     with_pc=False)


# ---------------------------------------------------------------------------
# sharded_infer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded():
    """JAX's sharded_infer on its 8-device mesh and the port's on two CPU
    devices and unsharded, on one set of weights and inputs."""
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", pc_model="pn",
                     resolution=RES, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    b = SHARDED_BATCH
    img = rng.rand(b, RES, RES, 3).astype(np.float32)
    rad = rng.rand(b, 3, RES, RES).astype(np.float32)
    pc = rng.rand(b, jcfg.pc_points, jcfg.pc_channels).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        jax_create_model(jcfg).init, jax.random.PRNGKey(0), img[:1],
        rad[:1], pc[:1]), seed=1)
    jpred = JaxPredictor(jcfg, variables, confidence=CONF, nms_iou=NMS)
    mesh = make_mesh()
    assert mesh.size == 8
    want = jax.tree_util.tree_map(
        np.asarray, jpred.sharded_infer(mesh)(variables, img, rad, pc))

    cfg = serving_config(torch.float32, RES)
    like = create_model(cfg, "cpu").state_dict()
    sd = state_dict_from_jax(variables, achelous_mapping("S0", "en", "gdf"),
                             like)
    pred = AchelousPredictor(cfg, sd, confidence=CONF, nms_iou=NMS,
                             device="cpu")
    args = tuple(torch.from_numpy(a) for a in (nchw(img), rad, pc))
    return dict(want=want, pred=pred, args=args,
                got=pred.sharded_infer(["cpu", "cpu"])(*args),
                single=pred.infer(*args))


def flat(outputs):
    dets, sem, lane, pc, det = outputs
    return [*dets, sem, lane, pc, *det]


def test_sharded_infer_equals_the_single_request(sharded):
    got, single = flat(sharded["got"]), flat(sharded["single"])
    assert len(got) == len(single)
    for g, w in zip(got, single):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.bool or not g.is_floating_point():
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)
    assert sharded["got"][0].valid.sum() > 8
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        sharded["pred"].sharded_infer(["cpu"] * 3)(*sharded["args"])


def test_sharded_infer_matches_jax_sharded_infer(sharded):
    jdets, jsem, jlane, jpc, jdet = sharded["want"]
    dets, sem, lane, pc, det = sharded["got"]
    valid = jdets.valid
    assert valid.sum() > 8
    np.testing.assert_array_equal(dets.valid.numpy(), valid)
    np.testing.assert_array_equal(dets.cls_idx.numpy()[valid],
                                  jdets.cls_idx[valid])
    np.testing.assert_allclose(dets.boxes.numpy()[valid],
                               jdets.boxes[valid], rtol=0, atol=1e-4)
    for g, w in ((sem, jsem), (lane, jlane), *zip(det, jdet)):
        np.testing.assert_allclose(g.numpy(), nchw(w), **TOL)
    np.testing.assert_allclose(pc.numpy(), jpc, **TOL)
