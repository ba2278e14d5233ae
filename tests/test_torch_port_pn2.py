"""The PyTorch port's PointNet++ branch and EN-GDF-PN2-S0 against the JAX
package, on the CPU.

  - FPS (K4's plain version) equals the JAX `farthest_point_sample` and the
    Pallas `pallas_farthest_point_sample` (interpret mode) index for index:
    the contract is exact equality, ties included.
  - ball query indices are equal; FeaturePropagation's 3-NN takes the lower
    index on equal distances, as `jax.lax.top_k` does.
  - PointNet2Seg and the whole EN-GDF-PN2-S0 at 64x64, batch 2, float32,
    on one set of numpy-seeded flax variables carried across by
    `weights.state_dict_from_jax` with `achelous_mapping(...,
    with_pc=False)` + `weights.pointnet2_entries`: all outputs within
    rtol 2e-3 / atol 1e-3 (the slice tolerance of test_torch_port_slice.py),
    and decode + NMS pick the same boxes.  The module alone: 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.models.pointnet2 import \
    FeaturePropagation as JaxFeaturePropagation
from achelous_tpu.ops import pointops as jpo
from achelous_tpu.ops.pallas_pointops import pallas_farthest_point_sample
from achelous_tpu.ops.postprocess import decode_outputs as jax_decode
from achelous_tpu.ops.postprocess import non_max_suppression as jax_nms
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.entry import serving_config
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.models.pointnet2 import (FeaturePropagation,
                                                 PointNet2Seg)
from achelous_tpu_torch.ops import hopper_pointops, pointops
from achelous_tpu_torch.ops.postprocess import (decode_outputs,
                                                non_max_suppression)
from achelous_tpu_torch.weights import pointnet2_entries, state_dict_from_jax
from test_torch_port_modules import _Holder, load
from test_torch_port_slice import (BATCH, CONF, NMS, RES,
                                   _assert_same_detections, nchw,
                                   random_variables)

TOL = dict(rtol=1e-4, atol=1e-4)
SLICE_TOL = dict(rtol=2e-3, atol=1e-3)


def fps_case(name):
    """(xyz [B,N,3] float32, npoint, valid or None) from a numpy seed."""
    rng = np.random.RandomState(7)
    if name == "random_512_128":
        return rng.rand(2, 512, 3).astype(np.float32), 128, None
    if name == "random_100_32":
        return rng.randn(2, 100, 3).astype(np.float32), 32, None
    if name == "valid_mask":
        return (rng.randn(2, 128, 3).astype(np.float32), 32,
                rng.rand(2, 128) > 0.3)
    if name == "resampled_duplicates":
        # the data loader resamples 512 points with replacement; bf16-like
        # coarse coordinates make equal distances common
        base = np.round(rng.rand(60, 3) * 16) / 16
        return base[rng.randint(0, 60, (1, 512))].astype(np.float32), 128, None
    if name == "all_identical":
        return np.ones((1, 32, 3), np.float32), 8, None
    raise KeyError(name)


FPS_CASES = ["random_512_128", "random_100_32", "valid_mask",
             "resampled_duplicates", "all_identical"]


@pytest.mark.parametrize("case", FPS_CASES)
def test_fps_plain_matches_jax_and_pallas(case):
    xyz, npoint, valid = fps_case(case)
    got = pointops.farthest_point_sample(
        torch.from_numpy(xyz), npoint,
        None if valid is None else torch.from_numpy(valid))
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(jpo.farthest_point_sample(jnp.asarray(xyz), npoint,
                                                valid=jvalid, use_pallas=False))
    kernel = np.asarray(pallas_farthest_point_sample(
        jnp.asarray(xyz), npoint, jvalid, interpret=True))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)
    if case == "resampled_duplicates":        # the case really has ties
        d = pointops.square_distance(torch.from_numpy(xyz[:, :1]),
                                     torch.from_numpy(xyz))
        assert len(torch.unique(d)) < 100


def test_fps_wrapper_takes_the_plain_version_on_cpu():
    xyz, npoint, valid = fps_case("valid_mask")
    hopper_pointops.farthest_point_sample.launches = 0
    got = hopper_pointops.farthest_point_sample(
        torch.from_numpy(xyz), npoint, torch.from_numpy(valid))
    want = pointops.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                          torch.from_numpy(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert hopper_pointops.farthest_point_sample.launches == 0
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        hopper_pointops.farthest_point_sample(
            torch.empty(1, 8, 3, device="meta"), 4)


@pytest.mark.parametrize("radius,nsample", [(0.1, 32), (0.2, 32), (0.4, 8),
                                            (0.8, 600)])
def test_ball_query_matches_jax(radius, nsample):
    """First in-radius points by index, padded with the first; a centre far
    from every point gets point 0; nsample past N is cut to N."""
    rng = np.random.RandomState(int(radius * 10))
    xyz = rng.rand(2, 512, 3).astype(np.float32)
    new_xyz = np.concatenate([xyz[:, :40], np.full((2, 1, 3), 9.0,
                                                   np.float32)], axis=1)
    got = pointops.ball_query(radius, nsample, torch.from_numpy(xyz),
                              torch.from_numpy(new_xyz))
    want = np.asarray(jpo.ball_query(radius, nsample, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, -1] == 0).all()


def test_feature_propagation_3nn_ties_take_the_lower_index():
    """Each dense point is at distance exactly 1 from four sparse points:
    the 3-NN must be the three of lowest index, as in JAX."""
    sparse = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0],
                       [0, -1, 0]], np.float32)
    dense = np.array([[0, 0, 0], [0, 0, 0], [2, 1, 0], [0, 0, 0.5]],
                     np.float32)
    xyz1 = np.stack([dense, dense[::-1]])
    xyz2 = np.stack([sparse, sparse[::-1]])
    rng = np.random.RandomState(0)
    f1 = rng.randn(2, 4, 6).astype(np.float32)
    f2 = rng.randn(2, 5, 10).astype(np.float32)
    jmod = JaxFeaturePropagation(mlp=(12, 8))
    variables = random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xyz1, xyz2, f1, f2),
        seed=3)
    want = jmod.apply(variables, xyz1, xyz2, f1, f2)
    entries = ti.Mapping()
    for j in range(2):
        entries.dense([f"mlp_{j}_dense"], f"m.mlp_convs.{j}",
                      tf="conv1d_dense")
        entries.bn([f"mlp_{j}_bn"], f"m.mlp_bns.{j}")
    port = load(_Holder(FeaturePropagation(16, (12, 8))), variables,
                entries).m
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (xyz1, xyz2, f1, f2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def pn2_run():
    """One JAX apply of EN-GDF-PN2-S0 (recording PointNet2Seg's output)
    and the port on the same variables and inputs."""
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", pc_model="pn2",
                     resolution=RES, dtype=jnp.float32)
    jmodel = jax_create_model(jcfg)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    pc = rng.rand(BATCH, jcfg.pc_points, jcfg.pc_channels).astype(np.float32)
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, rad, pc),
        seed=1)

    def run(v, *inputs):
        return jmodel.apply(v, *inputs, mutable=["intermediates"],
                            capture_intermediates=lambda mdl, method:
                            method == "__call__"
                            and mdl.scope.path == ("pc_seg",))

    jout, state = jax.jit(run)(variables, img, rad, pc)
    jdec = jax_decode(jout[0], (RES, RES))
    jdets = jax_nms(jdec, jcfg.num_det, CONF, NMS)

    cfg = serving_config(torch.float32, RES, pc_model="pn2")
    model = create_model(cfg, "cpu")
    entries = ti.achelous_mapping("S0", "en", "gdf", with_pc=False) \
        + pointnet2_entries()
    sd = state_dict_from_jax(variables, entries, model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        pout = model(torch.from_numpy(img.transpose(0, 3, 1, 2)),
                     torch.from_numpy(rad), torch.from_numpy(pc))
    return dict(cfg=cfg, variables=variables, model=model, pc=pc,
                entries=entries, pout=pout,
                jout=jax.tree_util.tree_map(np.asarray, jout),
                jpc=np.asarray(state["intermediates"]["pc_seg"]
                               ["__call__"][0][0]),
                jdec=np.array(jdec),
                jdets=jax.tree_util.tree_map(np.asarray, jdets))


def test_pointnet2seg_matches_jax(pn2_run):
    port = load(PointNet2Seg(8, 5), pn2_run["variables"],
                pointnet2_entries(prefix=""))
    with torch.inference_mode():
        got, none = port(torch.from_numpy(pn2_run["pc"]))
    assert none is None
    np.testing.assert_allclose(got.numpy(), pn2_run["jpc"], **TOL)


@pytest.mark.parametrize("name", ["det0", "det1", "det2", "sem", "lane", "pc"])
def test_pn2_slice_outputs_match_jax(pn2_run, name):
    jdet, jsem, jlane, jpc = pn2_run["jout"]
    pdet, psem, plane, ppc = pn2_run["pout"]
    want, got = {
        "det0": (nchw(jdet[0]), pdet[0]), "det1": (nchw(jdet[1]), pdet[1]),
        "det2": (nchw(jdet[2]), pdet[2]), "sem": (nchw(jsem), psem),
        "lane": (nchw(jlane), plane), "pc": (jpc, ppc)}[name]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **SLICE_TOL)


def test_pn2_slice_decode_nms_matches_jax(pn2_run):
    cfg = pn2_run["cfg"]
    dec = decode_outputs(pn2_run["pout"][0], (RES, RES))
    np.testing.assert_allclose(dec.numpy(), pn2_run["jdec"], rtol=2e-3,
                               atol=1e-4)
    _assert_same_detections(non_max_suppression(dec, cfg.num_det, CONF, NMS),
                            pn2_run["jdets"])


def test_pointnet2_entries_round_trip(pn2_run):
    """transplant(port.state_dict()) reproduces every flax leaf (strict),
    the PointNet++ leaves through `pointnet2_entries`."""
    variables = pn2_run["variables"]
    sd = {k: v.numpy() for k, v in pn2_run["model"].state_dict().items()}
    back = ti.transplant(variables, sd, pn2_run["entries"], strict=True)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    assert any("pc_seg" in jax.tree_util.keystr(p) for p, _ in want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))
