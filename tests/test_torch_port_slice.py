"""The PyTorch port's serving slice against the JAX package, on the CPU.

EN-GDF-PN-S0 at 64x64, batch 2, float32: one set of flax variables (random,
from a numpy seed, with non-zero deformable offsets) runs through the JAX
model on its default CPU path and, carried across by
`achelous_tpu_torch.weights.state_dict_from_jax`, through the port.  All
four outputs must agree (rtol 2e-3 / atol 1e-3, the tolerance of the
full-assembly parity tests), and decode + NMS must pick the same boxes.
Also: the weight bridge round-trips, and the port imports no JAX.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.ops.postprocess import decode_outputs as jax_decode
from achelous_tpu.ops.postprocess import non_max_suppression as jax_nms
from achelous_tpu.utils.torch_import import achelous_mapping, transplant

from achelous_tpu_torch.entry import entry, serving_config
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops.postprocess import (decode_outputs,
                                                non_max_suppression)
from achelous_tpu_torch.weights import state_dict_from_jax

RES, BATCH = 64, 2
CONF, NMS = 0.1, 0.35     # low threshold: many boxes reach NMS
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "achelous_tpu_torch"


def random_variables(shapes, seed):
    """Flax variables of the given shapes from a numpy seed: lecun-scaled
    kernels, offset convs large enough to move taps by cells (some past
    the band), perturbed norms and statistics."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        name, shape = keys[-1], s.shape
        if keys[0] == "batch_stats":
            v = rng.rand(*shape) + 0.5 if name == "var" else \
                rng.randn(*shape) * 0.1
        elif name in ("kernel", "weight"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            if "offset_conv" in keys:
                v = v * 3.0
        elif name == "bias" and "offset_conv" in keys:
            v = rng.randn(*shape) * 1.5
        elif name in ("scale", "temperature", "cbias", "sbias", "gn_scale"):
            v = 1.0 + rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def slice_run():
    """One JAX init (shapes only) + apply, and the port on the same
    variables and inputs."""
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", pc_model="pn",
                     resolution=RES, dtype=jnp.float32)
    jmodel = jax_create_model(jcfg)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    pc = rng.rand(BATCH, jcfg.pc_points, jcfg.pc_channels).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, rad, pc)
    variables = random_variables(shapes, seed=1)
    jout = jax.jit(jmodel.apply)(variables, img, rad, pc)
    jdec = jax_decode(jout[0], (RES, RES))
    jdets = jax_nms(jdec, jcfg.num_det, CONF, NMS)

    cfg = serving_config(torch.float32, RES)
    model = create_model(cfg, "cpu")
    sd = state_dict_from_jax(variables, achelous_mapping("S0", "en", "gdf"),
                             model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        pout = model(torch.from_numpy(img.transpose(0, 3, 1, 2)),
                     torch.from_numpy(rad), torch.from_numpy(pc))
    return dict(cfg=cfg, variables=variables, model=model,
                jout=jax.tree_util.tree_map(np.asarray, jout), pout=pout,
                jdec=np.array(jdec),
                jdets=jax.tree_util.tree_map(np.asarray, jdets))


@pytest.mark.parametrize("name", ["det0", "det1", "det2", "sem", "lane", "pc"])
def test_slice_outputs_match_jax(slice_run, name):
    jdet, jsem, jlane, jpc = slice_run["jout"]
    pdet, psem, plane, ppc = slice_run["pout"]
    want, got = {
        "det0": (nchw(jdet[0]), pdet[0]), "det1": (nchw(jdet[1]), pdet[1]),
        "det2": (nchw(jdet[2]), pdet[2]), "sem": (nchw(jsem), psem),
        "lane": (nchw(jlane), plane), "pc": (jpc, ppc)}[name]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-3)


def _assert_same_detections(got, want):
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.cls_idx.numpy(),
                                  np.asarray(want.cls_idx))
    for field in ("boxes", "obj_conf", "cls_conf"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        np.testing.assert_allclose(g[valid], w[valid], rtol=0, atol=1e-4,
                                   err_msg=field)


def test_nms_semantics_match_jax(slice_run):
    """Port NMS on the JAX decode: the same candidates, order and boxes."""
    jdec = slice_run["jdec"]
    got = non_max_suppression(torch.from_numpy(jdec),
                              slice_run["cfg"].num_det, CONF, NMS)
    _assert_same_detections(got, slice_run["jdets"])


def test_slice_decode_nms_matches_jax(slice_run):
    """End to end: port decode + NMS on the port's own outputs."""
    cfg = slice_run["cfg"]
    dec = decode_outputs(slice_run["pout"][0], (RES, RES))
    np.testing.assert_allclose(dec.numpy(), slice_run["jdec"], rtol=2e-3,
                               atol=1e-4)
    _assert_same_detections(non_max_suppression(dec, cfg.num_det, CONF, NMS),
                            slice_run["jdets"])


def test_weight_bridge_round_trip(slice_run):
    """transplant(port.state_dict()) reproduces the flax variables, every
    leaf mapped (strict)."""
    variables = slice_run["variables"]
    sd = {k: v.numpy() for k, v in slice_run["model"].state_dict().items()}
    back = transplant(variables, sd, achelous_mapping("S0", "en", "gdf"),
                      strict=True)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))


def test_entry_points_default_to_the_gpu():
    """Without a visible GPU the default device raises; the CPU runs only
    when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    cfg = serving_config(torch.float32, RES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(cfg)
    _, inputs = entry("cpu", backbone="ef", pc_model="pn2")
    assert all(x.device.type == "cpu" for x in inputs)
    assert {serving_config(backbone=b, pc_model=p).name
            for b, p in (("en", "pn"), ("en", "pn2"), ("ef", "pn"))} == {
                "EN-GDF-PN-S0", "EN-GDF-PN2-S0", "EF-GDF-PN-S0"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """Neither the package nor chip_smoke.py, which runs where JAX is
    not installed."""
    files = sorted(PORT_ROOT.rglob("*.py")) + [PORT_ROOT.parent /
                                               "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "achelous_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f}: imports {mod}"
