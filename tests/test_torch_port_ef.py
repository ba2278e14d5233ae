"""The PyTorch port's EfficientFormerV2 backbone, K3's plain version and
EF-GDF-PN-S0 against the JAX package, on the CPU.

  - the Attention4D / Attention4DDownsample bias index tables equal JAX's;
  - K3's plain version (`ops/attention.py`) matches the Pallas
    `fused_bias_attention` (interpret mode) and `reference_bias_attention`
    at b = 2, h = 8, dk = 32, dv = 128, N = 100 and 36, with
    non-symmetric head mixes (the port holds them as [g_out, h_in], JAX as
    [h_in, g_out]): float32, rtol/atol 1e-4;
  - Attention4D (with and without the stride conv), Attention4DDownsample,
    EFBlock, EfficientFormerV2-S0 at 64x64 (rtol/atol 1e-4), and the whole
    EF-GDF-PN-S0 at 64x64, batch 2 (rtol 2e-3 / atol 1e-3, the slice
    tolerance of test_torch_port_slice.py), on numpy-seeded flax variables
    carried across by `achelous_mapping("S0", "ef", "gdf")`, which also
    round-trips strictly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models import efficientformer as jef
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.ops.pallas_attention import (fused_bias_attention,
                                               reference_bias_attention)
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.entry import serving_config
from achelous_tpu_torch.models import efficientformer as tef
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops import attention, hopper_attention
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_modules import _Holder, close, load, t
from test_torch_port_slice import BATCH, RES, nchw, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)
SLICE_TOL = dict(rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("res", [2, 4, 5, 10, 20])
def test_bias_tables_match_jax(res):
    for port_fn, jax_fn in ((tef.bias_idxs_same, jef._bias_idxs_same),
                            (tef.bias_idxs_down, jef._bias_idxs_down)):
        got, n_got = port_fn(res)
        want, n_want = jax_fn(res)
        assert n_got == n_want
        np.testing.assert_array_equal(got, want)


def k3_case(n, seed=0, b=2, h=8, dk=32, dv=128):
    """q, k, v, bias and JAX-layout head mixes [h_in, g_out], float32."""
    rng = np.random.RandomState(seed)
    f = np.float32
    q, k = (rng.randn(b, h, n, dk).astype(f) for _ in range(2))
    v = rng.randn(b, h, n, dv).astype(f)
    bias = (rng.randn(h, n, n) * 0.5).astype(f)
    w1, w2 = ((rng.randn(h, h) * 0.4).astype(f) for _ in range(2))
    b1, b2 = ((rng.randn(h) * 0.2).astype(f) for _ in range(2))
    assert not np.allclose(w1, w1.T)
    return q, k, v, bias, w1, b1, w2, b2


@pytest.mark.parametrize("n", [100, 36])
def test_k3_plain_matches_pallas_and_jax_reference(n):
    q, k, v, bias, w1, b1, w2, b2 = k3_case(n)
    scale = 32 ** -0.5
    got = hopper_attention.fused_bias_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
        torch.from_numpy(w2.T.copy()), torch.from_numpy(b2), scale)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias, w1, b1, w2, b2)]
    kernel = fused_bias_attention(*jargs, scale, interpret=True)
    ref = reference_bias_attention(*jargs, scale)
    assert got.shape == (2, 8, n, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_k3_wrapper_takes_the_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in k3_case(16, seed=1)]
    hopper_attention.fused_bias_attention.launches = 0
    got = hopper_attention.fused_bias_attention(*args, 0.25)
    torch.testing.assert_close(
        got, attention.reference_bias_attention(*args, 0.25), rtol=0, atol=0)
    assert hopper_attention.fused_bias_attention.launches == 0
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        hopper_attention.fused_bias_attention(
            *(a.to("meta") for a in args), 0.25)


def _block_entries(stride):
    m = ti.Mapping()
    m.param(["layer_scale_1"], "m.layer_scale_1", "flat")
    ti._ef_attention4d(m.prefixed("token_mixer"), "m.token_mixer", stride)
    m.param(["layer_scale_2"], "m.layer_scale_2", "flat")
    ti._ef_mlp(m.prefixed("mlp"), "m.mlp")
    return m


def _attention4d_entries(stride):
    m = ti.Mapping()
    ti._ef_attention4d(m, "m", stride)
    return m


def _downsample_entries():
    m = ti.Mapping()
    ti._ef_attention_downsample(m, "m")
    return m


MODULES = {
    # name: (JAX module, port module, entries, input [res, channels])
    "Attention4D": (lambda: jef.Attention4D(24, resolution=4),
                    lambda: tef.Attention4D(24, resolution=4),
                    lambda: _attention4d_entries(False), (4, 24)),
    "Attention4D_stride": (lambda: jef.Attention4D(24, resolution=5,
                                                   stride=2),
                           lambda: tef.Attention4D(24, resolution=5,
                                                   stride=2),
                           lambda: _attention4d_entries(True), (5, 24)),
    "Attention4DDownsample": (
        lambda: jef.Attention4DDownsample(24, 32, resolution=5),
        lambda: tef.Attention4DDownsample(24, 32, resolution=5),
        _downsample_entries, (5, 24)),
    "EFBlock": (lambda: jef.EFBlock(24, 4, True, resolution=4),
                lambda: tef.EFBlock(24, 4, True, resolution=4),
                lambda: _block_entries(False), (4, 24)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_ef_module_matches_jax(name):
    make_jax, make_port, entries, (res, cin) = MODULES[name]
    x = np.random.RandomState(0).randn(2, res, res, cin).astype(np.float32)
    jmod = make_jax()
    variables = random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), seed=2)
    want = jmod.apply(variables, x)
    port = load(_Holder(make_port()), variables, entries()).m
    with torch.inference_mode():
        close(port(t(x)), want)


@pytest.fixture(scope="module")
def ef_run():
    """One JAX apply of EF-GDF-PN-S0 (recording the backbone's outputs) and
    the port on the same variables and inputs."""
    jcfg = JaxConfig(phi="S0", backbone="ef", neck="gdf", pc_model="pn",
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
                            and mdl.scope.path == ("backbone",))

    jout, state = jax.jit(run)(variables, img, rad, pc)
    cfg = serving_config(torch.float32, RES, backbone="ef")
    model = create_model(cfg, "cpu")
    mapping = ti.achelous_mapping("S0", "ef", "gdf")
    sd = state_dict_from_jax(variables, mapping, model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        pout = model(torch.from_numpy(img.transpose(0, 3, 1, 2)),
                     torch.from_numpy(rad), torch.from_numpy(pc))
    return dict(variables=variables, model=model, mapping=mapping, img=img,
                pout=pout, jout=jax.tree_util.tree_map(np.asarray, jout),
                jbackbone=jax.tree_util.tree_map(
                    np.asarray,
                    state["intermediates"]["backbone"]["__call__"][0]))


def test_efficientformer_s0_matches_jax(ef_run):
    port = load(tef.EfficientFormerV2("S0", RES), ef_run["variables"],
                ti.efficientformer_mapping("S0", prefix=("backbone",)))
    with torch.inference_mode():
        got = port(t(ef_run["img"]))
    assert len(got) == len(ef_run["jbackbone"]) == 4
    for g, w in zip(got, ef_run["jbackbone"]):
        close(g, w)


@pytest.mark.parametrize("name", ["det0", "det1", "det2", "sem", "lane", "pc"])
def test_ef_slice_outputs_match_jax(ef_run, name):
    jdet, jsem, jlane, jpc = ef_run["jout"]
    pdet, psem, plane, ppc = ef_run["pout"]
    want, got = {
        "det0": (nchw(jdet[0]), pdet[0]), "det1": (nchw(jdet[1]), pdet[1]),
        "det2": (nchw(jdet[2]), pdet[2]), "sem": (nchw(jsem), psem),
        "lane": (nchw(jlane), plane), "pc": (jpc, ppc)}[name]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **SLICE_TOL)


def test_ef_mapping_round_trip(ef_run):
    """transplant(port.state_dict(), achelous_mapping("S0", "ef", "gdf"))
    reproduces every flax leaf (strict)."""
    variables = ef_run["variables"]
    sd = {k: v.numpy() for k, v in ef_run["model"].state_dict().items()}
    back = ti.transplant(variables, sd, ef_run["mapping"], strict=True)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))
