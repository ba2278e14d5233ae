"""Each module of the PyTorch port against its JAX module, on the CPU.

The flax variables are random, from a numpy seed; the port gets them
through `achelous_tpu_torch.weights.state_dict_from_jax` and the JAX
package's own torch mapping.  Float32, rtol/atol 1e-4.

The model-level modules (EdgeNeXt-S0, DualFPN-gdf, RCNet at band 4 with
offsets that move taps by cells, IRFusion, DecoupleHead, PointNetSeg) are
held against one JAX apply of the whole EN-GDF-PN-S0 model at 64x64 on its
default CPU path: flax records each module's output, and the port's module
gets that module's JAX input, so every comparison is of one module alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.ops import primitives as jp
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.core.config import WIDTHS
from achelous_tpu_torch.models.achelous import IRFusion
from achelous_tpu_torch.models.edgenext import EDGENEXT_VARIANTS
from achelous_tpu_torch.models.heads import DecoupleHead
from achelous_tpu_torch.models.necks import DualFPN
from achelous_tpu_torch.models.pointnet import PointNetSeg
from achelous_tpu_torch.models.rcnet import RCNet
from achelous_tpu_torch.ops import primitives as tp
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_slice import BATCH, RES, random_variables


TOL = dict(rtol=1e-4, atol=1e-4)


def load(port: nn.Module, variables, entries) -> nn.Module:
    sd = state_dict_from_jax(variables, entries, port.state_dict())
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port.eval()


def t(a):
    """JAX NHWC array -> NCHW torch tensor."""
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))


def close(got: torch.Tensor, want_nhwc, **tol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want_nhwc).transpose(0, 3, 1, 2),
                               **(tol or TOL))


def test_config_matches_jax():
    from achelous_tpu.core.config import WIDTHS as JAX_WIDTHS
    from achelous_tpu_torch.core.config import AchelousConfig
    assert WIDTHS == JAX_WIDTHS
    port, ref = AchelousConfig(), JaxConfig()
    for f in ("num_det", "num_seg", "pc_classes", "phi", "backbone", "neck",
              "pc_model", "nano_head", "resolution",
              "image_channels", "radar_channels", "pc_channels", "pc_points",
              "deform_band", "det_in_channels", "name"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.deform_band == 4 and port.dtype == torch.float32


# ---------------------------------------------------------------------------
# primitives: each JAX module alone on a small input
# ---------------------------------------------------------------------------


class _Holder(nn.Module):
    """Puts a port module under key prefix `m.`, matching the mapping
    helpers' torch keys."""

    def __init__(self, m):
        super().__init__()
        self.m = m


PRIMITIVES = {
    # name: (JAX module, port module, mapping helper, input channels)
    "ConvBN": (lambda: jp.ConvBN(24, 3), lambda: tp.ConvBN(16, 24, 3),
               ti._base_conv, 16),
    "ConvBN_hswish": (lambda: jp.ConvBN(24, 3, act="hswish"),
                      lambda: tp.ConvBN(16, 24, 3, act="hswish"),
                      ti._base_conv, 16),
    "ConvBN_ds": (lambda: jp.ConvBN(24, 5, ds_conv=True),
                  lambda: tp.ConvBN(16, 24, 5, ds_conv=True),
                  lambda m, k: ti._base_conv(m, k, ds_conv=True), 16),
    "YoloConv": (lambda: jp.YoloConv(24, 3), lambda: tp.YoloConv(16, 24, 3),
                 ti._yolo_conv, 16),
    "GhostModule": (lambda: jp.GhostModule(13), lambda: tp.GhostModule(16, 13),
                    ti._ghost_module, 16),
    "GhostBottleneck": (lambda: jp.GhostBottleneck(32, 8),
                        lambda: tp.GhostBottleneck(16, 32, 8),
                        lambda m, k: ti._ghost_bottleneck(m, k, True), 16),
    "SPP": (lambda: jp.SPP(24), lambda: tp.SPP(16, 24), ti._spp, 16),
    "Upsample": (lambda: jp.Upsample(8), lambda: tp.Upsample(16, 8),
                 ti._upsample, 16),
    "ECA": (lambda: jp.ECA(), lambda: tp.ECA(48), ti._eca, 48),
    "ShuffleAttention": (lambda: jp.ShuffleAttention(G=4),
                         lambda: tp.ShuffleAttention(48),
                         ti._shuffle_attention, 48),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name):
    make_jax, make_port, helper, cin = PRIMITIVES[name]
    x = np.random.RandomState(0).randn(2, 12, 12, cin).astype(np.float32)
    jmod = make_jax()
    variables = random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), seed=2)
    want = jmod.apply(variables, x)
    entries = ti.Mapping()
    helper(entries, "m")
    port = load(_Holder(make_port()), variables, entries).m
    with torch.inference_mode():
        close(port(t(x)), want)


# ---------------------------------------------------------------------------
# model-level modules against one recorded JAX apply
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded():
    cfg = JaxConfig(phi="S0", backbone="en", neck="gdf", pc_model="pn",
                    resolution=RES, dtype=jnp.float32)
    model = jax_create_model(cfg)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    pc = rng.rand(BATCH, cfg.pc_points, cfg.pc_channels).astype(np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.PRNGKey(0), img, rad, pc),
        seed=1)

    def run(v, *inputs):
        # record the output of every direct child of the model
        return model.apply(v, *inputs, mutable=["intermediates"],
                           capture_intermediates=lambda mdl, method:
                           method == "__call__" and len(mdl.scope.path) == 1)

    _, state = jax.jit(run)(variables, img, rad, pc)
    out = {k: v["__call__"][0] for k, v in state["intermediates"].items()
           if k != "pc_trans_feat"}          # the model's own sow
    return dict(variables=variables, img=img, rad=rad, pc=pc,
                out=jax.tree_util.tree_map(np.asarray, out))


def _entries(make, *args, prefix):
    return make(*args, prefix=(prefix,))


def test_edgenext_s0_matches_jax(recorded):
    port = load(EDGENEXT_VARIANTS["S0"](), recorded["variables"],
                _entries(ti.edgenext_mapping, "S0", prefix="backbone"))
    with torch.inference_mode():
        got = port(t(recorded["img"]))
    want = recorded["out"]["backbone"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g, w)


def test_dualfpn_gdf_matches_jax(recorded):
    port = load(DualFPN(9, "S0"), recorded["variables"],
                _entries(ti.dualfpn_neck_mapping, "S0", "gdf", prefix="fpn"))
    with torch.inference_mode():
        sem, lane, det = port.forward_feats(
            tuple(t(f) for f in recorded["out"]["backbone"]))
    wsem, wlane, wdet = recorded["out"]["fpn"]
    close(sem, wsem)
    close(lane, wlane)
    for g, w in zip(det, wdet):
        close(g, w)


def test_rcnet_band4_matches_jax(recorded):
    port = load(RCNet("S0", band=4), recorded["variables"],
                _entries(ti.rcnet_mapping, "S0", prefix="radar_encoder"))
    # the recorded offsets really move taps: offset conv outputs of block 0
    # reach past one cell
    blk = port.rc_blocks[0].radar_conv.deformable_conv
    pooled = torch.nn.functional.avg_pool2d(
        torch.from_numpy(recorded["rad"]), 3, 1, 1)
    assert blk.offset_conv(pooled).abs().max() > 1.0
    with torch.inference_mode():
        got = port(torch.from_numpy(recorded["rad"]))
    want = recorded["out"]["radar_encoder"]
    assert [g.shape[1] for g in got] == [w // 4 for w in WIDTHS["S0"][1:]]
    for g, w in zip(got, want):
        close(g, w)


def test_irfusion_matches_jax(recorded):
    port = load(IRFusion("S0"), recorded["variables"],
                _entries(ti.irfusion_mapping, "S0", prefix="ir_fusion"))
    p5, p4, p3 = recorded["out"]["fpn"][2]
    with torch.inference_mode():
        got = port((t(p3), t(p4), t(p5)),
                   tuple(t(r) for r in recorded["out"]["radar_encoder"]))
    for g, w in zip(got, recorded["out"]["ir_fusion"]):
        close(g, w)


def test_decouplehead_matches_jax(recorded):
    cin = [w * 5 // 4 for w in WIDTHS["S0"][1:]]
    port = load(DecoupleHead(7, cin), recorded["variables"],
                _entries(ti.decouplehead_mapping, prefix="det_head"))
    with torch.inference_mode():
        got = port(tuple(t(f) for f in recorded["out"]["ir_fusion"]))
    for g, w in zip(got, recorded["out"]["det_head"]):
        close(g, w)


def test_pointnetseg_matches_jax(recorded):
    port = load(PointNetSeg(8, 5), recorded["variables"],
                _entries(ti.pointnet_mapping, prefix="pc_seg"))
    with torch.inference_mode():
        got, trans_feat = port(torch.from_numpy(recorded["pc"]))
    want, want_tf = recorded["out"]["pc_seg"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(trans_feat.numpy(), want_tf, **TOL)
