"""The port's EdgeViT, RepViT, PoolFormer, MobileOne and FastViT backbones,
EfficientFormerV2-L, the `rdf` neck's RepVGG blocks and the deploy fold
(`core/reparam.py`), against the JAX package on the CPU, in float32.

  * each fold on one block (RepVGG; MobileOne at k = 1 and 3, with and
    without `rbr_skip`, and with its squeeze-excite; RepVGGDW; RepMixer; ReparamLargeKernelConv;
    RepCPE): the port's deploy block on its folded state against JAX's
    deploy block on JAX's `reparameterize(variables)`, at atol 2e-5 /
    rtol 1e-4 (tests/test_reparam.py's tolerance); the folded keys are
    the deploy block's;
  * each of those blocks in its train form in train mode against the
    flax block: forward, `jax.vjp` gradients and moved statistics, under
    test_torch_port_train_modules.py's gates (one small jit a block);
  * the RepViT (train and deploy form) and PoolFormer backbones against
    their JAX modules at 64x64, batch 2, within rtol 2e-3 / atol 1e-3
    (the other backbones are held inside whole models in
    test_torch_port_backbones_models.py);
  * EF-GDF-PN-L and EF-GDF-PN-S1 whole, as that file holds its models
    (its `run`), and EfficientFormerV2-L's and -S1's features;
  * a small FastViT with MHSA stages and RepCPE (unused by S0-S2), train
    and deploy form, against the JAX module;
  * each backbone's parameter count against the reference's
    (`GOLDEN_PARAMS`), and EfficientFormerV2-L's against JAX's;
  * each new backbone's weight-decay set, and the `rdf` neck's, against
    JAX's `_wd_mask` on `jax.eval_shape` shapes, carried through the
    mapping (no step compiled);
  * four reference behaviours that read like faults, pinned: EdgeViT's
    features of stages 1-3 are the patch embeddings' outputs;
    ReparamLargeKernelConv is affine (its activation's result is
    discarded); GlobalSparseAttn subsamples by a strided slice;
    PoolFormer pools with count_include_pad=False.

Variables come from `test_torch_port_slice.random_variables` (statistics
and norms off 0/1, layer scales drawn).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from achelous_tpu.core import reparam as jreparam
from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models import fastvit as jfastvit
from achelous_tpu.models import repvit as jrepvit
from achelous_tpu.models.achelous import make_backbone as jax_make_backbone
from achelous_tpu.models.necks import DualFPN as JaxDualFPN
from achelous_tpu.ops import blocks as jblocks
from achelous_tpu.ops import mobileone_block as jmobileone
from achelous_tpu.train import train_state as jts
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.core.reparam import reparameterize
from achelous_tpu_torch.models import edgevit, fastvit, poolformer, repvit
from achelous_tpu_torch.models.achelous import make_backbone
from achelous_tpu_torch.models.necks import DualFPN
from achelous_tpu_torch.ops.blocks import RepVGGBlock
from achelous_tpu_torch.ops.mobileone_block import MobileOneBlock
from achelous_tpu_torch.train import train_state as tts
from achelous_tpu_torch.weights import state_dict_from_jax
from test_backbones import GOLDEN_PARAMS
from test_torch_port_backbones_models import (EF_CONFIGS, OUTPUTS,
                                              check_backbone, check_output)
from test_torch_port_slice import BATCH, RES, nchw, random_variables
import test_torch_port_train_modules as train_modules

TOL = dict(rtol=2e-3, atol=1e-3)
FOLD_TOL = dict(rtol=1e-4, atol=2e-5)
NEW_BACKBONES = ("ev", "rv", "pf", "mo", "fv")
C = 8          # a block's input width
HW = 12        # a block's input size


def load(module: nn.Module, variables, entries) -> nn.Module:
    sd = state_dict_from_jax(variables, entries, module.state_dict())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval()


def leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# ---------------------------------------------------------------------------
# folds, one block each
# ---------------------------------------------------------------------------

def _mobileone(cin, cout, k, stride, branches, groups=1, use_se=False):
    return dict(
        jax=lambda deploy: jmobileone.MobileOneBlock(
            cout, k, stride=stride, groups=groups, use_se=use_se,
            num_conv_branches=branches, deploy=deploy),
        port=lambda deploy: MobileOneBlock(
            cin, cout, k, stride=stride, groups=groups, use_se=use_se,
            num_conv_branches=branches, deploy=deploy),
        entries=lambda m: ti.mobileone_block_mapping(
            m, "blk", cin, cout, k, stride, branches, use_se=use_se),
        cin=cin)


def _repmixer_entries(m):
    ti.mobileone_block_mapping(m.prefixed("norm"), "blk.norm", C, C, 3, 1, 0,
                               use_scale_branch=False)
    ti.mobileone_block_mapping(m.prefixed("mixer"), "blk.mixer", C, C, 3, 1,
                               1)
    m.param(["layer_scale"], "blk.layer_scale", "flat")


def _repvggdw_entries(m):
    ti._c2bn(m, "conv", "blk.conv")
    ti._c2bn(m, "conv1", "blk.conv1")


FOLDS = {
    "repvgg": dict(
        jax=lambda deploy: jblocks.RepVGGBlock(C, deploy=deploy),
        port=lambda deploy: RepVGGBlock(C, C, deploy=deploy),
        entries=lambda m: ti._repvgg_block(m, "blk", identity=True), cin=C),
    "repvgg_no_identity": dict(
        jax=lambda deploy: jblocks.RepVGGBlock(2 * C, deploy=deploy),
        port=lambda deploy: RepVGGBlock(C, 2 * C, deploy=deploy),
        entries=lambda m: ti._repvgg_block(m, "blk", identity=False), cin=C),
    "mobileone_k1_skip": _mobileone(C, C, 1, 1, 2),
    "mobileone_k1": _mobileone(C, 2 * C, 1, 1, 2),
    "mobileone_k3_skip_dw": _mobileone(C, C, 3, 1, 4, groups=C),
    "mobileone_k3_stride2": _mobileone(C, 2 * C, 3, 2, 1),
    # the squeeze-excite (2C / 16 = 1 channel) stays as it is
    "mobileone_k3_se": _mobileone(2 * C, 2 * C, 3, 1, 2, use_se=True),
    "repvggdw": dict(
        jax=lambda deploy: jrepvit.RepVGGDW(C, deploy=deploy),
        port=lambda deploy: repvit.RepVGGDW(C, deploy=deploy),
        entries=_repvggdw_entries, cin=C),
    "repmixer": dict(
        jax=lambda deploy: jfastvit.RepMixer(C, deploy=deploy),
        port=lambda deploy: fastvit.RepMixer(C, deploy=deploy),
        entries=_repmixer_entries, cin=C),
    "replk": dict(
        jax=lambda deploy: jfastvit.ReparamLargeKernelConv(
            2 * C, 7, 2, groups=8, deploy=deploy),
        port=lambda deploy: fastvit.ReparamLargeKernelConv(
            C, 2 * C, 7, 2, groups=8, deploy=deploy),
        entries=lambda m: ti._fv_replk(m, "blk"), cin=C),
    "repcpe": dict(
        jax=lambda deploy: jfastvit.RepCPE(C, deploy=deploy),
        port=lambda deploy: fastvit.RepCPE(C, deploy=deploy),
        entries=lambda m: m.conv(["pe"], "blk.pe"), cin=C),
}


@pytest.mark.parametrize("name", sorted(FOLDS))
def test_fold_matches_jax(name):
    case = FOLDS[name]
    rng = np.random.RandomState(7)
    x = rng.randn(BATCH, HW, HW, case["cin"]).astype(np.float32)
    jtrain = case["jax"](False)
    variables = random_variables(
        jax.eval_shape(jtrain.init, jax.random.PRNGKey(0), x), seed=3)
    entries = ti.Mapping()
    case["entries"](entries)
    train = load(nn.ModuleDict({"blk": case["port"](False)}), variables,
                 entries)
    deploy = nn.ModuleDict({"blk": case["port"](True)}).eval()
    folded = reparameterize(train.state_dict())
    assert set(folded) == set(deploy.state_dict())
    deploy.load_state_dict(folded)

    jfolded = jreparam.reparameterize(variables)
    want = np.asarray(jax.jit(case["jax"](True).apply)(jfolded, x))
    with torch.no_grad():
        xt = torch.from_numpy(nchw(x))
        got = deploy["blk"](xt).numpy()
        train_out = train["blk"](xt).numpy()
    np.testing.assert_allclose(got, nchw(want), **FOLD_TOL)
    # and the fold is exact on the port's own train form
    np.testing.assert_allclose(got, train_out, **FOLD_TOL)


def _block_spec(name):
    """FOLDS' block `name` in its train form as a module of
    test_torch_port_train_modules.py's harness (its own seed)."""
    case = FOLDS[name]
    entries = ti.Mapping()
    case["entries"](entries)
    return dict(jax=case["jax"](False),
                port=nn.ModuleDict({"blk": case["port"](False)}),
                entries=entries, inputs=[(HW, HW, case["cin"])],
                call=lambda m, x: m["blk"](x),
                seed=30 + sorted(FOLDS).index(name))


# the harness's names of the blocks
BLOCKS = {f"{n} block": functools.partial(_block_spec, n) for n in FOLDS}
train_modules.BUILD.update(BLOCKS)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_forward_matches_flax(name):
    """Each reparameterizable block's train form in train mode (batch
    statistics) against the flax block's, at the slice tolerance."""
    train_modules.check_forward(name)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_gradients_match_flax_vjp(name):
    """`jax.vjp` of the flax block against torch's backward, under
    test_torch_port_train_modules.py's gradient gate."""
    train_modules.check_gradients(name)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_statistics_match_flax(name):
    """The running statistics the train-mode forward moved (RepCPE has
    none: one conv)."""
    train_modules.check_statistics(name)


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

def jax_backbone(backbone: str, phi: str, resolution: int,
                 deploy: bool = False):
    cfg = JaxConfig(phi=phi, backbone=backbone, resolution=resolution,
                    dtype=jnp.float32)
    return jax_make_backbone(cfg, deploy=deploy)


def port_backbone(backbone: str, phi: str, resolution: int,
                  deploy: bool = False):
    cfg = AchelousConfig(phi=phi, backbone=backbone, resolution=resolution)
    return make_backbone(cfg, deploy)


# RepViT's residual branches: RepVGGDW's two conv+BN branches (added to
# the input) and the channel mixer's last BN (zero at init in the
# reference).  At full strength on random variables 25 such blocks grow
# the maps to ~1e5, where float32 rounding alone exceeds atol 1e-3; at
# 0.3 they stay O(1), and a dropped or wrong branch still moves the
# outputs by far more than the tolerance.
RV_RESIDUAL_BNS = ("conv_bn", "conv1_bn", "cm_fc2_bn")
RV_RESIDUAL_SCALE = 0.3


@functools.lru_cache(maxsize=None)
def backbone_variables(backbone: str, phi: str = "S0"):
    x = np.zeros((BATCH, RES, RES, 3), np.float32)
    shapes = jax.eval_shape(jax_backbone(backbone, phi, RES).init,
                            jax.random.PRNGKey(0), x)
    variables = random_variables(shapes, seed=5)
    if backbone == "rv":
        def damp(path, v):
            keys = [getattr(k, "key", None) for k in path]
            hit = keys[0] == "params" and any(k in RV_RESIDUAL_BNS
                                              for k in keys)
            return v * RV_RESIDUAL_SCALE if hit else v
        variables = jax.tree_util.tree_map_with_path(damp, variables)
    return shapes, variables


@pytest.mark.parametrize("backbone,deploy", [("rv", False), ("rv", True),
                                             ("pf", False)])
def test_backbone_matches_jax(backbone, deploy):
    _, variables = backbone_variables(backbone)
    x = np.random.RandomState(0).rand(BATCH, RES, RES, 3).astype(np.float32)
    jvars = jreparam.reparameterize(variables) if deploy else variables
    want = jax.jit(jax_backbone(backbone, "S0", RES, deploy).apply)(jvars, x)
    train = load(port_backbone(backbone, "S0", RES), variables,
                 ti.BACKBONE_MAPPINGS[backbone]("S0"))
    model = train
    if deploy:
        model = port_backbone(backbone, "S0", RES, deploy=True).eval()
        model.load_state_dict(reparameterize(train.state_dict()))
    with torch.no_grad():
        got = model(torch.from_numpy(nchw(x)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 1e-3
        np.testing.assert_allclose(g.numpy(), nchw(w), **TOL)


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("name", EF_CONFIGS)
def test_efficientformer_model_outputs_match_jax(name, output):
    check_output(name, False, output)


@pytest.mark.parametrize("name", EF_CONFIGS)
def test_efficientformer_features_match_jax(name):
    check_backbone(name, False)


@pytest.mark.parametrize("backbone,phi", [(b, p) for b in NEW_BACKBONES
                                          for p in ("S0", "S1", "S2")])
def test_backbone_parameter_counts_match_reference(backbone, phi):
    n = sum(p.numel() for p in port_backbone(backbone, phi, 320).parameters())
    assert n == GOLDEN_PARAMS[(backbone, phi)]


def test_efficientformer_l_parameter_count_matches_jax():
    """GOLDEN_PARAMS has no L row: EfficientFormerV2-L's count at 320x320
    against the JAX module's (bias tables depend on the resolution)."""
    x = jnp.zeros((1, 320, 320, 3))
    shapes = jax.eval_shape(jax_backbone("ef", "L", 320).init,
                            jax.random.PRNGKey(0), x)
    want = sum(v.size for v in jax.tree_util.tree_leaves(shapes["params"]))
    got = sum(p.numel() for p in port_backbone("ef", "L", 320).parameters())
    assert got == want


def wd_want(params_shapes, entries) -> set:
    mask = jts._wd_mask(params_shapes)
    return {key for path, coll, key, *_ in entries
            if coll == "params" and leaf(mask, path)}


@pytest.mark.parametrize("backbone", NEW_BACKBONES)
def test_weight_decay_set_matches_jax_mask(backbone):
    """The port's decayed parameters are exactly those whose flax leaf
    JAX's `_wd_mask` marks, carried through the mapping."""
    shapes, _ = backbone_variables(backbone)
    want = wd_want(shapes["params"], ti.BACKBONE_MAPPINGS[backbone]("S0"))
    assert tts.decay_mask(port_backbone(backbone, "S0", RES)) == want


def test_rdf_neck_weight_decay_set_matches_jax_mask():
    w = (32, 48, 96, 176)
    feats = tuple(jnp.zeros((1, RES // s, RES // s, c))
                  for s, c in zip((4, 8, 16, 32), w))
    shapes = jax.eval_shape(JaxDualFPN(num_seg=9, family="rdf").init,
                            jax.random.PRNGKey(0), feats)
    want = wd_want(shapes["params"], ti.dualfpn_neck_mapping("S0", "rdf"))
    assert tts.decay_mask(DualFPN(9, "S0", family="rdf")) == want


def test_fastvit_attention_stages_match_jax():
    """FastViT's MHSA stages and RepCPE position embedding, which the
    S0-S2 variants do not use: a small FastViT with both (train and deploy
    form) against the JAX module."""
    layers, dims, ratios = (1, 1, 1, 1), (32, 32, 64, 64), (3, 3, 3, 3)
    mixers = ("repmixer", "repmixer", "attention", "attention")
    pos = (False, False, True, True)
    x = np.random.RandomState(0).rand(BATCH, RES, RES, 3).astype(np.float32)

    def jmodel(deploy):
        return jfastvit.FastViT(layers, dims, ratios, mixers, pos,
                                deploy=deploy)

    variables = random_variables(
        jax.eval_shape(jmodel(False).init, jax.random.PRNGKey(0), x), seed=8)
    m = ti.Mapping()
    ti.mobileone_block_mapping(m.prefixed("stem0"), "patch_embed.0", 3,
                               dims[0], 3, 2, 1)
    ti.mobileone_block_mapping(m.prefixed("stem1"), "patch_embed.1",
                               dims[0], dims[0], 3, 2, 1)
    ti.mobileone_block_mapping(m.prefixed("stem2"), "patch_embed.2",
                               dims[0], dims[0], 1, 1, 1)
    for i, d in enumerate(dims):
        blk, tk = m.prefixed(f"stage{i}_block0"), f"network.{2 * i}.0"
        if pos[i]:
            m.conv([f"pos_emb{i}", "pe"], f"pos_emb{i}.pe")
        if mixers[i] == "repmixer":
            tm = blk.prefixed("token_mixer")
            ti.mobileone_block_mapping(tm.prefixed("norm"),
                                       f"{tk}.token_mixer.norm", d, d, 3, 1,
                                       0, use_scale_branch=False)
            ti.mobileone_block_mapping(tm.prefixed("mixer"),
                                       f"{tk}.token_mixer.mixer", d, d, 3,
                                       1, 1)
            tm.param(["layer_scale"], f"{tk}.token_mixer.layer_scale",
                     "flat")
            blk.param(["layer_scale"], f"{tk}.layer_scale", "flat")
        else:
            blk.bn(["norm"], f"{tk}.norm")
            blk.dense(["token_mixer", "qkv"], f"{tk}.token_mixer.qkv",
                      bias=False)
            blk.dense(["token_mixer", "proj"], f"{tk}.token_mixer.proj")
            blk.param(["layer_scale_1"], f"{tk}.layer_scale_1", "flat")
            blk.param(["layer_scale_2"], f"{tk}.layer_scale_2", "flat")
        ti._fv_convffn(blk.prefixed("convffn"), f"{tk}.convffn")
        m.bn([f"norm_out{i}"], f"norm{2 * i}")
        if i < 3:
            tk = f"network.{2 * i + 1}"
            ti._fv_replk(m.prefixed(f"embed{i}_lk"), f"{tk}.proj.0")
            ti.mobileone_block_mapping(m.prefixed(f"embed{i}_pw"),
                                       f"{tk}.proj.1", dims[i + 1],
                                       dims[i + 1], 1, 1, 1)
    train = load(fastvit.FastViT(layers, dims, ratios, mixers, pos),
                 variables, m)
    deploy = fastvit.FastViT(layers, dims, ratios, mixers, pos,
                             deploy=True).eval()
    deploy.load_state_dict(reparameterize(train.state_dict()))
    for model, jvars, form in ((train, variables, False),
                               (deploy, jreparam.reparameterize(variables),
                                True)):
        want = jax.jit(jmodel(form).apply)(jvars, x)
        with torch.no_grad():
            got = model(torch.from_numpy(nchw(x)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), nchw(w), **TOL)


# ---------------------------------------------------------------------------
# reference behaviours pinned
# ---------------------------------------------------------------------------

def test_edgevit_features_are_patch_embeddings():
    torch.manual_seed(0)
    model = edgevit.edgevit("S0").eval()
    x = torch.rand(1, 3, RES, RES)
    with torch.no_grad():
        feats = model(x)
        e1 = model.patch_embed1(x)
        e2 = model.patch_embed2(model.blocks1[0](e1))
    torch.testing.assert_close(feats[0], e1, rtol=0, atol=0)
    torch.testing.assert_close(feats[1], e2, rtol=0, atol=0)
    # the stage's blocks run after the tap, and change the map
    assert (model.blocks1[0](e1) - e1).abs().max() > 1e-3


def test_large_kernel_conv_is_affine():
    """f(a) + f(b) - f(0) == f(a + b): no activation is applied."""
    torch.manual_seed(0)
    block = fastvit.ReparamLargeKernelConv(C, 2 * C, 7, 2, groups=8).eval()
    a, b = torch.randn(2, 1, C, HW, HW)
    with torch.no_grad():
        lhs = block(a) + block(b) - block(torch.zeros_like(a))
        rhs = block(a + b)
    assert (rhs < 0).any()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-5)


def test_global_sparse_attention_subsamples_by_slice():
    """Tokens off the stride grid reach the output only through nothing:
    the subsample keeps every sr-th pixel (an AvgPool2d(1, sr))."""
    torch.manual_seed(0)
    attn = edgevit.GlobalSparseAttn(16, 2, sr_ratio=2).eval()
    h = w = 8
    x = torch.randn(1, h * w, 16)
    y = x.clone().reshape(1, h, w, 16)
    y[:, 1::2] += 5.0                 # every odd row: off the grid
    y[:, :, 1::2] += 5.0              # every odd column
    with torch.no_grad():
        torch.testing.assert_close(attn(y.reshape(1, h * w, 16), h, w),
                                   attn(x, h, w), rtol=0, atol=0)
        grid = x.clone().reshape(1, h, w, 16)
        grid[:, 0, 0] += 5.0          # on the grid
        assert (attn(grid.reshape(1, h * w, 16), h, w)
                - attn(x, h, w)).abs().max() > 1e-3


def test_poolformer_pools_without_padding_counts():
    """On a constant map the pool equals the map at the border too, so the
    token mixer adds nothing: pooled - y == 0 only without pad counts."""
    block = poolformer.PoolFormerBlock(C).eval()
    with torch.no_grad():
        block.layer_scale_1.fill_(1.0)
        block.layer_scale_2.zero_()
        block.norm1.bias.copy_(torch.arange(1.0, C + 1))
    x = torch.full((1, C, HW, HW), 3.0)
    with torch.no_grad():
        torch.testing.assert_close(block(x), x, rtol=0, atol=1e-6)
