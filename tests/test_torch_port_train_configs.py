"""The port's training configurations beyond EN-GDF-PN-S0, EF-GDF-PN-S0 and
EN-GDF-PN2-S0, against the JAX package's training rules, on the CPU.

The twelve configurations (`CONFIGS`): EN-GDF-PN-S1 and -S2, EN-GDF-PN-S0
with SPPF (`use_spp=False`) and with the base-256 head
(`nano_head=False`), MV-GDF-PN-S1, EN-CDF-PN2-S2, EV-, PF-GDF-PN-S0,
EF-GDF-PN-L, and the reparameterizable RV-GDF-PN-S0, MO-RDF-PN-S0 and
FV-RDF-PN-S0 in their train form, at 64x64.  No JAX step is compiled here: the JAX side is
`jax.eval_shape` of the model's init and eager JAX.

  * The weight-decay set against JAX's `_wd_mask` through the mapping:
    a stacked leaf (MobileViT's transformer, `nn.scan` over its layers)
    that JAX decays puts each of its layer keys in the port's set.
  * The tensors `weights_init` re-draws against those JAX's
    `weights_init` re-draws on the same numpy-seeded variables.  JAX's
    decisions depend on each leaf's path and rank only, so it runs on a
    probe of the variables with every dimension cut to 1 (one eager draw
    a leaf); the port runs on the variables themselves, loaded into it.
  * Each scheme's spread on MobileViT-S1's second MobileViT block
    against JAX's `weights_init` on the same block: every re-drawn leaf of >=
    4096 values within 10 % of JAX's standard deviation, the stacked
    Linear weights taken together (fans over depth * in), and with
    `orthogonal` the layers' weights of one stack orthonormal together,
    as JAX's [depth * in, out] matrix is.
  * `--spp false` trains through the CLI (SPPF in the state it returns);
    `--is_pc false` is still refused.
  * One port step of each configuration at batch 4: finite metrics.

MobileViT-S1's decay and init sets were the port's own before its
Transformer took kind "stacked" (core/init.py): no transformer norm or
bias decayed, no Linear weight re-drawn.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from achelous_tpu.core import init as jinit
from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.train import train_state as jts

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.core.init import (INIT_TYPES, flax_conv_weights,
                                          stacked_weights, weights_init)
from achelous_tpu_torch.data.example import write_tree
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.train import cli
from achelous_tpu_torch.train import train_state as tts
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_configs import jax_entries
from test_torch_port_slice import random_variables

RES, BATCH, MAX_GT = 64, 4, 8
# name -> AchelousConfig fields (both packages take the same names)
CONFIGS = {
    "EN-GDF-PN-S1": dict(phi="S1"),
    "EN-GDF-PN-S2": dict(phi="S2"),
    "EN-GDF-PN-S0-SPPF": dict(use_spp=False),
    "EN-GDF-PN-S0-HEAD256": dict(nano_head=False),
    "MV-GDF-PN-S1": dict(backbone="mv", phi="S1"),
    "EN-CDF-PN2-S2": dict(phi="S2", neck="cdf", pc_model="pn2"),
    "EV-GDF-PN-S0": dict(backbone="ev"),
    "PF-GDF-PN-S0": dict(backbone="pf"),
    "EF-GDF-PN-L": dict(backbone="ef", phi="L"),
    # the reparameterizable backbones, trained in their train form
    "RV-GDF-PN-S0": dict(backbone="rv"),
    "MO-RDF-PN-S0": dict(backbone="mo", neck="rdf"),
    "FV-RDF-PN-S0": dict(backbone="fv", neck="rdf"),
}
# the deepest of MobileViT-S1's three transformers (4 layers); each
# block's eager JAX draws compile per shape
MV_BLOCKS = ("mvit_1",)
GAIN = 0.05


def leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def port_config(name):
    return AchelousConfig(resolution=RES, **CONFIGS[name])


@functools.lru_cache(maxsize=None)
def jax_side(name):
    """(shapes of the flax variables, the mapping's entries in the port's
    keys) of configuration `name`."""
    kw = CONFIGS[name]
    jcfg = JaxConfig(resolution=RES, **kw)
    x = (np.zeros((2, RES, RES, 3), np.float32),
         np.zeros((2, 3, RES, RES), np.float32),
         np.zeros((2, jcfg.pc_points, jcfg.pc_channels), np.float32))
    shapes = jax.eval_shape(jax_create_model(jcfg).init,
                            jax.random.PRNGKey(0), *x)
    entries = jax_entries(jcfg.backbone, jcfg.phi, jcfg.neck, jcfg.pc_model)
    return shapes, entries


def mapped(entries, tree):
    """Port keys of the params entries whose flax leaf of the bool tree
    `tree` is true (each layer key of a stacked leaf)."""
    return {key for path, coll, key, *_ in entries
            if coll == "params" and bool(leaf(tree, path))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_decay_set_matches_jax_mask(name):
    shapes, entries = jax_side(name)
    want = mapped(entries, jts._wd_mask(shapes["params"]))
    model = create_model(port_config(name), "cpu", train=True)
    got = tts.decay_mask(model)
    assert got == want, (sorted(got - want)[:8], sorted(want - got)[:8])
    if name.startswith("MV"):
        # every transformer parameter of each of the 2 + 4 + 3 layers (11
        # a layer): norms and biases too
        layers = {n for n, _ in model.named_parameters()
                  if ".transformer.layers." in n}
        assert len(layers) == 11 * (2 + 4 + 3) and layers <= got
        assert any(n.endswith("0.norm.weight") for n in layers)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_init_redraws_what_jax_redraws(name):
    """JAX's `weights_init` (normal) on a probe of the variables against
    the port's on the variables: the same tensors change, and with them
    `flax_conv_weights` names exactly the re-drawn kernels."""
    shapes, entries = jax_side(name)
    variables = random_variables(shapes, seed=3)
    probe = jax.tree_util.tree_map(
        lambda a: np.asarray(a).reshape(-1)[:1].reshape((1,) * a.ndim),
        variables)
    after = jinit.weights_init(probe["params"], probe["batch_stats"],
                               jax.random.PRNGKey(0), "normal", GAIN)
    changed = jax.tree_util.tree_map(lambda a, b: np.any(a != b),
                                     probe["params"], after)
    want = mapped(entries, changed)

    model = create_model(port_config(name), "cpu", train=True)
    sd = state_dict_from_jax(variables, entries, model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    weights_init(model, "normal", GAIN, torch.Generator().manual_seed(4))
    got = {n for n, p in model.named_parameters()
           if not torch.equal(p, before[n])}
    assert got == want, (sorted(got - want)[:8], sorted(want - got)[:8])
    kernels = {key for path, coll, key, *_ in entries
               if coll == "params" and path[-1] == "kernel"
               and leaf(shapes["params"], path).ndim >= 3}
    assert set(flax_conv_weights(model)) == kernels
    if name.startswith("MV"):
        assert sum(len(s) for s in stacked_weights(model)) == 4 * 9


@functools.lru_cache(maxsize=None)
def mv_spreads(init_type):
    """MobileViT-S1's MV_BLOCKS re-drawn by `init_type` on both
    sides: (JAX's leaves by path, the port's parameters, the entries)."""
    shapes, entries = jax_side("MV-GDF-PN-S1")
    variables = random_variables(shapes, seed=3)
    blocks = {b: variables["params"]["backbone"][b] for b in MV_BLOCKS}
    jax_blocks = jinit.weights_init(blocks, {}, jax.random.PRNGKey(1),
                                    init_type, GAIN)
    model = create_model(port_config("MV-GDF-PN-S1"), "cpu", train=True)
    weights_init(model, init_type, GAIN, torch.Generator().manual_seed(2))
    params = {n: p.detach() for n, p in model.named_parameters()}
    return jax_blocks, params, entries


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_weights_init_spread_matches_jax_on_mobilevit(init_type):
    jax_blocks, params, entries = mv_spreads(init_type)
    layers = {}
    for path, coll, key, tf, *idx in entries:
        if coll == "params" and path[0] == "backbone" \
                and path[1] in MV_BLOCKS:
            layers.setdefault(path, []).append((idx[0] if idx else 0, key))
    checked = stacked = 0
    for path, keys in layers.items():
        want = np.asarray(leaf(jax_blocks, path[1:]))
        if path[-1] != "kernel" or want.ndim < 3 or want.size < 4096:
            continue
        ws = [params[k].numpy() for _, k in sorted(keys)]
        got = np.concatenate([w.ravel() for w in ws])
        assert got.size == want.size, path
        assert abs(got.std() / want.std() - 1) < 0.1, (path, got.std(),
                                                        want.std())
        checked += 1
        if len(ws) > 1:
            stacked += 1
            if init_type == "orthogonal":
                # torch [out, in] a layer -> [out, depth * in]; JAX's
                # [depth, in, out] -> [depth * in, out]
                m = np.concatenate(ws, axis=1)
                k = want.reshape(-1, want.shape[-1])
                for a in (m, k.T):
                    g = a @ a.T if a.shape[0] <= a.shape[1] else a.T @ a
                    np.testing.assert_allclose(g, GAIN ** 2 * np.eye(len(g)),
                                               atol=1e-5, err_msg=str(path))
    assert checked >= 8 and stacked == 4


def test_cli_trains_sppf_and_refuses_no_point_cloud(tmp_path):
    tree = write_tree(str(tmp_path / "ws"), frames=4, size=(96, 54),
                      points=40)
    argv = ["--data_root", tree, "--device", "cpu", "--bf16", "false",
            "--resolution", str(RES), "--pc_num", "64", "--bs", "2",
            "--epoch", "1", "--eval_period", "5", "--save_period", "5",
            "--log_dir", str(tmp_path / "logs")]
    state = cli.main(argv + ["--spp", "false"])
    assert state.epoch == 1 and state.step == 1
    assert type(state.model.image_radar_encoder.fpn.spp).__name__ == "SPPF"
    with pytest.raises(SystemExit):
        cli.main(argv + ["--is_pc", "false"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_step_is_finite(name):
    cfg = port_config(name)
    tcfg = tts.TrainConfig(batch_size=BATCH, max_gt=MAX_GT)
    state = tts.create_train_state(create_model(cfg, "cpu", train=True),
                                   cfg, tcfg)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    batch = synthetic_batch(cfg, BATCH, MAX_GT, seed=1, device="cpu")
    state, metrics = tts.make_train_step(cfg, tcfg)(state, batch, 0.01)
    vals = {k: float(v) for k, v in metrics.items()}
    assert vals["skipped_nonfinite"] == 0.0, vals
    assert all(np.isfinite(list(vals.values()))), vals
    assert state.step == 1
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) > 0.9 * len(before)
