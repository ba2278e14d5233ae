"""The port's other BENCH_SWEEP.json configurations against the JAX package,
on the CPU.

EN-GDF-PN-S1, EN-GDF-PN-S2, EN-GDF-PN-S0 with SPPF (`use_spp=False`),
MV-GDF-PN-S1 and EN-CDF-PN2-S2, each at 64x64, batch 2, float32: one set of
numpy-seeded flax variables runs through JAX's `model.apply` and, carried
across by `weights.state_dict_from_jax`, through the port.  Every output
within rtol 2e-3 / atol 1e-3 (the slice tolerance of
test_torch_port_slice.py).  The entries are `achelous_mapping(...)`'s,
with `pointnet2_entries` for PN2; for MV the backbone's entries come from
`mobilevit_mapping` under the torch prefix of `weights.torch_prefixed`,
which keeps each entry's stack index (JAX's `with_torch_prefix` unpacks
four fields and cannot take the stacked entries).  Also: the backbones' parameter counts equal the
reference's (tests/test_backbones.py), and the config refuses what the
JAX package refuses, with its messages.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.entry import serving_config
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.weights import (pointnet2_entries,
                                        state_dict_from_jax, torch_prefixed)
from test_backbones import GOLDEN_PARAMS
from test_torch_port_slice import BATCH, RES, nchw, random_variables

TOL = dict(rtol=2e-3, atol=1e-3)
BACKBONE = "image_radar_encoder.fpn.backbone."
# name -> (backbone, phi, neck, pc_model, use_spp)
CONFIGS = {
    "EN-GDF-PN-S1": ("en", "S1", "gdf", "pn", True),
    "EN-GDF-PN-S2": ("en", "S2", "gdf", "pn", True),
    "EN-GDF-PN-S0-SPPF": ("en", "S0", "gdf", "pn", False),
    "MV-GDF-PN-S1": ("mv", "S1", "gdf", "pn", True),
    "EN-CDF-PN2-S2": ("en", "S2", "cdf", "pn2", True),
}
OUTPUTS = ("det0", "det1", "det2", "sem", "lane", "pc")


def jax_entries(backbone: str, phi: str, neck: str, pc_model: str) -> list:
    """The transplant entries of a whole model in the port's keys."""
    pn2 = pc_model == "pn2"
    if backbone != "mv":
        out = list(ti.achelous_mapping(phi, backbone, neck, with_pc=not pn2))
    else:
        # the rest of the model from any backbone's mapping, the backbone's
        # own (5-field, stacked) entries prefixed here
        out = [e for e in ti.achelous_mapping(phi, "en", neck,
                                              with_pc=not pn2)
               if e[0][0] != "backbone"]
        out += torch_prefixed(ti.mobilevit_mapping(phi, prefix=("backbone",)),
                              BACKBONE)
    return out + (pointnet2_entries() if pn2 else [])


@functools.lru_cache(maxsize=None)
def run(name: str):
    """One JAX apply and the port's forward on the same variables and
    inputs, for config `name` (shared by the file's tests)."""
    backbone, phi, neck, pc_model, use_spp = CONFIGS[name]
    jcfg = JaxConfig(phi=phi, backbone=backbone, neck=neck,
                     pc_model=pc_model, use_spp=use_spp, resolution=RES,
                     dtype=jnp.float32)
    jmodel = jax_create_model(jcfg)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    pc = rng.rand(BATCH, jcfg.pc_points, jcfg.pc_channels).astype(np.float32)
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, rad, pc),
        seed=1)
    jdet, jsem, jlane, jpc = jax.jit(jmodel.apply)(variables, img, rad, pc)

    cfg = serving_config(torch.float32, RES, backbone, pc_model, phi, neck,
                         use_spp)
    model = create_model(cfg, "cpu")
    sd = state_dict_from_jax(variables, jax_entries(backbone, phi, neck,
                                                    pc_model),
                             model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        pdet, psem, plane, ppc = model(torch.from_numpy(nchw(img)),
                                       torch.from_numpy(rad),
                                       torch.from_numpy(pc))
    want = dict(zip(OUTPUTS, [nchw(d) for d in jdet]
                    + [nchw(jsem), nchw(jlane), np.asarray(jpc)]))
    got = dict(zip(OUTPUTS, [t.numpy() for t in (*pdet, psem, plane, ppc)]))
    return cfg, got, want


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_outputs_match_jax(name, output):
    cfg, got, want = run(name)
    assert cfg.name == name.replace("-SPPF", "")
    assert got[output].shape == want[output].shape
    if output.startswith("det") or output == "pc":
        # not a vacuous match (the seg heads end in a ReLU and may be 0)
        assert np.abs(want[output]).max() > 1e-3
    np.testing.assert_allclose(got[output], want[output], **TOL)


@pytest.mark.parametrize("backbone,phi", [("en", "S1"), ("en", "S2"),
                                          ("mv", "S1")])
def test_backbone_parameter_counts_match_reference(backbone, phi):
    cfg = serving_config(torch.float32, RES, backbone, phi=phi)
    model = create_model(cfg, "cpu")
    n = sum(p.numel() for p in
            model.image_radar_encoder.fpn.backbone.parameters())
    assert n == GOLDEN_PARAMS[(backbone, phi)]


def test_sppf_and_spp_share_parameters():
    """SPPF replaces SPP's parallel pools with serial ones and keeps its
    convs, so one mapping (`_spp`) fills either."""
    shapes = {}
    for use_spp in (True, False):
        model = create_model(serving_config(torch.float32, RES,
                                            use_spp=use_spp), "cpu")
        spp = model.image_radar_encoder.fpn.spp
        shapes[use_spp] = {k: tuple(v.shape)
                           for k, v in spp.state_dict().items()}
        assert type(spp).__name__ == ("SPP" if use_spp else "SPPF")
    assert shapes[True] == shapes[False]


def jax_refusal(kw) -> str:
    """The message of the JAX package's config on the same arguments."""
    with pytest.raises(ValueError) as err:
        JaxConfig(**kw)
    return str(err.value)


@pytest.mark.parametrize("kw,match", [
    # JAX's own constraints, with JAX's messages
    (dict(neck="rdf", backbone="en"), None),
    (dict(neck="rdf", backbone="mv"), None),
    (dict(neck="rdf", backbone="ef"), None),
    (dict(neck="rdf", backbone="ev"), None),
    (dict(neck="rdf", backbone="rv"), None),
    (dict(neck="rdf", backbone="pf"), None),
    (dict(phi="L", backbone="en"), None),
    (dict(phi="L", backbone="mo", neck="rdf"), None),
    (dict(phi="L", backbone="fv"), None),
    (dict(backbone="xx"), "backbone must be one of"),
    (dict(neck="xdf"), "neck must be one of"),
    (dict(resolution=100), "multiple of 32"),
])
def test_config_refuses_what_is_not_ported(kw, match):
    """The port refuses what the JAX package refuses: its two constraints
    (`rdf` only with `mo`/`fv`, `L` only with `ef`) with its messages."""
    if match is None:
        match = re.escape(jax_refusal(kw))
    with pytest.raises(ValueError, match=match):
        AchelousConfig(**kw)
