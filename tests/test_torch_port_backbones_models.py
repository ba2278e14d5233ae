"""Whole models of the slice's new families against the JAX package's
`model.apply`, on the CPU: EV-GDF-PN-S0, MO-RDF-PN-S0, FV-RDF-PN-S0 here,
EF-GDF-PN-L and EF-GDF-PN-S1 (built since the EF slice, pinned now) in
test_torch_port_backbones.py through this file's `run`, so that the two
files' JAX compiles split about evenly across test workers.  Each at
64x64, batch 2, float32, all six outputs within rtol 2e-3 / atol 1e-3
(the slice tolerance of test_torch_port_slice.py).  One set of
numpy-seeded flax variables (`random_variables`) runs through JAX and,
carried across by `weights.state_dict_from_jax` on `achelous_mapping`'s
entries, through the port.  The JAX run also captures its backbone's
output, which the port's backbone must match too.

MO-RDF-PN-S0 and FV-RDF-PN-S0 also in deploy form: the port's
`create_model(..., deploy=True)` on the same state against JAX's deploy
model on JAX's `reparameterize(variables)`, at the same tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.core.reparam import reparameterize as jax_reparameterize
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.entry import serving_config
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_slice import BATCH, RES, nchw, random_variables

TOL = dict(rtol=2e-3, atol=1e-3)
# name -> (backbone, phi, neck)
CONFIGS = {
    "EV-GDF-PN-S0": ("ev", "S0", "gdf"),
    "MO-RDF-PN-S0": ("mo", "S0", "rdf"),
    "FV-RDF-PN-S0": ("fv", "S0", "rdf"),
    "EF-GDF-PN-L": ("ef", "L", "gdf"),
    "EF-GDF-PN-S1": ("ef", "S1", "gdf"),
}
DEPLOY = ("MO-RDF-PN-S0", "FV-RDF-PN-S0")
# MobileOne-S0 sums six branches of unit scale in each of its 43 blocks
# (4 convs, the 1x1 scale branch, the skip BN): on drawn statistics its
# maps grow to ~1e12, where float32 rounding alone exceeds atol 1e-3.  Its
# backbone's BatchNorm affines (scale and bias) at this strength keep
# them O(1); every branch still carries a share of the output.
BACKBONE_BN_SCALE = {"MO-RDF-PN-S0": 0.5}
OUTPUTS = ("det0", "det1", "det2", "sem", "lane", "pc")


def is_backbone(module, method_name) -> bool:
    return module.name == "backbone" and method_name == "__call__"


@functools.lru_cache(maxsize=None)
def variables_and_inputs(name: str):
    backbone, phi, neck = CONFIGS[name]
    jcfg = JaxConfig(phi=phi, backbone=backbone, neck=neck, resolution=RES,
                     dtype=jnp.float32)
    rng = np.random.RandomState(0)
    img = rng.rand(BATCH, RES, RES, 3).astype(np.float32)
    rad = rng.rand(BATCH, 3, RES, RES).astype(np.float32)
    pc = rng.rand(BATCH, jcfg.pc_points, jcfg.pc_channels).astype(np.float32)
    variables = random_variables(
        jax.eval_shape(jax_create_model(jcfg).init, jax.random.PRNGKey(0),
                       img, rad, pc), seed=1)
    scale = BACKBONE_BN_SCALE.get(name, 1.0)

    def damp(path, v):
        keys = [getattr(k, "key", None) for k in path]
        hit = (keys[:2] == ["params", "backbone"]
               and keys[-2].endswith(("_bn", "rbr_skip")))
        return v * scale if hit else v

    variables = jax.tree_util.tree_map_with_path(damp, variables)
    return jcfg, variables, (img, rad, pc)


@functools.lru_cache(maxsize=None)
def run(name: str, deploy: bool = False):
    """One JAX apply (capturing the backbone's features) and the port's
    forward on the same variables and inputs."""
    jcfg, variables, (img, rad, pc) = variables_and_inputs(name)
    jmodel = jax_create_model(jcfg, deploy=deploy)
    jvars = jax_reparameterize(variables) if deploy else variables
    apply = jax.jit(functools.partial(jmodel.apply,
                                      capture_intermediates=is_backbone))
    (jdet, jsem, jlane, jpc), state = apply(jvars, img, rad, pc)
    jfeats = state["intermediates"]["backbone"]["__call__"][0]

    cfg = serving_config(torch.float32, RES, jcfg.backbone, phi=jcfg.phi,
                         neck=jcfg.neck)
    like = create_model(cfg, "cpu").state_dict()
    sd = state_dict_from_jax(variables, ti.achelous_mapping(
        jcfg.phi, jcfg.backbone, jcfg.neck), like)
    model = create_model(cfg, "cpu", deploy=deploy, state_dict=sd)
    assert model.deploy == deploy
    x = torch.from_numpy(nchw(img))
    with torch.inference_mode():
        pdet, psem, plane, ppc = model(x, torch.from_numpy(rad),
                                       torch.from_numpy(pc))
        pfeats = model.image_radar_encoder.fpn.backbone(x)
    want = dict(zip(OUTPUTS, [nchw(d) for d in jdet]
                    + [nchw(jsem), nchw(jlane), np.asarray(jpc)]))
    got = dict(zip(OUTPUTS, [t.numpy() for t in (*pdet, psem, plane, ppc)]))
    return cfg, got, want, [t.numpy() for t in pfeats], \
        [nchw(f) for f in jfeats]


EF_CONFIGS = ("EF-GDF-PN-L", "EF-GDF-PN-S1")
CASES = ([(n, False) for n in sorted(CONFIGS) if n not in EF_CONFIGS]
         + [(n, True) for n in DEPLOY])


def check_output(name: str, deploy: bool, output: str):
    cfg, got, want, _, _ = run(name, deploy)
    assert cfg.name == name
    assert got[output].shape == want[output].shape
    if output.startswith("det") or output == "pc":
        # not a vacuous match (the seg heads end in a ReLU and may be 0)
        assert np.abs(want[output]).max() > 1e-3
    np.testing.assert_allclose(got[output], want[output], **TOL)


def check_backbone(name: str, deploy: bool):
    _, _, _, got, want = run(name, deploy)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("name,deploy", CASES)
def test_model_outputs_match_jax(name, deploy, output):
    check_output(name, deploy, output)


@pytest.mark.parametrize("name,deploy", CASES)
def test_backbone_features_match_jax(name, deploy):
    check_backbone(name, deploy)
