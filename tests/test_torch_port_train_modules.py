"""The modules of the port's newly held training configurations in train
mode against their flax counterparts, on the CPU, in float32.

Each module runs at 64x64 (its inputs those a 64x64 image gives it, save
SPPF, below), batch 4, on numpy-seeded flax variables
(`test_torch_port_slice.random_variables`: statistics and norms off 0/1)
carried across by `weights.state_dict_from_jax`:

  * MobileViT-S1, EdgeViT-S0, PoolFormer-S0 and EfficientFormerV2-L
    backbones (the configurations MV-GDF-PN-S1, EV-, PF-GDF-PN-S0 and
    EF-GDF-PN-L); EF-L's 12 Attention4D calls go through K3's autograd
    Function, whose forward on the CPU is the plain version;
  * the `cdf` neck at S2 widths (CSP layers and bottlenecks, EN-CDF-PN2-S2);
  * SPPF (EN-GDF-PN-S0 with `use_spp=False`) on a 16x16 map (the stride-32
    map of a 512x512 image: at 64x64 its 2x2 map makes every pool the
    global maximum);
  * the base-256 DecoupleHead (`nano_head=False`);
  * the reparameterizable configurations' modules in their train form:
    the RepViT-S0 and FastViT-S0 backbones and the `rdf` neck at S0
    widths (RV-GDF-PN-S0, FV-RDF-PN-S0, MO-RDF-PN-S0; MobileOne-S0's
    backbone in the slow test_torch_port_train_steps.py), and each block
    of test_torch_port_backbones.py's FOLDS through `run` there.

For each: the train-mode forward (batch statistics), then `jax.vjp` of
the flax module with a seeded cotangent against torch's backward of the
same cotangent, and the BatchNorm statistics the forward moved.  One
`jax.jit` of the forward and its vjp a module.

Tolerances: outputs and statistics rtol 2e-3 / atol 1e-3 (the slice
tolerance of test_torch_port_slice.py); each gradient (the inputs' and
every parameter's) within GRAD_RTOL of its own largest value plus
GRAD_FLOOR of the largest gradient of the module.  The two forwards
agree to ~1e-6, but that is enough to move a few of the ~1e6 ReLU
inputs of the `cdf` neck's decoders across 0, and each such element
changes its neighbours' gradients by their own size: in that neck the
port's float32 gradients differ from its own float64 ones by up to 0.9 %
of a tensor's largest value, and JAX's by up to 0.8 %, so the two float32
sides by ~1 %.  A bias in front of a train-mode BatchNorm has an exact
gradient of 0, so its computed one is rounding on either side (the
floor).  A wrong gradient moves by its own size.

The `rdf` neck and MobileOne-S0's backbone widen each of those gates by
SPREAD_FLOOR times a spread read in the same run (`run`: both sides
again on the inputs scaled by 1 +- 1e-6 and on the batch reversed).  In
the `rdf` neck's lane decoder a few ReLU inputs lie within ~1e-7 of 0:
on the draw of "RDF-S0 neck, seed 0" the port's float32 gradients are
within 5.3e-5 of the fixed gradient gate of its float64 ones, JAX's
float32 ones 1.9x that gate from JAX's own float64 run, and one ReLU input is
-4.47e-8 in the port's float64 forward and +8.25e-8 in JAX's (whose
bilinear matrices are float32); on other draws, forcing JAX's ReLU signs
on the port brings every gradient to <= 3.4e-4 of the gate.  MobileOne
sums six branches a block: its float32 outputs at this size move by
~1e-3 of their scale against its own float64 ones.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.models.achelous import make_backbone as jax_make_backbone
from achelous_tpu.models.heads import DecoupleHead as JaxDecoupleHead
from achelous_tpu.models.necks import DualFPN as JaxDualFPN
from achelous_tpu.ops.primitives import SPPF as JaxSPPF
from achelous_tpu.utils import torch_import as ti

from achelous_tpu_torch.core.config import WIDTHS, AchelousConfig
from achelous_tpu_torch.models.achelous import make_backbone
from achelous_tpu_torch.models.heads import DecoupleHead
from achelous_tpu_torch.models.necks import DualFPN
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.primitives import SPPF
from achelous_tpu_torch.weights import state_dict_from_jax
from test_torch_port_slice import random_variables
from test_torch_port_train_ef_pn2 import SPREAD_FLOOR

RES, BATCH = 64, 4
TOL = dict(rtol=2e-3, atol=1e-3)
GRAD_RTOL, GRAD_FLOOR = 2e-2, 1e-4
SPPF_HW = 16


def _backbone(backbone, phi):
    jcfg = JaxConfig(phi=phi, backbone=backbone, resolution=RES,
                     dtype=jnp.float32)
    cfg = AchelousConfig(phi=phi, backbone=backbone, resolution=RES)
    return dict(jax=jax_make_backbone(jcfg), port=make_backbone(cfg),
                entries=ti.BACKBONE_MAPPINGS[backbone](phi),
                inputs=[(RES, RES, 3)], call=lambda m, x: m(x))


def _mapping(build):
    m = ti.Mapping()
    build(m)
    return m


def _neck(phi, family):
    w = WIDTHS[phi]
    return dict(jax=JaxDualFPN(num_seg=9, phi=phi, family=family),
                port=DualFPN(9, phi, family=family),
                entries=ti.dualfpn_neck_mapping(phi, family),
                inputs=[(RES // s, RES // s, c)
                        for s, c in zip((4, 8, 16, 32), w)],
                call=lambda m, *f: m.forward_feats(f), jax_tuple=True)


def _sppf():
    c = WIDTHS["S0"][3]
    return dict(jax=JaxSPPF(c), port=SPPF(c, c),
                entries=_mapping(lambda m: ti._spp(m, "spp")),
                prefix="spp.", inputs=[(SPPF_HW, SPPF_HW, c)],
                call=lambda m, x: m(x))


def _head():
    cins = AchelousConfig().det_in_channels
    return dict(jax=JaxDecoupleHead(num_classes=7, nano_head=False),
                port=DecoupleHead(7, cins, nano_head=False),
                entries=ti.decouplehead_mapping(),
                inputs=[(RES // s, RES // s, c)
                        for s, c in zip((8, 16, 32), cins)],
                call=lambda m, *f: m(f), jax_tuple=True)


MODULES = {
    "MV-S1 backbone": lambda: _backbone("mv", "S1"),
    "EV-S0 backbone": lambda: _backbone("ev", "S0"),
    "PF-S0 backbone": lambda: _backbone("pf", "S0"),
    "EF-L backbone": lambda: _backbone("ef", "L"),
    "CDF-S2 neck": lambda: _neck("S2", "cdf"),
    "SPPF": _sppf,
    "base-256 head": _head,
}
# the reparameterizable configurations' modules in their train form
# (RV-GDF-PN-S0, MO-RDF-PN-S0, FV-RDF-PN-S0); MobileOne-S0's backbone,
# whose JAX compile alone takes ~2 min, is held in the slow
# test_torch_port_train_steps.py
REPARAM_MODULES = {
    "RV-S0 backbone": lambda: _backbone("rv", "S0"),
    "FV-S0 backbone": lambda: _backbone("fv", "S0"),
    "RDF-S0 neck": lambda: dict(_neck("S0", "rdf"), spread=True),
    # the draw on which a fixed gate fails: JAX's float32 lane-decoder
    # gradients lie 1.9x that gate from the port's, and 1.9x from JAX's
    # own in float64
    "RDF-S0 neck, seed 0": lambda: dict(_neck("S0", "rdf"), spread=True,
                                        seed=0),
}
SLOW_MODULES = {"MO-S0 backbone": lambda: dict(_backbone("mo", "S0"),
                                               spread=True)}
# each module's seed: its place in this order
ORDER = sorted(MODULES) + list(REPARAM_MODULES) + list(SLOW_MODULES)
BUILD = {**MODULES, **REPARAM_MODULES, **SLOW_MODULES}


def nchw(a):
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    return np.ascontiguousarray(a)


def flat(tree):
    return jax.tree_util.tree_leaves(tree)


def reverse(a):
    return np.ascontiguousarray(np.asarray(a)[::-1])


# the perturbations that read float32's spread (as the slow step test's):
# the inputs scaled by 1 +- 1e-6, the batch reversed (its cotangent too)
PERTURB = ((1 + 1e-6, False), (1 - 1e-6, False), (1.0, True))


@functools.lru_cache(maxsize=None)
def run(name):
    """The module in train mode on both sides: outputs, gradients of the
    inputs and parameters under one seeded cotangent, and the moved
    statistics, each in the port's layout.  Where the module's spec asks
    for it (`spread`), both sides run again on each of PERTURB, and each
    tensor's spread is the most any of them moves it on either side."""
    spec = BUILD[name]()
    seed = spec["seed"] if "seed" in spec else ORDER.index(name)
    rng = np.random.RandomState(seed)
    xs = [rng.randn(BATCH, *s).astype(np.float32) for s in spec["inputs"]]
    jmod = spec["jax"]
    args = (tuple(xs),) if spec.get("jax_tuple") else tuple(xs)
    variables = random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args), seed=10 +
        seed)
    # PoolFormer normalises by GroupNorm alone: no statistics
    params, stats = variables["params"], variables.get("batch_stats", {})

    def f(p, inputs):
        a = (inputs,) if spec.get("jax_tuple") else inputs
        out, mut = jmod.apply({"params": p, "batch_stats": stats}, *a,
                              train=True, mutable=["batch_stats"])
        return flat(out), mut.get("batch_stats", {})

    out_shapes = jax.eval_shape(lambda p, i: f(p, i)[0], params, tuple(xs))
    cot = [rng.randn(*o.shape).astype(np.float32) for o in out_shapes]

    @jax.jit
    def forward_and_vjp(p, inputs, c):
        out, pull, new_stats = jax.vjp(f, p, inputs, has_aux=True)
        gp, gx = pull(c)
        return out, new_stats, gp, gx

    prefix = spec.get("prefix", "")
    port = spec["port"]
    entries = [(e[0], e[1], e[2][len(prefix):], *e[3:])
               for e in spec["entries"]]
    like = port.state_dict()
    sd = state_dict_from_jax(variables, entries, like)
    pnames = {n for n, _ in port.named_parameters()}

    def both_sides(scale=1.0, flip=False):
        """(port, JAX) of outputs, gradients and statistics on the inputs
        scaled by `scale`, the batch reversed if `flip` (and the batch
        rows of the outputs and the input gradients put back)."""
        order = reverse if flip else (lambda a: a)
        inputs = [order(x * np.float32(scale)) for x in xs]
        c = [order(a) for a in cot]
        jout, jstats, jgp, jgx = forward_and_vjp(params, tuple(inputs), c)
        port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        port.zero_grad(set_to_none=True)
        port.train()
        xt = [torch.from_numpy(nchw(x)).requires_grad_() for x in inputs]
        outs = flat(spec["call"](port, *xt))
        loss = sum((o * torch.from_numpy(nchw(a))).sum()
                   for o, a in zip(outs, c))
        loss.backward()
        want = state_dict_from_jax({"params": jgp, "batch_stats": jstats},
                                   entries, like)
        got = (
            [order(o.detach().numpy()) for o in outs],
            # the neck leaves its stride-4 input unused: no gradient, JAX's
            # 0; a parameter that feeds no output (RepViT-S0's last block)
            # gets no .grad, and JAX's gradient there is 0 too
            {**{f"input{i}": order((x.grad if x.grad is not None
                                    else torch.zeros_like(x)).numpy())
                for i, x in enumerate(xt)},
             **{n: (p.grad if p.grad is not None
                    else torch.zeros_like(p)).numpy()
                for n, p in port.named_parameters()}},
            {n: b.numpy().copy() for n, b in port.named_buffers()
             if n.endswith(("running_mean", "running_var"))})
        wanted = (
            [order(nchw(o)) for o in jout],
            {**{f"input{i}": order(nchw(g)) for i, g in enumerate(jgx)},
             **{k: v for k, v in want.items() if k in pnames}},
            {k: v for k, v in want.items() if k not in pnames})
        return got, wanted

    got, want = both_sides()
    spread = None
    if spec.get("spread"):
        def most(a, b):
            return float(np.abs(np.asarray(a) - np.asarray(b)).max())
        spread = [[0.0] * len(got[0]), {k: 0.0 for k in got[1]},
                  {k: 0.0 for k in got[2]}]
        for scale, flip in PERTURB:
            pgot, pwant = both_sides(scale, flip)
            for part in range(3):
                keys = (range(len(got[0])) if part == 0 else got[part])
                for k in keys:
                    spread[part][k] = max(spread[part][k],
                                          most(pgot[part][k], got[part][k]),
                                          most(pwant[part][k], want[part][k]))
    return dict(port=port, out=(got[0], want[0]), grads=(got[1], want[1]),
                stats=(got[2], want[2]), spread=spread)


HELD = sorted(MODULES) + list(REPARAM_MODULES)


def spread_of(r, part, key):
    """SPREAD_FLOOR times the spread of `key` in `part` (0 outputs, 1
    gradients, 2 statistics), or 0 where the module reads none."""
    return 0.0 if r["spread"] is None else \
        SPREAD_FLOOR * r["spread"][part][key]


def check_forward(name):
    r = run(name)
    got, want = r["out"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert np.abs(w).max() > 1e-3, i
        np.testing.assert_allclose(g, w, err_msg=f"output {i}", rtol=TOL[
            "rtol"], atol=TOL["atol"] + spread_of(r, 0, i))


def check_gradients(name):
    r = run(name)
    got, want = r["grads"]
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    bad = {}
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_FLOOR * top \
            + spread_of(r, 1, k)
        if err > bound:
            bad[k] = err / bound
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]


def check_statistics(name):
    r = run(name)
    got, want = r["stats"]
    bns = [m for m in r["port"].modules() if isinstance(m, BatchNorm)]
    assert len(want) == 2 * len(bns) and set(want) == set(got)
    assert bns or name.startswith(("PF", "repcpe"))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + spread_of(r, 2, k))


@pytest.mark.parametrize("name", HELD)
def test_train_forward_matches_flax(name):
    check_forward(name)


@pytest.mark.parametrize("name", HELD)
def test_train_gradients_match_flax_vjp(name):
    check_gradients(name)


@pytest.mark.parametrize("name", HELD)
def test_train_batchnorm_statistics_match_flax(name):
    """The running statistics the train-mode forward moved (PoolFormer has
    none on either side: GroupNorm only)."""
    check_statistics(name)
