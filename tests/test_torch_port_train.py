"""The PyTorch port's training slice against the JAX package, on the CPU.

EN-GDF-PN-S0 at 64x64, float32, from the same numpy-seeded inputs:

  * training BatchNorm against `F32BatchNorm` (output, running mean and
    variance) at flax momenta 0.9 and 0.97;
  * `YoloXLoss` and its gradient w.r.t. the head's maps (GTs, an image
    with no GT, identical logits so that SimOTA's costs tie), the
    segmentation, point-cloud and uncertainty losses, MGDA and CAGrad;
  * the gradients of the K1 and K2 autograd Functions (on the CPU their
    forward is the plain version) against `jax.vjp` of the JAX package's
    `fused_radarconv_reference` and `banded_deform_samples`, the functions
    its `custom_vjp`s pull back through, at non-integer offsets and at
    integer ones (K1 at the offset convs' zero initialisation), where the
    two take their slopes at ties;
  * one whole step of JAX `make_train_step` against the port's, with
    `mtl="uncertainty"` and `grad_accum=2` (bs 8): losses, grad_norm, the
    parameter updates, BatchNorm statistics, EMA and log_vars; then a
    second step from the JAX state carried across (momentum trace
    included) by `weights.load_train_state_from_jax`;
  * the optimizer (SGD-Nesterov and Adam) against the JAX package's optax
    chain, and the weight-decay set against JAX's mask through the
    mapping;
  * the synthetic batches, array for array.

Pure-port checks (no JAX): the freeze gate, the non-finite guard,
grad_accum's divisibility check and the checkpoint round trip.

The JAX train step is compiled once (about 90 s on one CPU core): the
module fixture runs it for both steps.  Tolerances are stated with each
comparison.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.data.synthetic import synthetic_batch as jax_synthetic
from achelous_tpu.losses import detection as jdet
from achelous_tpu.losses import multitask as jmt
from achelous_tpu.losses import segmentation as jseg
from achelous_tpu.models.achelous import create_model as jax_create_model
from achelous_tpu.ops.deform import banded_deform_samples as jax_samples
from achelous_tpu.ops.deform import fused_radarconv_reference as jax_fused_ref
from achelous_tpu.ops.norm import F32BatchNorm
from achelous_tpu.train import train_state as jts
from achelous_tpu.utils.torch_import import achelous_mapping

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.synthetic import synthetic_arrays, synthetic_batch
from achelous_tpu_torch.losses import detection as tdet
from achelous_tpu_torch.losses import multitask as tmt
from achelous_tpu_torch.losses import segmentation as tseg
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops import hopper_deform
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.train import checkpoints, train_state as tts
from achelous_tpu_torch.weights import load_train_state_from_jax
from test_torch_port_slice import random_variables

RES, MAX_GT, LR = 64, 8, 0.01
# The whole step runs at bs 8 in 2 micro-batches of 4, on point clouds
# scaled per sample.  The PointNet STNs' fully connected BatchNorms
# normalise [B, C] over a micro-batch, and F32BatchNorm takes the variance
# as E[x^2] - E[x]^2 in float32.  With iid uniform points and micro-batches
# of 2, the samples' max-pooled features nearly coincide in some channels,
# JAX's variance there is cancellation noise
# (the port's two-pass variance is not, ops/norm.py), and the two sides'
# updates of those layers differ by tens of percent.  Frames whose point
# spreads differ, as real radar frames do, and 4 samples a micro-batch keep
# JAX's variance meaningful.
STEP_BATCH = 8
PC_SCALES = np.array([1.0, 3.0, 0.5, 2.0, 1.5, 0.7, 2.5, 1.2], np.float32)
MAPPING = achelous_mapping("S0", "en", "gdf")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def nchw(a):
    return t(np.asarray(a).transpose(0, 3, 1, 2))


def close(got, want, rtol, atol, msg=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# training BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("momentum", [0.9, 0.97])
def test_batchnorm_train_matches_f32batchnorm(momentum, rank):
    """Output and updated running statistics, float32: rtol/atol 1e-5
    (one reduction order apart)."""
    rng = np.random.RandomState(int(momentum * 100) + rank)
    c = 6
    x = (rng.randn(*((4, 5, 7, c) if rank == 4 else (3, c))) * 2 + 0.5
         ).astype(np.float32)
    v = {"params": {"scale": 1 + 0.1 * rng.randn(c), "bias": rng.randn(c)},
         "batch_stats": {"mean": rng.randn(c), "var": rng.rand(c) + 0.5}}
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    bn = F32BatchNorm(use_running_average=False, momentum=momentum)
    want, mut = bn.apply(v, x, mutable=["batch_stats"])

    port = BatchNorm(c, momentum=1.0 - momentum).train()
    port.load_state_dict({"weight": t(v["params"]["scale"]),
                          "bias": t(v["params"]["bias"]),
                          "running_mean": t(v["batch_stats"]["mean"]),
                          "running_var": t(v["batch_stats"]["var"])})
    xt = t(x).movedim(-1, 1).contiguous()
    got = port(xt).movedim(1, -1)
    close(got, want, 1e-5, 1e-5)
    close(port.running_mean, mut["batch_stats"]["mean"], 1e-5, 1e-5)
    close(port.running_var, mut["batch_stats"]["var"], 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def det_case(rng, kind):
    """Head maps (NHWC, 3 levels at 64^2) and padded GTs."""
    k = 7
    maps = [(rng.randn(2, s, s, 5 + k) * 0.5).astype(np.float32)
            for s in (8, 4, 2)]
    boxes = np.zeros((2, MAX_GT, 4), np.float32)
    classes = np.zeros((2, MAX_GT), np.int32)
    mask = np.zeros((2, MAX_GT), bool)
    n = (3, 0) if kind == "no_gt" else (3, 2)
    for i, ni in enumerate(n):
        boxes[i, :ni, :2] = rng.uniform(8, RES - 8, (ni, 2))
        boxes[i, :ni, 2:] = rng.uniform(6, 30, (ni, 2))
        classes[i, :ni] = rng.randint(0, k, ni)
        mask[i, :ni] = True
    if kind == "tied":
        # identical logits: every anchor of a level has the same box
        # offsets and scores, so many SimOTA costs tie
        maps = [np.zeros_like(m) for m in maps]
    return maps, boxes, classes, mask


_jax_det = jax.jit(jax.value_and_grad(
    lambda maps, b, c, m: jdet.YoloXLoss(7)(maps, b, c, m)))


@pytest.mark.parametrize("kind", ["gts", "no_gt", "tied"])
def test_yolox_loss_and_grad_match_jax(kind):
    """Loss rtol 1e-5; gradient w.r.t. the maps rtol 1e-4, atol 1e-6 of
    the largest (float32, other reduction orders)."""
    maps, boxes, classes, mask = det_case(np.random.RandomState(7), kind)
    want, want_g = _jax_det(maps, boxes, classes, mask)
    pmaps = [nchw(m).requires_grad_(True) for m in maps]
    got = tdet.YoloXLoss(7)(pmaps, t(boxes), t(classes), t(mask))
    got.backward()
    close(got, want, 1e-5, 1e-6)
    scale = max(np.abs(np.asarray(g)).max() for g in want_g)
    for p, g in zip(pmaps, want_g):
        close(p.grad, np.asarray(g).transpose(0, 3, 1, 2), 1e-4,
              1e-6 * scale)


def test_simota_ties_break_at_the_lowest_index():
    """With identical logits the port assigns exactly JAX's anchors."""
    maps, boxes, classes, mask = det_case(np.random.RandomState(3), "tied")
    loss = jdet.YoloXLoss(7)
    hw = tuple(m.shape[1:3] for m in maps)
    xs, ys, s = jdet._anchor_geometry(hw, loss.strides)
    flat = np.concatenate([m.reshape(2, -1, 12) for m in maps], 1)
    xy = (flat[..., :2] + np.stack([xs, ys], -1)) * s[:, None]
    wh = np.exp(flat[..., 2:4]) * s[:, None]
    bx = np.concatenate([xy, wh], -1)
    xc, yc = (xs + 0.5) * s, (ys + 0.5) * s
    want = jax.vmap(lambda b, o, c, g, gc, gm: jdet.simota_assign(
        b, o, c, g, gc, gm, xc, yc, s, 7))(
        bx, flat[..., 4], flat[..., 5:], boxes, classes, mask)
    got = tdet.simota_assign(t(bx), t(flat[..., 4]), t(flat[..., 5:]),
                             t(boxes), t(classes), t(mask), t(xc), t(yc),
                             t(s), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_segmentation_pc_and_uncertainty_losses_match_jax():
    """ce, focal, dice (on NCHW logits, ignore index num_classes), the
    point-cloud NLL and the uncertainty weighting: rtol 1e-5."""
    rng = np.random.RandomState(11)
    n_cls = 9
    logits = rng.randn(2, 16, 16, n_cls).astype(np.float32) * 2
    labels = rng.randint(0, n_cls + 1, (2, 16, 16)).astype(np.int32)
    onehot = np.eye(n_cls + 1, dtype=np.float32)[labels]
    weights = rng.rand(n_cls).astype(np.float32) + 0.5
    lt = nchw(logits)
    close(tseg.ce_loss(lt, t(labels), None, n_cls),
          jseg.ce_loss(logits, labels, None, n_cls), 1e-5, 1e-6)
    close(tseg.ce_loss(lt, t(labels), t(weights), n_cls),
          jseg.ce_loss(logits, labels, weights, n_cls), 1e-5, 1e-6)
    close(tseg.focal_loss(lt, t(labels), None, n_cls),
          jseg.focal_loss(logits, labels, None, n_cls), 1e-5, 1e-6)
    close(tseg.dice_loss(lt, t(onehot)), jseg.dice_loss(logits, onehot),
          1e-5, 1e-6)
    logp = np.asarray(jax.nn.log_softmax(rng.randn(2, 32, 8), -1),
                      np.float32)
    pl = rng.randint(0, 8, (2, 32)).astype(np.int32)
    close(tseg.pc_nll_loss(t(logp), t(pl)), jseg.pc_nll_loss(logp, pl),
          1e-5, 1e-6)
    losses = rng.rand(3).astype(np.float32) * 5
    lv = rng.randn(3).astype(np.float32)
    close(tmt.uncertainty_weighted(list(t(losses)), t(lv)),
          jmt.uncertainty_weighted(list(losses), lv), 1e-5, 1e-6)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_mgda_and_cagrad_combine_match_jax(scale):
    """Random task-gradient matrices [4, 300] with some conflict: rtol
    1e-4, atol 1e-5 of the largest value (CAGrad's solve runs in float64
    in the port, float32 in JAX; the scales keep JAX's solve finite)."""
    rng = np.random.RandomState(int(scale))
    g = (rng.randn(4, 300) * scale).astype(np.float32)
    g[1] -= 0.5 * g[0]
    for port, ref in ((tmt.mgda_combine, jmt.mgda_combine),
                      (tmt.cagrad_combine, jmt.cagrad_combine)):
        want = np.asarray(ref(jnp.asarray(g)))
        close(port(t(g)), want, 1e-4, 1e-5 * np.abs(want).max(),
              port.__name__)


# ---------------------------------------------------------------------------
# K1 and K2 gradients
# ---------------------------------------------------------------------------


def _oihw(k):
    return t(np.asarray(k).transpose(3, 2, 0, 1)).requires_grad_(True)


def check_k1_against_jax(x, ok, ob, mk, mb, wp, g):
    """FusedRadarConv (packed weights; the pack's autograd reaches the
    module-layout weights) against jax.vjp of fused_radarconv_reference
    (NHWC / HWIO arrays): every input's gradient, rtol 1e-4, atol 1e-5 of
    its largest value."""
    _, pullback = jax.vjp(lambda *a: jax_fused_ref(*a, 4, 3, 3), x, ok, ob,
                          mk, mb, wp)
    want = pullback(g)
    xt = nchw(x).requires_grad_(True)
    w_off, w_mod, weight = _oihw(ok), _oihw(mk), _oihw(wp)
    b_off, b_mod = t(ob).requires_grad_(True), t(mb).requires_grad_(True)
    packed = hopper_deform.pack_radarconv_weights(w_off, b_off, w_mod, b_mod,
                                                  weight)
    out = hopper_deform.FusedRadarConv.apply(xt, *packed, 4)
    out.backward(nchw(g))
    got = (xt.grad.permute(0, 2, 3, 1), w_off.grad.permute(2, 3, 1, 0),
           b_off.grad, w_mod.grad.permute(2, 3, 1, 0), b_mod.grad,
           weight.grad.permute(2, 3, 1, 0))
    for name, gg, w in zip(("x", "ok", "ob", "mk", "mb", "wproj"), got, want):
        w = np.asarray(w)
        close(gg, w, 1e-4, 1e-5 * np.abs(w).max(), name)


@pytest.mark.parametrize("c,cout,off_b", [(3, 3, 1.5), (8, 8, 6.0)])
def test_k1_function_gradients_match_jax_vjp(c, cout, off_b):
    """Offsets non-integer, some past the band (4)."""
    rng = np.random.RandomState(c)
    x = rng.randn(2, 13, 17, c).astype(np.float32)
    ok = (rng.randn(3, 3, c, 18) * 0.7).astype(np.float32)
    ob = (rng.randn(18) * off_b).astype(np.float32)
    mk = (rng.randn(3, 3, c, 9) * 0.3).astype(np.float32)
    mb = (rng.randn(9) * 0.3).astype(np.float32)
    wp = (rng.randn(3, 3, c, cout) * 0.3).astype(np.float32)
    g = rng.randn(2, 13, 17, cout).astype(np.float32)
    check_k1_against_jax(x, ok, ob, mk, mb, wp, g)


@pytest.mark.parametrize("c", [3, 8])
def test_k1_function_gradients_match_jax_vjp_at_the_initialisation(c):
    """Offset and modulator convs at zero, as create_model starts them:
    every offset is 0, an integer, where the offset gradient takes JAX's
    slopes at ties (ops/deform.py); the offset conv's gradient included."""
    rng = np.random.RandomState(10 + c)
    x = rng.randn(2, 13, 17, c).astype(np.float32)
    zeros = [np.zeros(s, np.float32) for s in ((3, 3, c, 18), (18,),
                                               (3, 3, c, 9), (9,))]
    wp = (rng.randn(3, 3, c, c) * 0.3).astype(np.float32)
    g = rng.randn(2, 13, 17, c).astype(np.float32)
    check_k1_against_jax(x, *zeros, wp, g)


def check_k2_against_jax(x, off, mask, g, band):
    """DeformSamples against jax.vjp of banded_deform_samples: x, offset
    and mask gradients, rtol 1e-4, atol 1e-5 of the largest value."""
    _, pullback = jax.vjp(lambda *a: jax_samples(*a, band, 3, 3), x, off,
                          mask)
    want = pullback(g)
    ins = [nchw(a).requires_grad_(True) for a in (x, off, mask)]
    out = hopper_deform.DeformSamples.apply(*ins, band)
    out.backward(nchw(g))
    for name, p, wg in zip(("x", "offset", "mask"), ins, want):
        wg = np.asarray(wg)
        close(p.grad.permute(0, 2, 3, 1), wg, 1e-4,
              1e-5 * np.abs(wg).max(), name)


def k2_inputs(rng, c=12):
    b, h, w = 2, 11, 14
    x = rng.randn(b, h, w, c).astype(np.float32)
    mask = (rng.rand(b, h, w, 9) * 2).astype(np.float32)
    g = rng.randn(b, h, w, 9 * c).astype(np.float32)
    return x, mask, g, (b, h, w, 18)


@pytest.mark.parametrize("band", [2, 4])
def test_k2_function_gradients_match_jax_vjp(band):
    """Offsets non-integer, some past the band."""
    rng = np.random.RandomState(band)
    x, mask, g, shape = k2_inputs(rng)
    off = ((rng.rand(*shape) * 2 - 1) * (band + 2) + 0.123
           ).astype(np.float32)
    check_k2_against_jax(x, off, mask, g, band)


@pytest.mark.parametrize("offsets", ["zero", "integer", "mixed"])
def test_k2_function_gradients_match_jax_vjp_at_integer_offsets(offsets):
    """Integer offsets inside the band (4), where JAX's hat weights meet
    at ties: all zero (the offset convs' initialisation), integers in
    [-3, 3], and one axis integer while the other is not."""
    rng = np.random.RandomState(20)
    x, mask, g, shape = k2_inputs(rng)
    off = rng.randint(-3, 4, shape).astype(np.float32)
    if offsets == "zero":
        off[:] = 0.0
    elif offsets == "mixed":
        off[..., 1::2] += rng.rand(*shape[:3], 9).astype(np.float32) * 0.9
    check_k2_against_jax(x, off, mask, g, 4)


def test_wrappers_take_the_functions_only_for_a_gradient():
    """With a gradient wanted the wrappers return the Functions' output
    (a grad_fn of theirs); without, the plain forward."""
    rng = np.random.RandomState(0)
    x = t(rng.rand(1, 3, 8, 8).astype(np.float32))
    conv = torch.nn.Conv2d(3, 3, 3)
    packed = hopper_deform.pack_radarconv_weights(
        *(p.detach().requires_grad_(True) for p in
          (torch.zeros(18, 3, 3, 3), torch.zeros(18), torch.zeros(9, 3, 3, 3),
           torch.zeros(9), conv.weight)))
    out = hopper_deform.fused_radarconv(x, *packed, 4)
    assert type(out.grad_fn).__name__ == "FusedRadarConvBackward"
    with torch.no_grad():
        assert hopper_deform.fused_radarconv(x, *packed, 4).grad_fn is None
    off = torch.zeros(1, 18, 8, 8, requires_grad=True)
    out = hopper_deform.deform_samples(x, off, torch.ones(1, 9, 8, 8), 4)
    assert type(out.grad_fn).__name__ == "DeformSamplesBackward"


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class _Tiny(torch.nn.Module):
    """A conv (its kernel decayed, its bias not) and a vector parameter."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.gamma = torch.nn.Parameter(torch.ones(4))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_optimizer_matches_optax(optimizer):
    """Three updates of the port's SGD-Nesterov / Adam with coupled decay
    (rank >= 2 only, log_vars exempt) and the lr applied after the chain,
    against the JAX package's optax chain (`make_optimizer`) on the same
    gradients, then the backbone freeze gate's counterpart: float32,
    rtol 1e-5, atol 1e-7."""
    rng = np.random.RandomState(0)
    tcfg = tts.TrainConfig(optimizer=optimizer)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(t(rng.randn(*p.shape).astype(np.float32)))
    state = tts.create_train_state(model, AchelousConfig(), tcfg)
    names = list(state.trainable())
    jparams = {"model": {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()},
               "log_vars": np.zeros(3, np.float32)}
    opt = jts.make_optimizer(tcfg)
    jstate = opt.init(jparams)
    for lr in (0.01, 0.02, 0.005):
        grads = {n: rng.randn(*state.trainable()[n].shape).astype(np.float32)
                 for n in names}
        jg = {"model": {n: grads[n] for n in jparams["model"]},
              "log_vars": grads["log_vars"]}
        updates, jstate = opt.update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(
            lambda p, u: np.asarray(p + u * np.float32(lr)), jparams, updates)
        tts._apply_update(tcfg, state, state.trainable(),
                          {n: t(g) for n, g in grads.items()}, lr, False)
    for n, p in model.named_parameters():
        close(p, jparams["model"][n], 1e-5, 1e-7, n)
    close(state.log_vars, jparams["log_vars"], 1e-5, 1e-7)
    assert tts.decay_mask(model) == {"conv.weight"}


# ---------------------------------------------------------------------------
# one whole step against JAX
# ---------------------------------------------------------------------------


def jax_state(variables, tcfg):
    """A JAX TrainState on given variables, built as create_train_state
    builds it (without its jit of model.init)."""
    params, stats = variables["params"], variables["batch_stats"]
    opt = jts.make_optimizer(tcfg)
    log_vars = jnp.zeros(3, jnp.float32)
    return jts.TrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=params, log_vars=log_vars, batch_stats=stats,
        opt_state=opt.init({"model": params, "log_vars": log_vars}),
        ema_params=params, ema_batch_stats=stats,
        ema_updates=jnp.zeros((), jnp.int32))


def port_state(jstate, tcfg):
    cfg = AchelousConfig(resolution=RES)
    model = create_model(cfg, "cpu", train=True)
    state = tts.create_train_state(model, cfg, tcfg)
    load_train_state_from_jax(state, jstate, MAPPING)
    return cfg, state


def numpy_state(state):
    """name -> numpy of params, BN stats, EMA, log_vars."""
    out = {f"param/{n}": p.detach().numpy().copy()
           for n, p in state.model.named_parameters()}
    out.update({f"stat/{n}": v.numpy().copy()
                for n, v in state.batch_stats().items()})
    out.update({f"ema/{n}": v.numpy().copy()
                for n, v in state.ema_params.items()})
    out.update({f"ema/{n}": v.numpy().copy()
                for n, v in state.ema_batch_stats.items()})
    out["log_vars"] = state.log_vars.detach().numpy().copy()
    return out


@pytest.fixture(scope="module")
def train_run():
    """JAX: EN-GDF-PN-S0 64^2 float32, random variables (offsets past the
    band), mtl=uncertainty, grad_accum=2, bs 8; two jitted steps (one
    compile).  The port: the same initial state carried across, one step;
    and the JAX state after step 1 carried across, one more step."""
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", resolution=RES)
    jmodel = jax_create_model(jcfg)
    tcfg_j = jts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty", grad_accum=2)
    arrays = jax_synthetic(jcfg, STEP_BATCH, MAX_GT, seed=5)
    arrays["pc"] = arrays["pc"] * PC_SCALES[:, None, None]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            arrays["image"][:2], arrays["radar"][:2],
                            arrays["pc"][:2])
    s0 = jax_state(random_variables(shapes, seed=2), tcfg_j)
    step = jax.jit(jts.make_train_step(jmodel, jcfg, tcfg_j))
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    s1, m1 = step(s0, jbatch, jnp.float32(LR))
    s2, m2 = step(s1, jbatch, jnp.float32(LR))

    tcfg = tts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty", grad_accum=2)
    pstep = tts.make_train_step(AchelousConfig(resolution=RES), tcfg)
    batch = synthetic_batch(AchelousConfig(resolution=RES), STEP_BATCH,
                            MAX_GT, seed=5, device="cpu")
    batch["pc"] = batch["pc"] * torch.from_numpy(PC_SCALES)[:, None, None]
    runs = {}
    for name, start, want_state, want_m in (("step1", s0, s1, m1),
                                            ("step2", s1, s2, m2)):
        _, state = port_state(start, tcfg)
        before = numpy_state(state)
        state, metrics = pstep(state, batch, LR)
        _, ref = port_state(want_state, tcfg)
        runs[name] = dict(before=before, got=numpy_state(state),
                          want=numpy_state(ref), metrics=metrics,
                          want_metrics={k: float(v) for k, v in
                                        want_m.items()},
                          state=state)
    return dict(runs=runs, shapes=shapes, s0=s0)


@pytest.mark.parametrize("run", ["step1", "step2"])
def test_train_step_metrics_match_jax(train_run, run):
    """Every loss and grad_norm, rtol 1e-3 (float32, with discrete
    SimOTA decisions on both sides)."""
    r = train_run["runs"][run]
    assert r["metrics"]["skipped_nonfinite"] == 0.0
    assert r["want_metrics"]["skipped_nonfinite"] == 0.0
    for k in ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
              "grad_norm"):
        close(r["metrics"][k], r["want_metrics"][k], 1e-3, 0, k)


def update_errors(before, got, want):
    """name -> (max |got - want| of the change over the step, its bound).

    The bound is 5e-2 of the tensor's own largest change plus 1e-3 of the
    RMS change over all tensors of its kind (parameters, BN statistics,
    EMA): float32's, not the algorithm's.  Gradients that are sums of
    cancelling terms (the seg decoders', the PointNet STNs' behind their
    batch-of-4 BatchNorms and max-pools) move by percents between two
    float32 summation orders, and biases in front of a train-mode
    BatchNorm have an exact gradient of 0, so their change is rounding
    noise on either side.  A wrong gradient moves a tensor by its own
    size."""
    out = {}
    for kind in ("param/", "stat/", "ema/"):
        keys = [k for k in before if k.startswith(kind)]
        rms = np.sqrt(np.mean(np.concatenate(
            [np.square(want[k] - before[k]).ravel() for k in keys])))
        for k in keys:
            dw, dg = want[k] - before[k], got[k] - before[k]
            out[k] = (np.abs(dg - dw).max(),
                      5e-2 * np.abs(dw).max() + 1e-3 * rms)
    return out


@pytest.mark.parametrize("run", ["step1", "step2"])
def test_train_step_state_matches_jax(train_run, run):
    """Each tensor's change over the step (parameters, BN statistics, EMA,
    log_vars) within its bound of JAX's (`update_errors`)."""
    r = train_run["runs"][run]
    assert set(r["got"]) == set(r["want"])
    errs = update_errors(r["before"], r["got"], r["want"])
    bad = {k: e for k, e in errs.items() if e[0] > e[1]}
    assert not bad, sorted(bad.items())[:10]
    close(r["got"]["log_vars"] - r["before"]["log_vars"],
          r["want"]["log_vars"] - r["before"]["log_vars"], 1e-3, 1e-7)
    assert np.abs(r["got"]["log_vars"]).sum() > 0


def test_weight_decay_set_matches_jax_mask(train_run):
    """The port's decayed parameters are exactly those whose flax leaf
    JAX's `_wd_mask` marks, carried through the mapping."""
    shapes = train_run["shapes"]["params"]
    mask = jts._wd_mask(shapes)
    want = set()
    for path, coll, key, *_ in MAPPING:
        if coll != "params":
            continue
        node = mask
        for p in path:
            node = node[p]
        if node:
            want.add(key)
    got = tts.decay_mask(train_run["runs"]["step1"]["state"].model)
    assert got == want
    assert "image_radar_encoder.fpn.stage_3_lane_seg.cweight" not in got


def test_synthetic_batch_matches_jax():
    """The same draws in the same order: every array equal, image and
    radar channels-first."""
    jcfg = JaxConfig(phi="S0", backbone="en", neck="gdf", resolution=RES)
    want = jax_synthetic(jcfg, 3, MAX_GT, seed=9)
    cfg = AchelousConfig(resolution=RES)
    got = synthetic_batch(cfg, 3, MAX_GT, seed=9, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        if k in ("image", "radar"):
            w = w.transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    for k, w in synthetic_arrays(cfg, 3, MAX_GT, seed=9).items():
        np.testing.assert_array_equal(w, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    cfg = AchelousConfig(resolution=RES)
    batch = synthetic_batch(cfg, 2, MAX_GT, seed=1, device="cpu")
    return cfg, batch


def fresh(cfg, tcfg):
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                         train=True)
    return tts.create_train_state(model, cfg, tcfg)


def test_freeze_gate_holds_the_backbone(small):
    """With freeze_backbone the backbone's parameters keep their values
    and the rest moves; the backbone's momentum trace still moves."""
    cfg, batch = small
    tcfg = tts.TrainConfig(max_gt=MAX_GT)
    state = fresh(cfg, tcfg)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    state, m = tts.make_train_step(cfg, tcfg)(state, batch, LR, True)
    assert m["skipped_nonfinite"] == 0.0
    moved = {n: not torch.equal(p, before[n])
             for n, p in state.model.named_parameters()}
    bb = [n for n in moved if n.startswith(tts.BACKBONE)]
    assert bb and not any(moved[n] for n in bb)
    assert any(v for n, v in moved.items() if not n.startswith(tts.BACKBONE))
    assert any(state.opt_state["trace"][n].abs().sum() > 0 for n in bb)


def test_nonfinite_batch_changes_nothing_but_the_step(small):
    """A NaN in the image: skipped_nonfinite 1, the step counter moves,
    params / optimizer state / BN statistics / EMA equal; the next clean
    batch trains."""
    cfg, batch = small
    tcfg = tts.TrainConfig(max_gt=MAX_GT)
    state = fresh(cfg, tcfg)
    step = tts.make_train_step(cfg, tcfg)
    snap = checkpoints.state_dict(state)
    snap = {k: ({n: v.clone() for n, v in v.items()}
                if k in ("model", "ema_params", "ema_batch_stats") else v)
            for k, v in snap.items()}
    trace = {n: v.clone() for n, v in state.opt_state["trace"].items()}
    poisoned = dict(batch)
    poisoned["image"] = batch["image"].clone()
    poisoned["image"][0, 0, 0, 0] = float("nan")
    state, m = step(state, poisoned, LR)
    assert m["skipped_nonfinite"] == 1.0 and state.step == 1
    assert state.ema_updates == 0
    for n, v in state.model.state_dict().items():
        assert torch.equal(v, snap["model"][n]), n
    for n, v in state.opt_state["trace"].items():
        assert torch.equal(v, trace[n]), n
    for key in ("ema_params", "ema_batch_stats"):
        for n, v in getattr(state, key).items():
            assert torch.equal(v, snap[key][n]), n
    state, m = step(state, batch, LR)
    assert m["skipped_nonfinite"] == 0.0 and state.ema_updates == 1
    assert bool(torch.isfinite(m["loss"]))


def test_grad_accum_and_surgery_reject_what_they_cannot_do(small):
    cfg, batch = small
    tcfg = tts.TrainConfig(max_gt=MAX_GT, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible"):
        tts.make_train_step(cfg, tcfg)(fresh(cfg, tcfg), batch, LR)
    with pytest.raises(NotImplementedError):
        tts.make_train_step(cfg, tts.TrainConfig(mtl="mgda", grad_accum=2))


def test_checkpoint_round_trip_and_rotation(small, tmp_path):
    """save -> restore into a fresh state gives equal tensors and
    counters; periodic checkpoints beyond `keep` are removed."""
    cfg, batch = small
    tcfg = tts.TrainConfig(max_gt=MAX_GT, mtl="uncertainty")
    state = fresh(cfg, tcfg)
    state, _ = tts.make_train_step(cfg, tcfg)(state, batch, LR)
    mgr = checkpoints.CheckpointManager(str(tmp_path), keep=2)
    for epoch in range(4):
        mgr.save_epoch(epoch, state, 1.0, 2.0 - epoch, save_period=1)
    assert len(mgr.periodic()) == 2 and mgr.periodic()[-1].startswith("ep004")
    assert mgr.exists("best_epoch_weights") and mgr.best_metric == -1.0
    other = mgr.restore("last_epoch_weights", fresh(cfg, tcfg))
    assert (other.step, other.ema_updates) == (1, 1)
    a, b = checkpoints.state_dict(state), checkpoints.state_dict(other)
    for key in ("model", "ema_params", "ema_batch_stats"):
        for n, v in a[key].items():
            assert torch.equal(v, b[key][n]), n
    for n, v in a["opt_state"]["trace"].items():
        assert torch.equal(v, b["opt_state"]["trace"][n]), n
    assert torch.equal(a["log_vars"], b["log_vars"])
