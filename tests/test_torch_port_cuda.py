"""The port's CUDA kernels against their plain PyTorch versions, on a GPU,
at the shapes the serving paths give them (320x320, batch 1):

  K1 fused_radarconv       RCNet blocks 0-3: C = 3 at 320^2, C = 8 at 160^2, 80^2
                           (packed weights; and ragged 37x53 maps, Cout != C,
                           bands 0, 4, 6; the module's re-pack after copy_)
  K2 deform_samples        RCNet blocks 4-7: C = 12 at 40^2, C = 24 at 20^2
                           (and C 1-40 on ragged maps, bands 0-6 and None,
                           C = 3 at 320^2 unbanded, offsets past the image,
                           an unaligned input; every tile height and G)
  K3 fused_bias_attention  EfficientFormerV2 Attention4D: h = 8, N = 100,
                           dk = 32, dv = 128 (and N = 16 at batch 2; and
                           N up to 400, h 1-8, dk 16-64, dv 8-1024; the 12
                           launches of one EF-GDF-PN-L request)
  K4 farthest_point_sample PointNet++: 512 -> 128 -> 32 -> 8 -> 4 points,
                           indices exactly equal (and N from 1 to 12288 at
                           batch 1 and 3, with ties, masks, no valid point;
                           both cross-warp reductions; the thread limits)

K1's, K2's and K3's autograd Functions (kernel forward, the plain
version's autograd backward) are held against torch.autograd of the plain
versions over bands 0-6 (and None for K2), ragged maps, K3's training and
serving shapes and both dtypes, and a grad-enabled DeformableConv2d and an
EF model's Attention4Ds must give every parameter a gradient.  An eval
after a bf16 training step must run on the new weights.  A PointNet++
training step launches K4 on inputs with no graph.  chip_smoke.py T6's
step of MV-GDF-PN-S1 and EF-GDF-PN-L at batch 2 launches its kernels as
T6 holds them, each launch held against the plain version.  The radar splat on the
card equals the CPU's.  Exported request functions (EN-GDF-PN-S0, and
MO-RDF-PN-S0 in deploy form) hold K1 x4 and K2 x4 as operator nodes and
launch them.

Every test is marked `cuda` and skips where no GPU is visible.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from achelous_tpu_torch.ops import (attention, deform, hopper_attention,
                                    hopper_deform, hopper_pointops, pointops)

BAND = 4
# float32 (TF32 off): other summation orders, ~1e-6 relative per value.
# bf16: both compute in float32 and round the output once (2^-8 relative).
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


# offset regimes of chip_smoke.py: zero, |o| < 1, |o| about 3, beyond the band
OFFSETS = [(0.0, 0.0), (0.05, 0.3), (0.5, 3.0), (2.0, 8.0)]


def k1_args(rng, b, c, cout, h, w, off_w, off_b, device, dtype):
    """Raw input and RadarConv weights (port layout) for one K1 call."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    return (t(rng.rand(b, c, h, w)), t(rng.randn(18, c, 3, 3) * off_w),
            t(rng.randn(18) * off_b), t(rng.randn(9, c, 3, 3) * 0.3),
            t(rng.randn(9) * 0.3), t(rng.randn(cout, c, 3, 3) * 0.2))


def check_k1(args, band, dtype):
    packed = hopper_deform.pack_radarconv_weights(*args[1:])
    before = hopper_deform.fused_radarconv.launches
    got = hopper_deform.fused_radarconv(args[0], *packed, band)
    want = deform.fused_radarconv_reference(*args, band)
    torch.cuda.synchronize()
    assert hopper_deform.fused_radarconv.launches == before + 1
    b, _, h, w = args[0].shape
    assert got.dtype == dtype and got.shape == (b, args[5].shape[0], h, w)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off_w,off_b", OFFSETS)
@pytest.mark.parametrize("c,h", [(3, 320), (8, 160), (8, 80)])
def test_k1_kernel_matches_plain(cuda_device, c, h, off_w, off_b, dtype):
    """The serving shapes (RCNet blocks 0-3), through the packed path."""
    args = k1_args(np.random.RandomState(c + h), 1, c, c, h, h, off_w, off_b,
                   cuda_device, dtype)
    check_k1(args, BAND, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off_w,off_b", OFFSETS)
@pytest.mark.parametrize("band", [0, 4, 6])
@pytest.mark.parametrize("c,cout", [(1, 5), (3, 8), (8, 2), (5, 1)])
def test_k1_kernel_ragged_tiles_and_bands(cuda_device, c, cout, band, off_w,
                                          off_b, dtype):
    """Cout != C, a 37x53 map (no whole 8x8 tile at the right and bottom
    edges, and a width that is not a multiple of the 16-byte copies, so
    the scalar staging path runs), batch 2, bands 0, 4 and 6."""
    args = k1_args(np.random.RandomState(10 * c + cout + band), 2, c, cout,
                   37, 53, off_w, off_b, cuda_device, dtype)
    check_k1(args, band, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off_w,off_b", [(0.05, 0.3), (2.0, 8.0)])
@pytest.mark.parametrize("c,cout,h,w,band", [(5, 2, 250, 283, 6),
                                              (4, 7, 157, 163, 0)])
def test_k1_kernel_large_ragged_maps(cuda_device, c, cout, h, w, band, off_w,
                                     off_b, dtype):
    """Maps large enough for the launch to take its other tilings (16x16
    tiles with 9 taps a thread; 8x8 with 3), with ragged edges."""
    args = k1_args(np.random.RandomState(h), 1, c, cout, h, w, off_w, off_b,
                   cuda_device, dtype)
    check_k1(args, band, dtype)


def test_k1_module_repacks_after_in_place_update(cuda_device):
    """DeformableConv2d packs its weights once; an in-place copy_ of one
    weight on the card (as entry.perturb_deform_convs does) re-packs."""
    torch.manual_seed(0)
    m = deform.DeformableConv2d(8, 8, band=BAND).to(cuda_device)
    x = torch.rand(1, 8, 40, 40, device=cuda_device)
    with torch.inference_mode():
        first = m(x)
    with torch.no_grad():
        m.offset_conv.bias.copy_(torch.full((18,), 1.5))
        m.regular_conv.weight.mul_(-2.0)
    with torch.inference_mode():
        again = m(x)
    want = deform.fused_radarconv_reference(
        x, m.offset_conv.weight, m.offset_conv.bias, m.modulator_conv.weight,
        m.modulator_conv.bias, m.regular_conv.weight, BAND)
    torch.cuda.synchronize()
    assert not torch.allclose(first, again)
    torch.testing.assert_close(again, want, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band", [BAND, None])
@pytest.mark.parametrize("scale", [0.0, 0.7, 9.0])
@pytest.mark.parametrize("c,h", [(12, 40), (24, 20)])
def test_k2_kernel_matches_plain(cuda_device, c, h, scale, band, dtype):
    rng = np.random.RandomState(c)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
            for a in (rng.randn(1, c, h, h),
                      (rng.rand(1, 18, h, h) * 2 - 1) * scale,
                      rng.rand(1, 9, h, h) * 2)]
    before = hopper_deform.deform_samples.launches
    got = hopper_deform.deform_samples(*args, band)
    want = deform.banded_deform_samples(*args, band)
    torch.cuda.synchronize()
    assert hopper_deform.deform_samples.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, 9 * c, h, h)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def check_k2(args, band, dtype):
    before = hopper_deform.deform_samples.launches
    got = hopper_deform.deform_samples(*args, band)
    want = deform.banded_deform_samples(*args, band)
    torch.cuda.synchronize()
    assert hopper_deform.deform_samples.launches == before + 1
    b, c, h, w = args[0].shape
    assert got.dtype == dtype and got.shape == (b, 9 * c, h, w)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (batch, C, H, W, band, offset scale): C of 1, 3, 5, 12, 24, 40 (groups
# of 8, 4, 2, 1 channels that do not divide C), ragged maps (no whole 8x8
# tile at the edges), bands 0-6 and None, offsets far past the image
# (scale 400)
K2_DOMAIN = [(1, 1, 37, 53, 0, 0.7), (2, 3, 37, 53, 1, 3.0),
             (1, 5, 37, 53, 2, 9.0), (1, 12, 1, 70, 3, 3.0),
             (1, 40, 1, 70, None, 9.0), (1, 24, 37, 53, 5, 0.7),
             (1, 40, 20, 20, 6, 9.0), (1, 5, 250, 283, 6, 3.0),
             (1, 3, 250, 283, None, 3.0), (1, 3, 320, 320, None, 9.0),
             (1, 3, 320, 320, None, 400.0), (2, 12, 40, 40, 4, 400.0),
             (1, 24, 20, 20, None, 40.0), (1, 12, 40, 40, 0, 3.0),
             (3, 5, 13, 9, 2, 3.0), (1, 1, 1, 1, None, 3.0),
             (1, 40, 16, 24, 4, 3.0), (2, 24, 20, 20, 6, 400.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K2_DOMAIN)
def test_k2_kernel_domain(cuda_device, case, dtype):
    """The plans the wrapper takes over its domain: groups of 1-8
    channels on 8- and 4-row tiles, banded and band None (among them
    C = 3 at 320^2, the route of reference checkpoints)."""
    b, c, h, w, band, scale = case
    rng = np.random.RandomState(c * h + w)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
            for a in (rng.randn(b, c, h, w),
                      (rng.rand(b, 18, h, w) * 2 - 1) * scale,
                      rng.rand(b, 9, h, w) * 2)]
    check_k2(args, band, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", hopper_deform.SAMPLES_ROWS)
@pytest.mark.parametrize("group", hopper_deform.SAMPLES_GROUPS)
@pytest.mark.parametrize("band", [3, None])
def test_k2_kernel_every_variant(cuda_device, band, group, rows, dtype):
    """Each (tile rows, G) variant on a ragged 21x35 map with C = 5 (no G
    above 1 divides it), band 3 and None, whatever plan
    deform_samples_plan would pick."""
    rng = np.random.RandomState(group + rows)
    b, c, h, w = 2, 5, 21, 35
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
            for a in (rng.randn(b, c, h, w),
                      (rng.rand(b, 18, h, w) * 2 - 1) * 5,
                      rng.rand(b, 9, h, w) * 2)]
    plan = hopper_deform.SamplesPlan(rows, group, 0)
    got = hopper_deform.launch_samples(*args, band, plan)
    want = deform.banded_deform_samples(*args, band)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band", [BAND, None])
def test_k2_kernel_unaligned_input(cuda_device, band, dtype):
    """x one element past an aligned address: the gather reads elements,
    so no alignment is asked of the input."""
    rng = np.random.RandomState(5)
    c, h = 12, 40
    flat = torch.from_numpy(rng.randn(c * h * h + 1).astype(np.float32)).to(
        cuda_device, dtype)
    x = flat[1:].view(1, c, h, h)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    off, mask = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
                 for a in ((rng.rand(1, 18, h, h) * 2 - 1) * 6,
                           rng.rand(1, 9, h, h) * 2))
    check_k2([x, off, mask], band, dtype)


# ---------------------------------------------------------------------------
# gradients: the autograd Functions (kernel forward, plain backward) against
# torch.autograd of the plain versions on the same card inputs
# ---------------------------------------------------------------------------


def grads_of(fn, leaves, g):
    ins = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*ins)
    return out, torch.autograd.grad(out, ins, g)


def check_k1_grads(args, band, dtype):
    """K1's Function through the pack (gradients reach the module-layout
    weights) against the plain version on those weights."""
    def kernel(x, *w):
        packed = hopper_deform.pack_radarconv_weights(*w)
        out = hopper_deform.fused_radarconv(x, *packed, band)
        assert type(out.grad_fn).__name__ == "FusedRadarConvBackward"
        return out

    def plain(x, *w):
        return deform.fused_radarconv_reference(x, *w, band)

    before = hopper_deform.fused_radarconv.launches
    g = torch.randn(args[0].shape[0], args[5].shape[0], *args[0].shape[2:],
                    device=args[0].device).to(dtype)
    got_out, got = grads_of(kernel, args, g)
    want_out, want = grads_of(plain, args, g)
    torch.cuda.synchronize()
    assert hopper_deform.fused_radarconv.launches == before + 1
    torch.testing.assert_close(got_out.float(), want_out.float(), **TOL[dtype])
    for name, a, b in zip(("x", "w_off", "b_off", "w_mod", "b_mod",
                           "weight"), got, want):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype],
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band", range(7))
@pytest.mark.parametrize("c,cout,h,w", [(3, 3, 64, 64), (8, 8, 37, 53),
                                         (5, 2, 29, 31)])
def test_k1_gradients_match_plain_autograd(cuda_device, c, cout, h, w, band,
                                           dtype):
    """Bands 0-6, square and ragged maps, Cout != C, batch 2, offsets
    past the band."""
    args = k1_args(np.random.RandomState(band + c), 2, c, cout, h, w, 2.0,
                   8.0, cuda_device, dtype)
    check_k1_grads(args, band, dtype)


def check_k2_grads(args, band, dtype):
    def kernel(x, off, mask):
        out = hopper_deform.deform_samples(x, off, mask, band)
        assert type(out.grad_fn).__name__ == "DeformSamplesBackward"
        return out

    def plain(x, off, mask):
        return deform.banded_deform_samples(x, off, mask, band)

    before = hopper_deform.deform_samples.launches
    b, c, h, w = args[0].shape
    g = torch.randn(b, 9 * c, h, w, device=args[0].device).to(dtype)
    got_out, got = grads_of(kernel, args, g)
    want_out, want = grads_of(plain, args, g)
    torch.cuda.synchronize()
    assert hopper_deform.deform_samples.launches == before + 1
    torch.testing.assert_close(got_out.float(), want_out.float(), **TOL[dtype])
    for name, a, b in zip(("x", "offset", "mask"), got, want):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype],
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band", list(range(7)) + [None])
@pytest.mark.parametrize("c,h,w", [(12, 40, 40), (24, 20, 20), (5, 37, 53)])
def test_k2_gradients_match_plain_autograd(cuda_device, c, h, w, band,
                                           dtype):
    """Bands 0-6 and None, the training shapes' channels at batch 2 and a
    ragged map, offsets past the band."""
    rng = np.random.RandomState(c + (band or 9))
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
            for a in (rng.randn(2, c, h, w),
                      (rng.rand(2, 18, h, w) * 2 - 1) * 7.3,
                      rng.rand(2, 9, h, w) * 2)]
    check_k2_grads(args, band, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,band", [(8, BAND), (12, BAND), (3, None)])
def test_deformable_conv_params_all_get_gradients(cuda_device, cin, band,
                                                  dtype):
    """A grad-enabled DeformableConv2d on the card (K1 for cin <= 8 with a
    band, else K2) gives its input and every parameter a non-zero
    gradient: before the autograd Functions, the kernels' outputs had no
    grad_fn and all of these were lost."""
    torch.manual_seed(cin)
    m = deform.DeformableConv2d(cin, cin, band=band).to(cuda_device, dtype)
    with torch.no_grad():
        for conv in (m.offset_conv, m.modulator_conv):
            conv.weight.normal_(0, 0.3)
            conv.bias.normal_(0, 0.3)
    x = torch.rand(2, cin, 24, 24, device=cuda_device, dtype=dtype,
                   requires_grad=True)
    fused = hopper_deform.fused_radarconv.launches
    samples = hopper_deform.deform_samples.launches
    m(x).float().square().sum().backward()
    assert (hopper_deform.fused_radarconv.launches - fused,
            hopper_deform.deform_samples.launches - samples) == (
                (1, 0) if m.fused else (0, 1))
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    for name, p in m.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def test_eval_after_a_train_step_sees_the_new_weights(cuda_device):
    """bf16 training form: eval_step, one train step, eval_step again.
    The forward casts the float32 parameters afresh on every call, and a
    fresh cast may land where the last one lay with the same version, so
    a cache keyed on address and version alone would hand K1 the pack of
    the old weights.  The second eval must equal an eval with every
    kernel-argument cache cleared, and differ from the first."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.ops.param_cache import ParamCache
    from achelous_tpu_torch.train import train_state as tts
    cfg = AchelousConfig(resolution=64, dtype=torch.bfloat16)
    tcfg = tts.TrainConfig(max_gt=8)
    state = tts.create_train_state(create_model(cfg, cuda_device, train=True),
                                   cfg, tcfg)
    batch = synthetic_batch(cfg, 2, tcfg.max_gt, seed=1, device=cuda_device)
    evaluate = tts.make_eval_step(cfg, tcfg)
    before = evaluate(state, batch)
    fused = hopper_deform.fused_radarconv.launches
    state, m = tts.make_train_step(cfg, tcfg)(state, batch, 0.01)
    assert m["skipped_nonfinite"] == 0.0
    after = evaluate(state, batch)
    assert hopper_deform.fused_radarconv.launches - fused == 8
    for mod in state.model.modules():
        for v in vars(mod).values():
            if isinstance(v, ParamCache):
                v.clear()
    fresh = evaluate(state, batch)
    assert not torch.equal(before["loss"], after["loss"])
    for k, v in after.items():
        assert torch.equal(v, fresh[k]), k


def test_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(1, 9, 16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="channels"):
        hopper_deform.fused_radarconv(
            x, torch.zeros(9, 81, 4, device=cuda_device),
            torch.zeros(9, 4, device=cuda_device),
            torch.zeros(81, 9, device=cuda_device), BAND)
    with pytest.raises(TypeError, match="float32"):
        hopper_deform.fused_radarconv(
            x[:, :8], *(t.to(torch.bfloat16) for t in
                        hopper_deform.pack_radarconv_weights(
                            torch.zeros(18, 8, 3, 3), torch.zeros(18),
                            torch.zeros(9, 8, 3, 3), torch.zeros(9),
                            torch.zeros(8, 8, 3, 3))), BAND)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_deform.deform_samples(
            x.transpose(2, 3), torch.zeros(1, 18, 16, 16, device=cuda_device),
            torch.zeros(1, 9, 16, 16, device=cuda_device), BAND)


def k3_args(rng, b, h, n, dk, dv, device, dtype):
    """q, k, v, bias, th1_w, th1_b, th2_w, th2_b with non-symmetric head
    mixes."""
    shapes = ((b, h, n, dk), (b, h, n, dk), (b, h, n, dv), (h, n, n),
              (h, h), (h,), (h, h), (h,))
    args = [torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(
        device, dtype) for s in shapes]
    if h > 1:
        assert not torch.equal(args[4], args[4].T)
    return args


def check_k3(args, scale, dtype):
    before = hopper_attention.fused_bias_attention.launches
    got = hopper_attention.fused_bias_attention(*args, scale)
    want = attention.reference_bias_attention(*args, scale)
    torch.cuda.synchronize()
    assert hopper_attention.fused_bias_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[2].shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 100), (2, 16)])
def test_k3_kernel_matches_plain(cuda_device, b, n, dtype):
    args = k3_args(np.random.RandomState(n), b, 8, n, 32, 128, cuda_device,
                   dtype)
    check_k3(args, 32 ** -0.5, dtype)


# (batch, heads, N, dk, dv): every N of 7, 16, 49, 97, 100, 400, h of 1, 3,
# 8, dk of 16, 32, 64 and dv of 8, 40, 128, 1024 at least once; N = 400
# streams its keys in chunks; dk = 20 and dv = 36 take the scalar staging
K3_DOMAIN = [(1, 8, 7, 32, 128), (2, 3, 16, 16, 40), (1, 1, 49, 64, 8),
             (2, 8, 97, 32, 1024), (1, 3, 100, 64, 128), (1, 8, 400, 32, 128),
             (2, 1, 400, 16, 40), (1, 8, 100, 16, 1024), (1, 8, 49, 64, 40),
             (2, 3, 97, 16, 8), (1, 8, 400, 64, 1024), (1, 3, 49, 20, 36)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K3_DOMAIN)
def test_k3_kernel_domain(cuda_device, case, dtype):
    b, h, n, dk, dv = case
    args = k3_args(np.random.RandomState(n + dv), b, h, n, dk, dv,
                   cuda_device, dtype)
    check_k3(args, dk ** -0.5, dtype)


def fps_cases():
    """(name, xyz [B,N,3], npoint, valid): the serving shapes on random
    points, then resampled duplicates, a valid mask, identical points."""
    rng = np.random.RandomState(0)
    cases = [(f"random_{n}_{s}", rng.rand(1, n, 3), s, None)
             for n, s in ((512, 128), (128, 32), (32, 8), (8, 4))]
    base = np.round(rng.rand(60, 3) * 16) / 16
    cases.append(("resampled", base[rng.randint(0, 60, (1, 512))], 128, None))
    cases.append(("valid", rng.randn(2, 512, 3), 128, rng.rand(2, 512) > 0.3))
    cases.append(("identical", np.ones((1, 32, 3)), 8, None))
    return cases


@pytest.mark.parametrize("case", range(7))
def test_k4_kernel_indices_equal_plain(cuda_device, case):
    name, xyz, npoint, valid = fps_cases()[case]
    x = torch.from_numpy(xyz.astype(np.float32)).to(cuda_device)
    v = None if valid is None else torch.from_numpy(valid).to(cuda_device)
    before = hopper_pointops.farthest_point_sample.launches
    got = hopper_pointops.farthest_point_sample(x, npoint, v)
    want = pointops.farthest_point_sample(x, npoint, v)
    torch.cuda.synchronize()
    assert hopper_pointops.farthest_point_sample.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, want), name


def check_k4(xyz, npoint, valid, device):
    x = torch.from_numpy(xyz.astype(np.float32)).to(device)
    v = None if valid is None else torch.from_numpy(valid).to(device)
    before = hopper_pointops.farthest_point_sample.launches
    got = hopper_pointops.farthest_point_sample(x, npoint, v)
    want = pointops.farthest_point_sample(x, npoint, v)
    torch.cuda.synchronize()
    assert hopper_pointops.farthest_point_sample.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, want)


K4_NS = (1, 31, 32, 33, 127, 129, 511, 512, 513, 4096, 12288)
# each N at batch 1 and 3, on random points, coarse coordinates (equal
# distances), duplicates, a valid mask, and the extremes: identical
# points, fewer valid points than npoint, no valid point at all
K4_KINDS = ("random", "coarse", "duplicates", "valid", "identical",
            "few_valid", "none_valid")


def k4_points(rng, kind, b, n):
    valid = None
    if kind == "random":
        xyz = rng.rand(b, n, 3)
    elif kind == "coarse":
        xyz = np.round(rng.rand(b, n, 3) * 4) / 4
    elif kind == "duplicates":
        base = np.round(rng.rand(max(1, n // 8), 3) * 16) / 16
        xyz = base[rng.randint(0, len(base), (b, n))]
    elif kind == "identical":
        xyz = np.full((b, n, 3), 0.5)
    else:
        xyz = rng.randn(b, n, 3)
        valid = rng.rand(b, n) > {"valid": 0.3, "few_valid": 0.97,
                                  "none_valid": 2.0}[kind]
    return xyz, valid


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", K4_NS)
@pytest.mark.parametrize("kind", K4_KINDS)
def test_k4_kernel_domain(cuda_device, kind, n, b):
    """Every points-a-thread variant the plan takes (N up to
    FPS_MAX_POINTS), indices exactly equal to the plain version's."""
    rng = np.random.RandomState(n + b)
    xyz, valid = k4_points(rng, kind, b, n)
    npoint = 4 if n == 1 else min(max(8, n // 4), 128)
    check_k4(xyz, npoint, valid, cuda_device)


@pytest.mark.parametrize("ppt", hopper_pointops.FPS_PPT)
@pytest.mark.parametrize("wide", [False, True])
def test_k4_kernel_every_variant(cuda_device, ppt, wide):
    """Each points-a-thread variant at one warp and at its most threads
    (FPS_MAX_THREADS, which the kernel must take), with N a few points
    short of filling them, on a valid mask, whatever plan fps_plan would
    pick."""
    threads = hopper_pointops.FPS_MAX_THREADS[ppt] if wide else 32
    n = min(threads * ppt, hopper_pointops.FPS_MAX_POINTS) - 3
    rng = np.random.RandomState(ppt + threads)
    x = torch.from_numpy(rng.rand(2, n, 3).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.rand(2, n) > 0.2).to(cuda_device)
    got = hopper_pointops.launch_fps(x, 64, v, (threads, ppt))
    want = pointops.farthest_point_sample(x, 64, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("ppt", hopper_pointops.FPS_PPT)
def test_k4_thread_limits_match_the_kernel(cuda_device, ppt):
    """csrc/pointops.cu fps_max_threads refuses one warp more than
    FPS_MAX_THREADS gives a variant."""
    x = torch.rand(1, 64, 3, device=cuda_device)
    with pytest.raises(RuntimeError):
        hopper_pointops.launch_fps(
            x, 8, None, (hopper_pointops.FPS_MAX_THREADS[ppt] + 32, ppt))


@pytest.mark.parametrize("tree", [True, False])
@pytest.mark.parametrize("threads,ppt", [(64, 8), (96, 4), (128, 4)])
@pytest.mark.parametrize("kind", ["random", "coarse", "valid"])
def test_k4_cross_warp_reductions(cuda_device, kind, threads, ppt, tree):
    """Blocks of 2-4 warps take the cross-warp winner by the compare tree
    or by redux.sync: indices equal the plain version's either way."""
    rng = np.random.RandomState(threads + ppt)
    xyz, valid = k4_points(rng, kind, 2, threads * ppt - 5)
    x = torch.from_numpy(xyz.astype(np.float32)).to(cuda_device)
    v = None if valid is None else torch.from_numpy(valid).to(cuda_device)
    got = hopper_pointops.launch_fps(x, 96, v, (threads, ppt), tree)
    want = pointops.farthest_point_sample(x, 96, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k3_k4_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 9, 16, 32, device=cuda_device)
    v = torch.zeros(1, 9, 16, 128, device=cuda_device)
    mix = (torch.zeros(9, 9, device=cuda_device),
           torch.zeros(9, device=cuda_device)) * 2
    with pytest.raises(ValueError, match="h <= 8"):
        hopper_attention.fused_bias_attention(
            q, q, v, torch.zeros(9, 16, 16, device=cuda_device), *mix, 0.1)
    q8 = torch.zeros(1, 8, 16, 32, device=cuda_device)
    with pytest.raises(TypeError, match="must be torch.float32"):
        hopper_attention.fused_bias_attention(
            q8, q8, torch.zeros(1, 8, 16, 128, device=cuda_device),
            torch.zeros(8, 16, 16, device=cuda_device, dtype=torch.bfloat16),
            *((torch.zeros(8, 8, device=cuda_device),
               torch.zeros(8, device=cuda_device)) * 2), 0.1)
    with pytest.raises(TypeError, match="float32"):
        hopper_pointops.farthest_point_sample(
            torch.zeros(1, 64, 3, device=cuda_device, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="valid"):
        hopper_pointops.farthest_point_sample(
            torch.zeros(1, 64, 3, device=cuda_device), 8,
            torch.ones(1, 64, device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(32, 100), (1, 100), (2, 16)])
def test_k3_function_gradients_match_plain_autograd(cuda_device, b, n,
                                                    dtype):
    """FusedBiasAttention at EF's training shape (batch 32) and the serving
    ones: the output and all eight inputs' gradients."""
    rng = np.random.RandomState(b + n)
    args = k3_args(rng, b, 8, n, 32, 128, cuda_device, dtype)
    g = torch.randn(b, 8, n, 128, device=cuda_device).to(dtype)

    def grads(fn):
        ins = [a.detach().clone().requires_grad_(True) for a in args]
        out = fn(*ins, 32 ** -0.5)
        return out, torch.autograd.grad(out, ins, g)
    before = hopper_attention.fused_bias_attention.launches
    got_out, got = grads(hopper_attention.fused_bias_attention)
    assert hopper_attention.fused_bias_attention.launches == before + 1
    want_out, want = grads(attention.reference_bias_attention)
    torch.testing.assert_close(got_out.float(), want_out.float(),
                               **TOL[dtype])
    for i, (a, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(a.float(), w.float(), **TOL[dtype],
                                   msg=f"grad {i}")


def test_ef_attention_params_all_get_gradients(cuda_device):
    """EF-GDF-PN-S0 at 64^2, bf16 compute on float32 parameters: one
    backward through 4 K3 launches gives every parameter of every
    Attention4D a gradient, nonzero for those it reaches only through K3
    (`chip_smoke.K3_GRADIENT`).  Before K3's Function, the
    q and k conv-BNs, the bias tables and both head mixes got none."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.models.achelous import create_model, forward_compute
    from chip_smoke import K3_GRADIENT
    cfg = AchelousConfig(resolution=64, backbone="ef", dtype=torch.bfloat16)
    model = create_model(cfg, cuda_device, train=True)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("attention_biases", "layer_scale_1")):
                p.normal_(0, 0.1)
    x = torch.rand(2, 3, 64, 64, device=cuda_device)
    before = hopper_attention.fused_bias_attention.launches
    det, sem, lane, pc = forward_compute(model, x, x,
                                         torch.rand(2, 512, 5,
                                                    device=cuda_device))
    assert hopper_attention.fused_bias_attention.launches == before + 4
    sum(o.float().square().mean() for o in det).backward()
    params = {n: p for n, p in model.named_parameters()
              if ".token_mixer." in n}
    assert len(params) == 2 * 25 + 2 * 29
    for n, p in params.items():
        assert p.grad is not None, n
        if n.endswith(K3_GRADIENT):
            assert bool(p.grad.abs().sum() > 0), n


def test_pn2_train_step_launches_fps(cuda_device):
    """EN-GDF-PN2-S0 at 64^2, float32 and bf16: a training step launches K4
    4 times (its inputs carry no graph), and its metrics are finite."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.train import train_state as tts
    for dtype in (torch.float32, torch.bfloat16):
        cfg = AchelousConfig(resolution=64, pc_model="pn2", dtype=dtype)
        tcfg = tts.TrainConfig(max_gt=8)
        state = tts.create_train_state(
            create_model(cfg, cuda_device, train=True), cfg, tcfg)
        batch = synthetic_batch(cfg, 4, 8, seed=2, device=cuda_device)
        before = hopper_pointops.farthest_point_sample.launches
        state, m = tts.make_train_step(cfg, tcfg)(state, batch, 0.01)
        assert hopper_pointops.farthest_point_sample.launches == before + 4
        assert m["skipped_nonfinite"] == 0.0
        assert all(bool(torch.isfinite(torch.as_tensor(v))) for v in
                   m.values())


@pytest.mark.parametrize("label", ["MV-GDF-PN-S1", "EF-GDF-PN-L"])
def test_t6_train_step_launches_match_plain(cuda_device, label):
    """chip_smoke.py T6's step at batch 2: one bf16 step of MV-GDF-PN-S1
    (K1 x4, K2 x4) or EF-GDF-PN-L (K1 x1, K2 x7, K3 x12) at 320x320, its
    launches as in T6_PATHS, each held against the plain version on its
    own inputs, the metrics finite."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from chip_smoke import T6_PATHS, train_path
    fields, want = {k: (f, w) for k, f, w in T6_PATHS}[label]
    cfg = AchelousConfig(dtype=torch.bfloat16, **fields)
    _, counts = train_path(cuda_device, "T6", label, cfg, want, 1, batch=2)
    assert counts == want


@pytest.mark.parametrize("label", ["RV-GDF-PN-S0", "MO-RDF-PN-S0",
                                   "FV-RDF-PN-S0"])
def test_t7_trained_ema_folds_on_the_card(cuda_device, label):
    """chip_smoke.py T7 at batch 2: one bf16 step of the train form (K1
    x4, K2 x4, each launch held against the plain version), its EMA
    folded in float32 on the card and held against the train form's eval
    output within DEPLOY_TOL of each output's scale, and against itself
    on the CPU within FLOAT32_PATH_TOL."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from chip_smoke import (FLOAT32_PATH_TOL, T7_PATHS, deploy_against_train,
                            train_path)
    fields, want = {k: (f, w) for k, f, w, _ in T7_PATHS}[label]
    cfg = AchelousConfig(dtype=torch.bfloat16, **fields)
    ema = {}
    _, counts = train_path(cuda_device, "T7", label, cfg, want, 1, batch=2,
                           ema=ema)
    assert counts == want
    deploy_against_train(cuda_device, f"T7 {label}", cfg, ema,
                         cpu_tol=FLOAT32_PATH_TOL)


def test_radar_splat_on_the_card_equals_the_cpu(cuda_device):
    """splat_radar_fast's scatter-max order on the card: the same maps as
    on the CPU, with repeated cells, points outside the frame and padding
    rows; the exact splat too."""
    from achelous_tpu_torch.ops.radar_splat import (splat_radar_fast,
                                                    splat_radar_points)
    rng = np.random.RandomState(0)
    p = np.zeros((4, 512, 5), np.float32)
    p[..., :3] = rng.randn(4, 512, 3)
    p[..., 3] = rng.uniform(-100, 2000, (4, 512))
    p[..., 4] = rng.uniform(-50, 1100, (4, 512))
    p[:, :200, 3] = rng.choice([60.0, 61.0, 600.0], (4, 200))
    p[:, :200, 4] = rng.choice([34.0, 300.0], (4, 200))
    valid = torch.from_numpy(rng.rand(4, 512) > 0.1)
    pts = torch.from_numpy(p)
    want = splat_radar_fast(pts, valid)
    got = splat_radar_fast(pts.to(cuda_device), valid.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(splat_radar_points(pts[0].to(cuda_device),
                                          valid[0].to(cuda_device)).cpu(),
                       splat_radar_points(pts[0], valid[0]))


# The kernels as custom operators (torch.library): opcheck's schema, fake
# tensor and AOT-dispatch checks at the serving shapes.  The operators carry
# no autograd registration of their own (the autograd Functions around them
# give the gradients, held above), so opcheck's autograd-registration check,
# which needs inputs that ask for a gradient, is not among them.
OPCHECK = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")


def op_cases(device):
    rng = np.random.RandomState(11)
    x, *w = k1_args(rng, 1, 8, 8, 80, 80, 0.5, 3.0, device, torch.bfloat16)
    k1 = (x, *(t.float() for t in hopper_deform.pack_radarconv_weights(*w)),
          BAND)
    k2x = torch.rand(1, 12, 40, 40, device=device, dtype=torch.bfloat16)
    off = (torch.rand(1, 18, 40, 40, device=device) * 6 - 3).bfloat16()
    mask = torch.rand(1, 9, 40, 40, device=device).bfloat16()
    k3 = (*k3_args(rng, 1, 8, 100, 32, 128, device, torch.bfloat16), 32 ** -0.5)
    xyz = torch.rand(1, 512, 3, device=device)
    return {"fused_radarconv": k1,
            "deform_samples": (k2x, off, mask, BAND),
            "deform_samples band None": (k2x, off, mask, None),
            "fused_bias_attention": k3,
            "farthest_point_sample": (xyz, 128, None),
            "farthest_point_sample valid": (xyz, 128,
                                            torch.rand(1, 512,
                                                       device=device) > 0.2)}


@pytest.mark.parametrize("case", ["fused_radarconv", "deform_samples",
                                  "deform_samples band None",
                                  "fused_bias_attention",
                                  "farthest_point_sample",
                                  "farthest_point_sample valid"])
def test_custom_ops_pass_opcheck(cuda_device, case):
    args = op_cases(cuda_device)[case]
    op = getattr(torch.ops.achelous, case.split()[0])
    torch.library.opcheck(op, args, test_utils=OPCHECK)


def test_exported_program_launches_the_kernels(cuda_device, tmp_path):
    """EN-GDF-PN-S0's request function (bf16, batch 1) exported on the
    card: its graph holds K1 x4 and K2 x4 as operator nodes, the program
    torch.export.load returns launches them, and its outputs equal the
    eager request function's (each within one bf16 step)."""
    from achelous_tpu_torch import predict
    from achelous_tpu_torch.entry import serving_config

    check_export(predict.AchelousPredictor(serving_config(),
                                           device=cuda_device), tmp_path)


def test_exported_deploy_program_launches_the_kernels(cuda_device, tmp_path):
    """MO-RDF-PN-S0 in deploy form (every MobileOne and RepVGG block one
    conv): exported as above, K1 x4 and K2 x4 as operator nodes, launched,
    outputs equal eager's."""
    from achelous_tpu_torch import predict
    from achelous_tpu_torch.entry import serving_config

    cfg = serving_config(backbone="mo", neck="rdf")
    pred = predict.AchelousPredictor(cfg, deploy=True, device=cuda_device)
    assert pred.model.deploy
    check_export(pred, tmp_path)


def test_attention_kernel_on_an_ef_l_request(cuda_device):
    """One EF-GDF-PN-L request (320x320, bf16, batch 1) launches K3 12
    times (6 attention blocks in each of stages 2 and 3, N = 100); each
    launch's inputs give the plain version's result, in bf16 and again in
    float32."""
    from achelous_tpu_torch.entry import entry, perturb_attention

    fn, _ = entry(cuda_device, backbone="ef", phi="L")
    perturb_attention(fn.model)
    records = []
    launch = hopper_attention._attention_forward

    def record(*args):
        records.append([a.detach().clone() if torch.is_tensor(a) else a
                        for a in args])
        return launch(*args)

    rng = np.random.RandomState(13)
    args = [torch.from_numpy(rng.rand(*s).astype(np.float32))
            .to(cuda_device, torch.bfloat16)
            for s in ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5))]
    before = hopper_attention.fused_bias_attention.launches
    hopper_attention._attention_forward = record
    try:
        fn(*args)
    finally:
        hopper_attention._attention_forward = launch
    torch.cuda.synchronize()
    assert hopper_attention.fused_bias_attention.launches - before == 12
    assert len(records) == 12
    for *ts, scale in records:
        assert tuple(ts[0].shape) == (1, 8, 100, 32)
        for dt in (torch.bfloat16, torch.float32):
            a = [t.to(dt) for t in ts]
            torch.testing.assert_close(
                launch(*a, scale),
                attention.reference_bias_attention(*a, scale), **TOL[dt])


def check_export(pred, tmp_path):
    """`pred`'s request function exported: K1 x4 and K2 x4 operator nodes,
    launched when the loaded program runs, its outputs within one bf16
    step of the eager request function's."""
    from achelous_tpu_torch import predict
    from achelous_tpu_torch.entry import perturb_deform_convs

    perturb_deform_convs(pred.model)
    path = predict.export_program(pred, str(tmp_path / "p.pt2"))
    nodes = {"fused_radarconv": 4, "deform_samples": 4}
    assert predict.kernel_nodes(path) == nodes
    program = predict.load_program(path)
    rng = np.random.RandomState(12)
    args = tuple(torch.from_numpy(rng.rand(*t.shape).astype(np.float32))
                 .to(pred.device, t.dtype)
                 for t in predict.example_request(pred.cfg, pred.device))
    want = torch.utils._pytree.tree_leaves(pred.infer(*args))
    k1, k2 = hopper_deform.fused_radarconv, hopper_deform.deform_samples
    before = k1.launches, k2.launches
    with torch.inference_mode():
        got = torch.utils._pytree.tree_leaves(predict.unpack(program(*args)))
    torch.cuda.synchronize()
    assert (k1.launches - before[0], k2.launches - before[1]) == (4, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -7,
                                       atol=0)
        else:
            assert torch.equal(g, w)
