"""The plain versions of the port's two CUDA kernels against the JAX Pallas
kernels they replace, on the CPU.

  K1 fused_radarconv  vs  pallas_fused_radarconv      (interpret mode)
  K2 deform_samples   vs  pallas_deform_samples_cfio  (interpret mode)

Inputs come from numpy seeds; float32; tolerance 1e-5, that of the JAX
kernel tests.  Offsets cover every tier of the TPU kernels (zero, |o| <= 1,
<= 2, the full band, and clipped beyond it).  The Pallas interpreter
compiles each kernel shape once per process (about 20 s for the C = 3 K1
and 8 s per K2 shape on a CPU core); the C = 8 K1 interpret program takes
about 70 s, so at C = 8 the plain K1 is held against
`fused_radarconv_reference`, the XLA composition that the JAX suite holds
the C = 8 Pallas kernel to (tests/test_fused_radarconv.py).

The kernels themselves run only on a GPU: tests/test_torch_port_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.ops.deform import deform_conv2d as jax_deform_conv2d
from achelous_tpu.ops.deform import fused_radarconv_reference as jax_fused_ref
from achelous_tpu.ops.pallas_deform import (pallas_deform_samples_cfio,
                                            pallas_fused_radarconv)

from achelous_tpu_torch.ops import deform, hopper_deform

BAND = 4
TOL = dict(rtol=1e-5, atol=1e-5)

# one compiled interpreter program per shape, shared by the cases below
_k1_interpret = jax.jit(
    lambda *a: pallas_fused_radarconv(*a, BAND, 3, 3, 1, True, True))
_k2_interpret = jax.jit(
    lambda *a: pallas_deform_samples_cfio(*a, BAND, 3, 3, 1, True))


def k1_case(rng, b=2, h=16, w=24, c=3, cout=3, off_w=0.0, off_b=0.0):
    """Raw input [B,C,H,W] and JAX-layout RadarConv weights; off_w/off_b
    scale the offset conv so its offsets land in a chosen tier."""
    x = rng.randn(b, c, h, w).astype(np.float32)
    ok = (rng.randn(3, 3, c, 18) * off_w).astype(np.float32)
    ob = (rng.randn(18) * off_b).astype(np.float32)
    mk = (rng.randn(3, 3, c, 9) * 0.3).astype(np.float32)
    mb = (rng.randn(9) * 0.3).astype(np.float32)
    wp = (rng.randn(3, 3, c, cout) * 0.2).astype(np.float32)
    return x, ok, ob, mk, mb, wp


def port_k1(x, ok, ob, mk, mb, wp):
    """Plain K1 on JAX-layout weights (HWIO -> OIHW), packed as K1 reads
    them."""
    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    packed = hopper_deform.pack_radarconv_weights(
        oihw(ok), torch.from_numpy(ob), oihw(mk), torch.from_numpy(mb),
        oihw(wp))
    return hopper_deform.fused_radarconv(torch.from_numpy(x), *packed,
                                         BAND).numpy()


@pytest.mark.parametrize("off_w,off_b", [
    (0.0, 0.0),    # zero offsets (the reference's init)
    (0.05, 0.3),   # |o| < 1
    (0.2, 1.5),    # |o| <= 2
    (0.5, 3.0),    # the full band
    (2.0, 8.0),    # beyond the band: clipped
])
def test_k1_plain_matches_pallas(off_w, off_b):
    args = k1_case(np.random.RandomState(int(off_w * 10 + off_b)),
                   off_w=off_w, off_b=off_b)
    np.testing.assert_allclose(port_k1(*args),
                               np.asarray(_k1_interpret(*args)), **TOL)


def test_k1_plain_boundary_zeroing_matches_pallas():
    """Every tap pushed to the band edge: samples past the image border
    read the pooled map's zeros."""
    x, ok, _, mk, mb, wp = k1_case(np.random.RandomState(5))
    ob = np.repeat([[BAND], [-BAND]], 9, 1).reshape(-1).astype(np.float32)
    args = (x, ok, ob, mk, mb, wp)
    np.testing.assert_allclose(port_k1(*args),
                               np.asarray(_k1_interpret(*args)), **TOL)


def test_k1_plain_c8_matches_jax_reference():
    """C = Cout = 8 (RCNet blocks 1-3), several 16-row tiles."""
    x, ok, ob, mk, mb, wp = k1_case(np.random.RandomState(11), b=1, h=64,
                                    w=32, c=8, cout=8, off_w=0.4, off_b=2.0)
    want = jax_fused_ref(jnp.asarray(x.transpose(0, 2, 3, 1)), ok, ob, mk, mb,
                         wp, BAND, 3, 3, 1)
    np.testing.assert_allclose(port_k1(x, ok, ob, mk, mb, wp),
                               np.asarray(want).transpose(0, 3, 1, 2), **TOL)


def k2_case(rng, b=2, c=3, h=13, w=17, scale=2.5):
    x = rng.randn(b, c, h, w).astype(np.float32)
    off = ((rng.rand(b, 18, h, w) * 2 - 1) * scale).astype(np.float32)
    mask = (rng.rand(b, 9, h, w) * 2).astype(np.float32)
    return x, off, mask


@pytest.mark.parametrize("c,scale", [(3, 0.0), (3, 0.7), (3, 1.8), (3, 3.0),
                                     (3, 9.0), (12, 3.0)])
def test_k2_plain_matches_pallas(c, scale):
    x, off, mask = k2_case(np.random.RandomState(int(scale * 10) + c), c=c,
                           scale=scale)
    got = hopper_deform.deform_samples(torch.from_numpy(x),
                                       torch.from_numpy(off),
                                       torch.from_numpy(mask), BAND)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_k2_interpret(x, off, mask)), **TOL)


def test_k2_plain_unbanded_matches_jax_exact_path():
    """band=None samples at the unclipped offset: the JAX exact
    (bilinear-gather) deformable conv, projection included."""
    x, off, mask = k2_case(np.random.RandomState(2), scale=9.0)
    wgt = (np.random.RandomState(3).randn(3, 3, 3, 5) * 0.2).astype(
        np.float32)
    want = jax_deform_conv2d(*(jnp.asarray(a.transpose(0, 2, 3, 1))
                               for a in (x, off, mask)), jnp.asarray(wgt),
                             band=None)
    samples = hopper_deform.deform_samples(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
        None)
    w = torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1)))
    got = torch.einsum("bihw,oi->bohw", samples, deform.projection_matrix(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2), **TOL)


def test_cpu_tensors_take_the_plain_version():
    hopper_deform.reset_launch_counts()
    x, off, mask = (torch.from_numpy(a) for a in
                    k2_case(np.random.RandomState(0)))
    torch.testing.assert_close(
        hopper_deform.deform_samples(x, off, mask, BAND),
        deform.banded_deform_samples(x, off, mask, BAND), rtol=0, atol=0)
    assert hopper_deform.deform_samples.launches == 0
    assert hopper_deform.fused_radarconv.launches == 0


def test_other_devices_raise():
    x = torch.empty(1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        hopper_deform.deform_samples(x, torch.empty(1, 18, 8, 8, device="meta"),
                                     torch.empty(1, 9, 8, 8, device="meta"),
                                     BAND)
