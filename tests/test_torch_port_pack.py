"""K1's packed weights and the port's per-module kernel-argument caches,
on the CPU (no JAX; each case well under a second).

  pack_radarconv_weights   the tap-major layout csrc/deform.cu reads, and
                           its inverse
  DeformableConv2d         packs once, re-packs after an in-place update,
                           load_state_dict or a cast
  ParamCache               never takes a tensor made afresh for the last one
  Attention4D              gathers and rounds the bias table and head mixes
                           once, again after the same changes
"""
import numpy as np
import pytest
import torch

from achelous_tpu_torch.models.efficientformer import Attention4D
from achelous_tpu_torch.ops import deform, hopper_deform
from achelous_tpu_torch.ops.param_cache import ParamCache

BAND = 4


def radarconv_weights(rng, c, cout):
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return t(18, c, 3, 3), t(18), t(9, c, 3, 3), t(9), t(cout, c, 3, 3)


def test_pack_is_tap_major_and_unpacks_to_the_conv_weights():
    c, cout = 3, 5
    w_off, b_off, w_mod, b_mod, weight = radarconv_weights(
        np.random.RandomState(0), c, cout)
    wconv, bconv, wproj = hopper_deform.pack_radarconv_weights(
        w_off, b_off, w_mod, b_mod, weight)
    assert wconv.shape == (9, 9 * c, 4) and bconv.shape == (9, 4)
    assert wproj.shape == (9 * c, cout)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (wconv, bconv, wproj))
    for ki in range(9):
        assert bconv[ki].tolist() == [b_off[2 * ki].item(),
                                      b_off[2 * ki + 1].item(),
                                      b_mod[ki].item(), 0.0]
        for ky in range(3):
            for kx in range(3):
                for ci in range(c):
                    row = (ky * 3 + kx) * c + ci
                    assert wconv[ki, row].tolist() == [
                        w_off[2 * ki, ci, ky, kx].item(),
                        w_off[2 * ki + 1, ci, ky, kx].item(),
                        w_mod[ki, ci, ky, kx].item(), 0.0]
                    # the projection's rows: tap (ky, kx), then channel
                    assert torch.equal(wproj[row], weight[:, ci, ky, kx])
    for got, want in zip(hopper_deform.unpack_radarconv_weights(
            wconv, bconv, wproj), (w_off, b_off, w_mod, b_mod, weight)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_cpu_path_equals_the_plain_radarconv(dtype):
    """On the CPU, K1 through packed weights is exactly the plain version
    on the unpacked ones."""
    rng = np.random.RandomState(1)
    ws = [w.to(dtype) for w in radarconv_weights(rng, 4, 2)]
    x = torch.from_numpy(rng.rand(2, 4, 11, 13).astype(np.float32)).to(dtype)
    got = hopper_deform.fused_radarconv(
        x, *hopper_deform.pack_radarconv_weights(*ws), BAND)
    torch.testing.assert_close(
        got, deform.fused_radarconv_reference(x, *ws, BAND), rtol=0, atol=0)


def module_weights(m):
    return (m.offset_conv.weight, m.offset_conv.bias, m.modulator_conv.weight,
            m.modulator_conv.bias, m.regular_conv.weight)


def test_deform_conv_repacks_when_a_parameter_changes():
    torch.manual_seed(0)
    m = deform.DeformableConv2d(3, 5, band=BAND)
    x = torch.rand(1, 3, 9, 10)
    with torch.no_grad():
        first = m.packed_weights()
        assert m.packed_weights() is first            # cached
        out = m(x)
        torch.testing.assert_close(out, deform.fused_radarconv_reference(
            x, *module_weights(m), BAND), rtol=0, atol=0)
        m.offset_conv.bias.copy_(torch.full((18,), 2.5))   # in place
        second = m.packed_weights()
        assert second is not first
        assert torch.equal(second[1][:, 0], torch.full((9,), 2.5))
        other = deform.DeformableConv2d(3, 5, band=BAND)
        m.load_state_dict(other.state_dict())
        for got, want in zip(m.packed_weights(),
                             hopper_deform.pack_radarconv_weights(
                                 *module_weights(other))):
            assert torch.equal(got, want)
        m.to(torch.bfloat16)                             # a cast
        for got, want in zip(m.packed_weights(),
                             hopper_deform.pack_radarconv_weights(
                                 *module_weights(m))):
            assert torch.equal(got, want)


def test_deform_conv_never_caches_for_a_gradient():
    m = deform.DeformableConv2d(2, 2, band=BAND)
    a, b = m.packed_weights(), m.packed_weights()
    assert a is not b and a[0].requires_grad
    with torch.inference_mode():
        m.packed_weights()
    out = m(torch.rand(1, 2, 6, 6))                 # after an inference pack
    out.sum().backward()
    assert m.regular_conv.weight.grad is not None


def test_cache_rebuilds_for_tensors_made_afresh():
    """A tensor made afresh on every call (the training form's casts of
    float32 parameters) has version 0 and may lie where the last one lay:
    the cache must not take it for the last one."""
    arr = np.zeros(4, np.float32)
    cache = ParamCache()

    def get():
        fresh = torch.from_numpy(arr)      # same address, version 0
        return cache.get([fresh], lambda: fresh.clone())

    assert float(get().sum()) == 0.0
    arr += 1.0
    assert float(get().sum()) == 4.0
    kept = torch.nn.Parameter(torch.zeros(4), requires_grad=False)
    first = cache.get([kept], kept.clone)
    assert cache.get([kept], kept.clone) is first


def attention(seed=0):
    torch.manual_seed(seed)
    m = Attention4D(16, key_dim=8, num_heads=3, attn_ratio=2, resolution=3)
    with torch.no_grad():
        for p in (m.attention_biases, m.talking_head1.weight,
                  m.talking_head2.weight):
            p.copy_(torch.randn(p.shape))
    return m.eval()


def fresh_kernel_args(m, dt):
    h = m.num_heads
    return (m.attention_biases[:, m.attention_bias_idxs].to(dt),
            m.talking_head1.weight.reshape(h, h).to(dt),
            m.talking_head1.bias.to(dt),
            m.talking_head2.weight.reshape(h, h).to(dt),
            m.talking_head2.bias.to(dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attention_regathers_when_a_parameter_changes(dt):
    m = attention()
    with torch.no_grad():
        first = m.kernel_args(dt)
        assert m.kernel_args(dt) is first
        for got, want in zip(first, fresh_kernel_args(m, dt)):
            assert got.dtype == dt and torch.equal(got, want)
        m.attention_biases.add_(1.0)                   # in place
        for got, want in zip(m.kernel_args(dt), fresh_kernel_args(m, dt)):
            assert torch.equal(got, want)
        m.load_state_dict(attention(seed=1).state_dict())
        for got, want in zip(m.kernel_args(dt), fresh_kernel_args(m, dt)):
            assert torch.equal(got, want)


def test_attention_output_unchanged_by_the_cache():
    """Served (cached, inference mode) and with gradients (built afresh)
    the module gives the same output."""
    m = attention()
    x = torch.randn(1, 16, 3, 3)
    with torch.inference_mode():
        m(x)
        served = m(x)
    torch.testing.assert_close(m(x).detach(), served, rtol=0, atol=0)
