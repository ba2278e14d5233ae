"""Gradients the PyTorch port's training takes through K3 and at the band's
bound, against the JAX package, on the CPU.

  * K3's autograd Function (`FusedBiasAttention`; on the CPU its forward
    is the plain version, its backward the one the card runs): every
    input's gradient against `jax.vjp` of `reference_bias_attention`, the
    function JAX trains EfficientFormerV2 through, float32, within 1e-5
    of each gradient's largest value (th1_b's exact gradient is 0: held
    to 1e-5 of th1_w's), with non-symmetric head mixes (the port holds
    them as [g_out, h_in], JAX as [h_in, g_out]);
  * the wrapper takes the Function only where a gradient is asked for;
  * Attention4D's parameters (q and k conv-BNs, the float32 bias table
    through its gather and cast, both head mixes) all get their gradient
    when K3's forward returns a tensor with no graph, as the CUDA kernel's
    does, in float32 and through `forward_compute`'s bf16 casts;
  * the offset gradient at exactly +-band: K2's and K1's plain versions
    (and the Functions' backward) take `jnp.clip`'s half slope there, as
    `jax.vjp` of JAX's sampling does, at offsets on the bound, inside it
    at integers and between; the outputs with a gradient asked for equal
    those without, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.ops.pallas_attention import reference_bias_attention

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.models import efficientformer as tef
from achelous_tpu_torch.models.achelous import Achelous, forward_compute
from achelous_tpu_torch.ops import hopper_attention, hopper_deform
from achelous_tpu_torch.ops.attention import reference_bias_attention as plain
from achelous_tpu_torch.ops.deform import (banded_deform_samples,
                                           fused_radarconv_reference)
from chip_smoke import K3_GRADIENT
from test_torch_port_ef import k3_case
from test_torch_port_train import (check_k1_against_jax, check_k2_against_jax,
                                   k2_inputs)

SCALE = 32 ** -0.5


@pytest.mark.parametrize("n", [100, 36])
def test_k3_function_gradients_match_jax_vjp(n):
    q, k, v, bias, w1, b1, w2, b2 = k3_case(n, seed=n)
    g = np.random.RandomState(n + 1).randn(2, 8, n, 128).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: reference_bias_attention(*a, SCALE),
                          *(jnp.asarray(a) for a in
                            (q, k, v, bias, w1, b1, w2, b2)))
    want = [np.asarray(w) for w in pullback(jnp.asarray(g))]
    want[4], want[6] = want[4].T, want[6].T        # to [g_out, h_in]
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
           for a in (q, k, v, bias, w1.T, b1, w2.T, b2)]
    out = hopper_attention.FusedBiasAttention.apply(*ins, SCALE)
    out.backward(torch.from_numpy(g))
    names = ("q", "k", "v", "bias", "th1_w", "th1_b", "th2_w", "th2_b")
    for name, p, w in zip(names, ins, want):
        # th1_b shifts a whole row of logits in front of the softmax: its
        # exact gradient is 0, and both sides give float32 noise, held to
        # the scale of the gradient of th1_w, the same row sums weighted
        scale = np.abs(want[4] if name == "th1_b" else w).max()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_k3_wrapper_takes_the_function_only_for_a_gradient():
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in k3_case(16, seed=3)]
    hopper_attention.fused_bias_attention.launches = 0
    assert hopper_attention.fused_bias_attention(*args, SCALE).grad_fn is None
    args[3].requires_grad_(True)
    out = hopper_attention.fused_bias_attention(*args, SCALE)
    assert type(out.grad_fn).__name__ == "FusedBiasAttentionBackward"
    with torch.no_grad():
        assert hopper_attention.fused_bias_attention(*args,
                                                     SCALE).grad_fn is None
    assert hopper_attention.fused_bias_attention.launches == 0


def graphless(monkeypatch):
    """K3's forward returns its value with no graph, as the kernel's
    output, filled through ctypes, has none."""
    def forward(*args):
        with torch.no_grad():
            return plain(*args)
    monkeypatch.setattr(hopper_attention, "_attention_forward", forward)


@pytest.mark.parametrize("stride", [None, 2])
def test_attention4d_params_get_gradients_through_k3(monkeypatch, stride):
    """With K3's forward cut from the graph, every Attention4D parameter
    still gets the gradient of the plain forward, float32."""
    torch.manual_seed(0)
    m = tef.Attention4D(24, resolution=5, stride=stride).train()
    with torch.no_grad():
        m.attention_biases.normal_()
        for c in (m.talking_head1, m.talking_head2):
            c.weight.normal_()
    x = torch.randn(2, 24, 5, 5)
    m(x).square().sum().backward()
    want = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    graphless(monkeypatch)
    m(x).square().sum().backward()
    for n, p in m.named_parameters():
        assert p.grad is not None, n
        torch.testing.assert_close(p.grad, want[n], rtol=1e-5, atol=1e-6,
                                   msg=n)
    for n in ("attention_biases", "q.0.weight", "k.0.weight",
              "talking_head1.weight", "talking_head2.bias"):
        assert torch.count_nonzero(want[n]) > 0, n


def test_ef_model_attention_gets_gradients_in_bf16(monkeypatch):
    """EF-GDF-PN-S0 at 64^2 in bf16 compute on float32 parameters
    (`forward_compute`: every parameter a fresh cast), K3's forward cut
    from the graph: every parameter of every Attention4D gets a gradient,
    nonzero for those it reaches only through K3 (`chip_smoke.K3_GRADIENT`:
    the queries', keys', bias table's and head mixes')."""
    graphless(monkeypatch)
    cfg = AchelousConfig(resolution=64, backbone="ef", dtype=torch.bfloat16)
    torch.manual_seed(0)
    model = Achelous(cfg).train()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("attention_biases", "layer_scale_1")):
                p.normal_(0, 0.1)
    x = torch.randn(2, 3, 64, 64)
    out = forward_compute(model, x, x, torch.rand(2, 512, 5))
    sum(o.float().square().mean() for o in out[0]).backward()
    params = {n: p for n, p in model.named_parameters()
              if ".token_mixer." in n}
    assert len(params) == 2 * 25 + 2 * 29, len(params)   # 2 strided
    for n, p in params.items():
        assert p.grad is not None, n
        if n.endswith(K3_GRADIENT):
            assert torch.count_nonzero(p.grad) > 0, n


def band_offsets(rng, shape, band):
    """Offsets on +-band, integers inside the band and fractions, mixed
    per tap and axis."""
    kind = rng.randint(0, 4, shape)
    off = np.where(kind == 0, band, np.where(kind == 1, -band, 0.0))
    off = np.where(kind == 2, rng.randint(-band + 1, band, shape), off)
    off = np.where(kind == 3, rng.uniform(-band - 2, band + 2, shape), off)
    return off.astype(np.float32)


@pytest.mark.parametrize("band", [1, 4])
def test_k2_gradient_at_the_band_matches_jax_vjp(band):
    rng = np.random.RandomState(30 + band)
    x, mask, g, shape = k2_inputs(rng)
    off = band_offsets(rng, shape, band)
    assert (np.abs(off) == band).mean() > 0.4
    check_k2_against_jax(x, off, mask, g, band)


def test_k1_gradient_at_the_band_matches_jax_vjp():
    """Offset conv at zero weights and biases of exactly +-4 (and 0), so
    every tap samples on the bound or at 0."""
    c = 3
    rng = np.random.RandomState(40)
    x = rng.randn(2, 13, 17, c).astype(np.float32)
    ok = np.zeros((3, 3, c, 18), np.float32)
    ob = rng.choice([-4.0, 4.0, 0.0], 18).astype(np.float32)
    mk = (rng.randn(3, 3, c, 9) * 0.3).astype(np.float32)
    mb = (rng.randn(9) * 0.3).astype(np.float32)
    wp = (rng.randn(3, 3, c, c) * 0.3).astype(np.float32)
    g = rng.randn(2, 13, 17, c).astype(np.float32)
    check_k1_against_jax(x, ok, ob, mk, mb, wp, g)


def test_outputs_at_the_band_do_not_change_with_a_gradient():
    """The zero-valued terms leave K2's and K1's plain outputs bit for bit
    as without a gradient."""
    rng = np.random.RandomState(50)
    x, mask, _, shape = k2_inputs(rng)
    off = band_offsets(rng, shape, 4)
    xt, mt = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
              for a in (x, mask))
    ot = torch.from_numpy(off).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        want = banded_deform_samples(xt, ot, mt, 4)
    got = banded_deform_samples(xt, ot.requires_grad_(True), mt, 4)
    assert got.grad_fn is not None and torch.equal(got, want)
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32))
         for s in ((18, 12, 3, 3), (18,), (9, 12, 3, 3), (9,), (5, 12, 3, 3))]
    w[0].zero_()
    w[1] = torch.from_numpy(rng.choice([-4.0, 4.0], 18).astype(np.float32))
    with torch.no_grad():
        want = fused_radarconv_reference(xt, *w, 4)
    got = fused_radarconv_reference(xt, *(t.requires_grad_(True) for t in w),
                                    4)
    assert torch.equal(got, want)
    packed = hopper_deform.pack_radarconv_weights(*w)
    assert torch.equal(hopper_deform.fused_radarconv(xt, *packed, 4), want)
