"""Deploy-time reparameterization as a pure state-dict transform (counterpart
of achelous_tpu/core/reparam.py).

The reference folds its modules in place (RepVGGBlock.switch_to_deploy
repvgg_conv.py:150-165, MobileOneBlock.reparameterize mobileone.py:155-183,
RepVGGDW.fuse repvit.py:100-120, RepMixer.reparameterize fastvit.py:292-347,
ReparamLargeKernelConv.fuse replknet.py, RepCPE.reparameterize
fastvit.py:497-519).  Here the train form's state dict is folded into the
state dict of the same model built with `deploy=True`: `reparameterize`
returns exactly that model's keys, so a strict `load_state_dict` takes it.
Everything not folded passes through unchanged.

Conv weights are torch's [out, in/groups, kh, kw]; a BatchNorm fold scales
dim 0.  The fold is taken in float32 (before `cast_compute` casts to the
serving dtype).  Invariant (tested): the deploy model's output equals the
train model's in eval, to float32 rounding.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5

Tree = Dict[str, object]


def _fuse_conv_bn(weight: torch.Tensor, bn: Tree, eps: float = BN_EPS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a BatchNorm (`weight`, `bias`, `running_mean`, `running_var`)
    into the bias-free conv before it."""
    t = bn["weight"].float() / torch.sqrt(bn["running_var"].float() + eps)
    return (weight.float() * t.view(-1, 1, 1, 1),
            bn["bias"].float() - bn["running_mean"].float() * t)


def _identity_kernel(c: int, groups: int, k: int) -> torch.Tensor:
    """The k x k conv kernel [c, c/groups, k, k] of the identity
    (repvgg_conv.py:134-139)."""
    in_dim = c // groups
    kern = torch.zeros(c, in_dim, k, k)
    idx = torch.arange(c)
    kern[idx, idx % in_dim, k // 2, k // 2] = 1.0
    return kern


def _fuse_bn_only(c: int, groups: int, k: int, bn: Tree):
    """A bare BatchNorm branch as the equivalent k x k conv."""
    return _fuse_conv_bn(_identity_kernel(c, groups, k), bn)


def _pad_kernel(weight: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad a small conv kernel to k x k, centred."""
    p = (k - weight.shape[-1]) // 2
    return F.pad(weight, (p, p, p, p))


def _conv(weight: torch.Tensor, bias: torch.Tensor) -> Tree:
    return {"weight": weight, "bias": bias}


def _branch(node: Tree, conv: str = "conv"):
    """A conv+BN pair (`conv`/`c` and `bn`) folded: (weight, bias)."""
    return _fuse_conv_bn(node[conv]["weight"], node["bn"])


def fold_repvgg(node: Tree) -> Tree:
    """RepVGGBlock -> {'rbr_reparam'} (repvgg_conv.py:110-148)."""
    k3, b3 = _branch(node["rbr_dense"])
    k1, b1 = _branch(node["rbr_1x1"])
    weight, bias = k3 + _pad_kernel(k1, 3), b3 + b1
    if "rbr_identity" in node:
        cout, cin_g = k3.shape[:2]
        kid, bid = _fuse_bn_only(cout, cout // cin_g, 3, node["rbr_identity"])
        weight, bias = weight + kid, bias + bid
    return {"rbr_reparam": _conv(weight, bias)}


def fold_mobileone(node: Tree, k_default: int = 3) -> Tree:
    """MobileOneBlock -> {'reparam_conv'} (mobileone.py:155-221), its `se`
    kept as it is.  `k_default` is the kernel size of a block with neither
    conv nor scale branches (RepMixer's BN-only `norm`,
    fastvit.py:292-307)."""
    convs = [node["rbr_conv"][i] for i in
             sorted(node.get("rbr_conv", {}), key=int)]
    if not convs and "rbr_scale" not in node:
        c = node["rbr_skip"]["weight"].shape[0]
        return {"reparam_conv": _conv(*_fuse_bn_only(c, c, k_default,
                                                     node["rbr_skip"]))}
    k_full, weight, bias = k_default, 0.0, 0.0
    for branch in convs:
        kk, bb = _branch(branch)
        weight, bias, k_full = weight + kk, bias + bb, kk.shape[-1]
    if "rbr_scale" in node:
        ks, bs = _branch(node["rbr_scale"])
        weight, bias = weight + _pad_kernel(ks, k_full), bias + bs
    if "rbr_skip" in node:
        ref = (convs[0] if convs else node["rbr_scale"])["conv"]["weight"]
        cout, cin_g = ref.shape[:2]
        kid, bid = _fuse_bn_only(cout, cout // cin_g, k_full,
                                 node["rbr_skip"])
        weight, bias = weight + kid, bias + bid
    out = {"reparam_conv": _conv(weight, bias)}
    if "se" in node:
        out["se"] = node["se"]
    return out


def fold_repvggdw(node: Tree) -> Tree:
    """RepViT's RepVGGDW -> one depthwise 3x3 (repvit.py:100-120)."""
    k3, b3 = _branch(node["conv"], "c")
    k1, b1 = _branch(node["conv1"], "c")
    kid = _identity_kernel(k3.shape[0], k3.shape[0], 3)
    return {"reparam_conv": _conv(k3 + _pad_kernel(k1, 3) + kid, b3 + b1)}


def fold_repmixer(node: Tree) -> Tree:
    """FastViT's RepMixer -> one depthwise conv (fastvit.py:292-347):
    w = id + layer_scale * (mixer_w - norm_w), b = layer_scale *
    (mixer_b - norm_b)."""
    mixer = fold_mobileone(node["mixer"])["reparam_conv"]
    norm = fold_mobileone(node["norm"])["reparam_conv"]
    ls = node["layer_scale"].float().reshape(-1)
    c, _, k, _ = mixer["weight"].shape
    weight = _identity_kernel(c, c, k) + ls.view(-1, 1, 1, 1) * (
        mixer["weight"] - norm["weight"])
    return {"reparam_conv": _conv(weight, ls * (mixer["bias"] -
                                                norm["bias"]))}


def fold_replk(node: Tree) -> Tree:
    """ReparamLargeKernelConv -> one large conv (replknet.py fuse)."""
    kb, bb = _branch(node["lkb_origin"])
    ks, bs = _branch(node["small_conv"])
    return {"lkb_reparam": _conv(kb + _pad_kernel(ks, kb.shape[-1]),
                                 bb + bs)}


def fold_repcpe(node: Tree) -> Tree:
    """RepCPE -> its depthwise conv plus the identity
    (fastvit.py:497-519)."""
    w = node["pe"]["weight"].float()
    kid = _identity_kernel(w.shape[0], w.shape[0], w.shape[-1])
    return {"reparam_conv": _conv(w + kid, node["pe"]["bias"].float())}


def _is_dict(v) -> bool:
    return isinstance(v, dict)


def leaf_kind(node: Tree) -> Optional[str]:
    """The foldable module a state subtree is, if any (the order of JAX's
    `_is_leaf_module`)."""
    keys = set(node)
    if "rbr_dense" in keys:
        return "repvgg"
    if keys == {"conv", "conv1"} and all(
            _is_dict(node[k]) and set(node[k]) == {"c", "bn"}
            for k in keys):
        return "repvggdw"
    if {"mixer", "norm", "layer_scale"} <= keys and _is_dict(node["mixer"]) \
            and "rbr_conv" in node["mixer"]:
        return "repmixer"
    if "lkb_origin" in keys:
        return "replk"
    if "rbr_conv" in keys or "rbr_scale" in keys:
        return "mobileone"
    if keys == {"pe"} and _is_dict(node["pe"]) and "weight" in node["pe"]:
        return "repcpe"
    return None


FOLDERS = {"repvgg": fold_repvgg, "repvggdw": fold_repvggdw,
           "repmixer": fold_repmixer, "replk": fold_replk,
           "mobileone": fold_mobileone, "repcpe": fold_repcpe}


def _nest(state: Mapping[str, torch.Tensor]) -> Tree:
    tree: Tree = {}
    for key, value in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _flatten(tree: Tree, prefix: str, out: Dict[str, torch.Tensor]):
    for k, v in tree.items():
        if _is_dict(v):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def reparameterize(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Fold every reparameterizable module of a train-form state dict; the
    result is the state dict of the same model built with `deploy=True`."""

    def walk(node: Tree) -> Tree:
        kind = leaf_kind(node)
        if kind is not None:
            return FOLDERS[kind](node)
        return {k: walk(v) if _is_dict(v) else v for k, v in node.items()}

    return _flatten(walk(_nest(state)), "", {})
