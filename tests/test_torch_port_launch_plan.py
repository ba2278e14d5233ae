"""K2's and K4's launch plans, chosen in Python and passed to the CUDA
kernels, on the CPU (no JAX, no GPU; the whole file well under 5 s).

  deform_samples_plan  K2 (csrc/deform.cu): at least one block per SM
                       (the plan aims for two) at RCNet's serving shapes,
                       on a card of 132 SMs (H100 SXM) or 114 (H100 PCIe);
                       within the grid's limits over the wrapper's domain
  fps_plan             K4 (csrc/pointops.cu): threads x points a thread
                       cover N up to FPS_MAX_POINTS within each variant's
                       thread limit, and the points fit shared memory
  ordered key          a mirror of K4's ordered_key, its two-step warp
                       argmax and its packed cross-warp word: (larger
                       distance, then lower index)
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

from achelous_tpu_torch.ops import hopper_deform, hopper_pointops
from achelous_tpu_torch.ops.hopper_deform import (SAMPLES_BLOCKS_PER_SM,
                                                  SAMPLES_TILE,
                                                  deform_samples_plan)
from achelous_tpu_torch.ops.hopper_pointops import (FPS_MAX_POINTS,
                                                    FPS_MAX_THREADS, FPS_PPT,
                                                    fps_plan)

CSRC = Path(hopper_deform.__file__).resolve().parents[1] / "csrc"
# RCNet blocks 4-7 at 320x320, batch 1: (C, H)
K2_SERVING = ((12, 40), (24, 20))
H100_SMS = 132                 # H100 SXM
SMEM_MAX = 232448              # shared memory a block can opt into


def k2_blocks(b, c, h, w, rows, group):
    return b * -(-h // rows) * -(-w // SAMPLES_TILE) * -(-c // group)


@pytest.mark.parametrize("c,h", K2_SERVING)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_k2_serving_shapes_fill_the_card(sms, c, h):
    plan = deform_samples_plan(1, c, h, h, sms)
    assert plan.blocks >= SAMPLES_BLOCKS_PER_SM * sms >= sms
    assert plan.blocks == k2_blocks(1, c, h, h, plan.rows, plan.group)


def test_k2_plans_at_the_serving_shapes():
    """The plans kernels/sweep.py measured on the H100 (132 SMs): G = 2 on
    4x8 tiles at 40^2 with C = 12, G = 1 on 4x8 at 20^2 with C = 24; a
    card of half the SMs takes more channels a block."""
    assert deform_samples_plan(1, 12, 40, 40, H100_SMS)[:2] == (4, 2)
    assert deform_samples_plan(1, 24, 20, 20, H100_SMS)[:2] == (4, 1)
    assert deform_samples_plan(1, 12, 40, 40, 66)[:2] == (4, 4)


def test_k2_exact_route_gathers_from_global_memory():
    """band None (reference checkpoints) takes the same gather, and C = 3
    at 320^2 takes all three channels in one block."""
    plan = deform_samples_plan(1, 3, 320, 320, H100_SMS)
    assert plan.group == 4 and plan.rows == 8 and plan.blocks == 1600


def test_k2_plan_over_the_domain():
    order = [(g, r) for g in hopper_deform.SAMPLES_GROUPS
             for r in hopper_deform.SAMPLES_ROWS]
    for b, c, (h, w), sms in itertools.product(
            [1, 3], [1, 3, 5, 12, 40, 64],
            [(1, 1), (1, 70), (37, 53), (40, 40), (250, 283), (320, 320)],
            [H100_SMS, 114, 1]):
        plan = deform_samples_plan(b, c, h, w, sms)
        assert (plan.group, plan.rows) in order
        assert plan.group < 2 * c
        assert plan.blocks == k2_blocks(b, c, h, w, plan.rows, plan.group)
        # the grid's y and z dimensions stay within 65535
        assert -(-h // plan.rows) <= 65535
        assert b * -(-c // plan.group) <= 65535
        # an option earlier in the order only when it starves the card
        for g, rows in order[:order.index((plan.group, plan.rows))]:
            if g < 2 * c:
                assert (k2_blocks(b, c, h, w, rows, g)
                        < SAMPLES_BLOCKS_PER_SM * sms)


def test_k4_plan_covers_every_n():
    for n in range(1, FPS_MAX_POINTS + 1):
        threads, ppt = fps_plan(n)
        assert ppt in FPS_PPT and threads % 32 == 0
        assert threads * ppt >= n and threads <= FPS_MAX_THREADS[ppt]
    # the float4 copy of the points and the slots fit one block
    assert FPS_MAX_POINTS * 16 + 2 * 32 * 8 <= SMEM_MAX
    with pytest.raises(ValueError):
        fps_plan(FPS_MAX_POINTS + 1)


def test_k4_plan_at_the_serving_shapes():
    """PointNet++'s 512 -> 128, 128 -> 32, 32 -> 8, 8 -> 4: ~FPS_POINTS
    points a thread, at least one warp; 128 points and fewer in one warp
    (no barrier)."""
    assert fps_plan(512) == (128, hopper_pointops.FPS_POINTS)
    assert fps_plan(128) == (32, 4)
    assert fps_plan(32) == (32, 1) and fps_plan(8) == (32, 1)
    for n in range(1, 4097):
        threads, ppt = fps_plan(n)
        want = max(32, (-(-n // hopper_pointops.FPS_POINTS) + 31) // 32 * 32)
        assert threads <= want


def ordered_key(d: np.ndarray) -> np.ndarray:
    """csrc/pointops.cu ordered_key: flip every bit of a negative float,
    only the sign bit of a positive one."""
    u = np.asarray(d, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def warp_argmax(keys: np.ndarray, idx: np.ndarray) -> int:
    """The kernel's two redux.sync: the max key, then the min index among
    the lanes that hold it."""
    top = keys.max()
    return int(np.where(keys == top, idx, 0xFFFFFFFF).min())


def packed_winner(keys: np.ndarray, idx: np.ndarray) -> int:
    """The kernel's cross-warp reduce: the max of (key << 32 | ~index)."""
    words = (keys.astype(np.uint64) << np.uint64(32)) | (
        ~idx.astype(np.uint32)).astype(np.uint64)
    return int(~np.uint32(words.max() & np.uint64(0xFFFFFFFF)))


def test_ordered_key_mirror_matches_the_kernel_source():
    src = (CSRC / "pointops.cu").read_text()
    assert re.search(r"\(u & 0x80000000u\) \? ~u : \(u \| 0x80000000u\)", src)
    assert "__reduce_max_sync" in src and "__reduce_min_sync" in src
    assert "(unsigned long long)top << 32 | (unsigned)~wi" in src


def test_ordered_key_sorts_distances_then_lower_index():
    tiny = np.float32(1e-45)                 # the smallest denormal
    values = np.array([-1.0, 0.0, tiny, 2 * tiny, 1e-38, 1.17549435e-38,
                       0.5, 1.0, 3.0, 1e10, np.inf], np.float32)
    keys = ordered_key(values)
    assert np.all(np.diff(keys.astype(np.int64)) > 0)
    assert ordered_key(np.float32(-1.0)) < ordered_key(np.float32(0.0))
    rng = np.random.RandomState(0)
    for _ in range(200):
        # distances of the kind a step leaves: -1 (masked), 0 (picked),
        # denormals, coarse grid values with ties, the 1e10 start
        d = rng.choice(np.concatenate([values[:-1], [0.25, 0.25, 1e10]]),
                       size=rng.randint(1, 97)).astype(np.float32)
        idx = np.arange(len(d), dtype=np.uint32)
        # lanes: interleaved points a thread, then the warp's two steps
        lanes = min(32, len(d))
        best = []
        for lane in range(lanes):
            mine = np.arange(lane, len(d), lanes)
            first = mine[np.argmax(d[mine])]   # strict > on floats
            best.append((ordered_key(d[first]), first))
        got = warp_argmax(np.array([k for k, _ in best]),
                          np.array([i for _, i in best]))
        assert got == int(np.argmax(d))       # torch/numpy: first maximum
        assert warp_argmax(ordered_key(d), idx) == int(np.argmax(d))
        # warps' winners, then the packed word across warps
        warps = [(ordered_key(d[w:w + 32]).max(),
                  w + int(np.argmax(d[w:w + 32])))
                 for w in range(0, len(d), 32)]
        assert packed_winner(np.array([k for k, _ in warps]),
                             np.array([i for _, i in warps])) == \
            int(np.argmax(d))
