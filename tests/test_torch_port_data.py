"""The PyTorch port's data pipeline, radar splat and metrics against the JAX
package, on the CPU.

On one small WaterScenes tree (`achelous_tpu_torch.data.example`, 96x54
frames with raw radar CSVs, 64x64 input):

  * the letterbox and the CSV parse (`data/native.py`): the port's, which
    goes through native/libdataio.so where it is built as the JAX package's
    does, equal to JAX's `letterbox_image_native`, `letterbox_mask_native`
    and `load_radar_csv`; its numpy letterbox within 1e-4 of the C++ one
    (float32 summation order), its numpy mask and parse equal;
  * `WaterScenesDataset` samples and `collate` batches, array for array
    equal to JAX's, without and with augmentation (HSV, flip, mosaic) from
    the same seed; `batches_from` through the prefetch thread, with its
    order, `n_valid` and `indices`;
  * `device_batch`: the image channels-first, the radar map splatted;
  * `splat_radar_fast` and `splat_radar_points` equal to JAX's `cf=True`
    results on frames with collisions, points outside the frame, NaN/inf
    and padding rows; `minmax_normalize`;
  * `unletterbox_argmax` on both of its branches;
  * the metrics (a copy) equal to JAX's on random detections and masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from achelous_tpu.core.config import AchelousConfig as JaxConfig
from achelous_tpu.data import native as jnative
from achelous_tpu.data import waterscenes as jws
from achelous_tpu.data.augment import AugmentConfig as JaxAugment
from achelous_tpu.ops import radar_splat as jsplat
from achelous_tpu.train import loop as jloop
from achelous_tpu.utils import metrics as jmetrics

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data import native, waterscenes as tws
from achelous_tpu_torch.data.augment import AugmentConfig
from achelous_tpu_torch.data.example import write_tree
from achelous_tpu_torch.data.prefetch import prefetch
from achelous_tpu_torch.ops import radar_splat as tsplat
from achelous_tpu_torch.train import loop as tloop
from achelous_tpu_torch.utils import metrics as tmetrics

RES, PTS, MAX_GT = 64, 64, 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("ws_port")), frames=6,
                      size=(96, 54), points=40)


def datasets(tree, augment=None, annotation="train.txt"):
    jds = jws.WaterScenesDataset(
        JaxConfig(resolution=RES, pc_points=PTS),
        jws.WaterScenesPaths(**vars(tws.WaterScenesPaths.under(
            tree, annotation))),
        max_gt=MAX_GT, seed=3,
        augment=None if augment is None else JaxAugment(**augment))
    tds = tws.WaterScenesDataset(
        AchelousConfig(resolution=RES, pc_points=PTS),
        tws.WaterScenesPaths.under(tree, annotation), max_gt=MAX_GT, seed=3,
        augment=None if augment is None else AugmentConfig(**augment))
    return jds, tds


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_native_letterbox_and_parse_match_jax(tree):
    """The port's dispatching functions equal JAX's on this host; the numpy
    versions equal the C++ mask and parse, and its letterbox within 1e-4
    (the normalised values span about +-2.6)."""
    from PIL import Image
    ds = tws.WaterScenesDataset(AchelousConfig(resolution=RES),
                                tws.WaterScenesPaths.under(tree))
    img = np.asarray(Image.open(ds.lines[0].split()[0]).convert("RGB"))
    mask = np.asarray(Image.open(f"{tree}/semantic/frame000.png"))
    csv = f"{tree}/radar/frame000.csv"
    assert jnative.available() and native.lib() is not None
    for res in (RES, 50):
        want = jnative.letterbox_image_native(img, res)
        np.testing.assert_array_equal(native.letterbox_image(img, res), want)
        np.testing.assert_array_equal(native.letterbox_mask(mask, res, 9),
                                      jnative.letterbox_mask_native(mask, res,
                                                                    9))
    for cols in (tws.SPLAT_FEATURES, tws.PC_FEATURES, ["label"], ["nope"]):
        np.testing.assert_array_equal(tws.load_radar_csv(csv, cols),
                                      jws.load_radar_csv(csv, cols))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "lib", lambda: None)
        for res in (RES, 50):
            np.testing.assert_allclose(
                native.letterbox_image(img, res),
                jnative.letterbox_image_native(img, res), rtol=0, atol=1e-4)
            np.testing.assert_array_equal(
                native.letterbox_mask(mask, res, 9),
                jnative.letterbox_mask_native(mask, res, 9))
        np.testing.assert_array_equal(native.parse_radar_csv(csv, [4, 0, 9]),
                                      jnative.parse_radar_csv_native(
                                          csv, [4, 0, 9]))


@pytest.mark.parametrize("augment", [None, {}, {"mosaic_prob": 0.5}],
                         ids=["plain", "hsv_flip", "mosaic"])
def test_dataset_and_collate_match_jax(tree, augment):
    """Every sample (twice over, so the generators advance) and the
    collated batch, array for array."""
    jds, tds = datasets(tree, augment)
    names = []
    for i in list(range(len(jds))) * 2:
        sample = tds[i]
        assert_same(sample, jds[i])
        assert sample["radar_points_valid"].any()
        names.append(sample["name"])
    if augment and augment.get("mosaic_prob"):
        assert any(n.endswith("_mosaic") for n in names)
    idx = [3, 0, 2]
    cfg, jcfg = tds.cfg, jds.cfg
    assert_same(tws.collate([tds[i] for i in idx], cfg, MAX_GT),
                jws.collate([jds[i] for i in idx], jcfg, MAX_GT))


def test_batches_through_prefetch_match_jax(tree):
    """Shuffled, and padded at the tail without drop_last: the same
    batches in the same order, with `n_valid` and `indices`."""
    for drop_last in (True, False):
        jds, tds = datasets(tree)
        want = list(jloop.batches_from(jds, jds.cfg, 3, MAX_GT, True,
                                       np.random.RandomState(7),
                                       drop_last=drop_last))
        with prefetch(tloop.batches_from(tds, tds.cfg, 3, MAX_GT, True,
                                         np.random.RandomState(7),
                                         drop_last=drop_last)) as it:
            got = list(it)
        assert len(got) == len(want) == (1 if drop_last else 2)
        for g, w in zip(got, want):
            assert_same(g, w)


def test_device_batch_splats_the_radar(tree):
    """Image channels-first; the radar map from the raw points equals JAX's
    batched splat, transposed."""
    _, tds = datasets(tree)
    batch = tws.collate([tds[i] for i in range(3)], tds.cfg, MAX_GT)
    got = tloop.device_batch(batch, tds.cfg, "cpu")
    assert "radar_points" not in got and "n_valid" not in got
    np.testing.assert_array_equal(got["image"].numpy(),
                                  batch["image"].transpose(0, 3, 1, 2))
    want = jax.vmap(lambda p, v: jsplat.splat_radar_fast(p, v, RES))(
        jnp.asarray(batch["radar_points"]),
        jnp.asarray(batch["radar_points_valid"]))
    np.testing.assert_array_equal(got["radar"].numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))
    assert np.count_nonzero(got["radar"].numpy()) > 0


def splat_case(seed, n=300, r=32):
    """Radar frames [3, n, 5] with repeated cells, points outside the frame,
    NaN and inf coordinates, and a padding mask."""
    rng = np.random.RandomState(seed)
    p = np.zeros((3, n, 5), np.float32)
    p[..., :3] = rng.randn(3, n, 3)
    p[..., 3] = rng.uniform(-200, 2100, (3, n))
    p[..., 4] = rng.uniform(-100, 1200, (3, n))
    p[:, :120, 3] = rng.choice([60.0, 61.0, 125.0], (3, 120))
    p[:, :120, 4] = rng.choice([34.0, 34.5], (3, 120))
    p[0, 5, 3], p[1, 7, 4], p[2, 9, 3] = np.nan, np.inf, -np.inf
    return p, rng.rand(3, n) > 0.2, r


@pytest.mark.parametrize("seed", [0, 1])
def test_splats_match_jax(seed):
    p, v, r = splat_case(seed)
    got = tsplat.splat_radar_fast(torch.from_numpy(p), torch.from_numpy(v), r)
    assert got.shape == (3, 3, r, r)
    for b in range(3):
        jp, jv = jnp.asarray(p[b]), jnp.asarray(v[b])
        np.testing.assert_array_equal(
            got[b].numpy(),
            np.asarray(jsplat.splat_radar_fast(jp, jv, r, cf=True)))
        np.testing.assert_array_equal(
            tsplat.splat_radar_fast(torch.from_numpy(p[b]), None, r).numpy(),
            np.asarray(jsplat.splat_radar_fast(jp, None, r, cf=True)))
        exact = tsplat.splat_radar_points(torch.from_numpy(p[b]),
                                          torch.from_numpy(v[b]), r)
        np.testing.assert_array_equal(
            exact.numpy(),
            np.asarray(jsplat.splat_radar_points(jp, jv, r, cf=True)))
    m = got[0].clone()
    np.testing.assert_allclose(tsplat.minmax_normalize(m).numpy(),
                               np.asarray(jsplat.minmax_normalize(
                                   jnp.asarray(m.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("orig", [(64, 64), (54, 96), (40, 30)])
def test_unletterbox_argmax_matches_jax(orig):
    prob = np.random.RandomState(1).rand(RES, RES, 5).astype(np.float32)
    np.testing.assert_array_equal(tloop.unletterbox_argmax(prob, orig),
                                  jloop.unletterbox_argmax(prob, orig))


def test_metrics_match_jax():
    """Detection metrics (COCO and VOC, per class) on random detections,
    mIoU and the point-cloud mIoU on random labels."""
    rng = np.random.RandomState(4)
    dets, gts = [], []
    for _ in range(6):
        ng, nd = rng.randint(0, 5), rng.randint(0, 12)
        g = rng.uniform(0, 60, (ng, 2))
        gts.append({"boxes": np.concatenate([g, g + rng.uniform(4, 30,
                                                                (ng, 2))], 1),
                    "classes": rng.randint(0, 3, ng)})
        d = rng.uniform(0, 60, (nd, 2))
        dets.append({"boxes": np.concatenate([d, d + rng.uniform(4, 30,
                                                                 (nd, 2))], 1),
                     "scores": rng.rand(nd), "classes": rng.randint(0, 3, nd)})
    for fn in ("compute_det_metrics", "compute_voc_map",
               "voc_per_class_table"):
        kw = {"per_class": True} if fn == "compute_det_metrics" else {}
        got = getattr(tmetrics, fn)(dets, gts, 3, **kw)
        want = getattr(jmetrics, fn)(dets, gts, 3, **kw)
        np.testing.assert_equal(got, want)
    labels = [rng.randint(0, 4, (20, 30)) for _ in range(3)]
    preds = [rng.randint(0, 4, (20, 30)) for _ in range(3)]
    np.testing.assert_equal(tmetrics.compute_miou(labels, preds, 4),
                            jmetrics.compute_miou(labels, preds, 4))
    conf = rng.randint(0, 50, (8, 8))
    assert tmetrics.pc_mean_iou(conf) == jmetrics.pc_mean_iou(conf)
