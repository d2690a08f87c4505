"""The port's data layer against the JAX package's, on the CPU: IL states,
the COCO index, the transforms, PNG image I/O, the datasets, the batch
loader and the toy-dataset generator.

Tolerances:
  * states, COCO queries, datasets, ``pick_canonical``, ``compute_scale``,
    ``hflip``, ``pad_annotations``, the toy generator: equal;
  * ``resize_and_pad``: the port's resize is its own bilinear
    (``resize_bilinear``), JAX's is OpenCV's ``INTER_LINEAR``: float
    |diff| <= 5e-5 at scales 1.2-2.6x, and after the uint8 transfer
    rounding at most 1 in at most 0.2% of the values; equal at scale 1.
    The port interpolates in float64 and is also held within one float32
    spacing at 1.0 (1.2e-7) of OpenCV;
  * the loader: every ``Batch`` field equal to JAX's at frames where the
    scale is 1 (toy images 48 x 64, ``min_side`` 48, ``max_side`` 64),
    with hflip and the wrap-around fill, in every frame layout and at
    worker counts 0, 1 and 3;
  * PNG: round trips bit-exact, every filter type decoded exactly, the
    same pixels as OpenCV.
"""
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from cl_object_detection_tpu import config as jcfg
from cl_object_detection_tpu import states as jstates
from cl_object_detection_tpu.data import coco as jcoco
from cl_object_detection_tpu.data import dataset as jdataset
from cl_object_detection_tpu.data import loader as jloader
from cl_object_detection_tpu.data import transforms as jtr
from cl_object_detection_tpu.utils import toydata as jtoy
from cl_object_detection_tpu_torch import config as tcfg
from cl_object_detection_tpu_torch import states as tstates
from cl_object_detection_tpu_torch.data import coco as tcoco
from cl_object_detection_tpu_torch.data import dataset as tdataset
from cl_object_detection_tpu_torch.data import image_io
from cl_object_detection_tpu_torch.data import loader as tloader
from cl_object_detection_tpu_torch.data import transforms as ttr
from cl_object_detection_tpu_torch.utils import toydata as ttoy

VOC = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
       "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
       "sheep", "sofa", "train", "tvmonitor")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Port toy set (PNG): 10 images at 48 x 64, every third portrait."""
    root = str(tmp_path_factory.mktemp("toy_data"))
    json_path = ttoy.make_toy_dataset(root, num_images=10, image_size=(48, 64), seed=3)
    return json_path, os.path.join(root, "images")


# ------------------------------------------------------------------ states

def _state_fields(states):
    return ([(s.index, s.new_names, s.new_ids, s.knowing_names, s.knowing_ids,
              s.num_past_class, s.past_names, s.past_ids) for s in states.states],
            states.class_order, states.total_class_num, states.label_map(),
            states.inverse_label_map())


@pytest.mark.parametrize("scenario,shuffle", [
    (["20"], False), ([20], False), ([10, 10], False), (["15", "1"], False),
    ([19, "tvmonitor"], False), (["person", 19], False), ([5, 5, 5, 5], False),
    ([10, 10], True), (["15", "1"], True),
])
def test_il_states_match_jax(scenario, shuffle):
    name_to_id = {n: i + 1 for i, n in enumerate(VOC)}
    args = (list(reversed(VOC)), name_to_id, scenario)
    j = jstates.ILStates(*args, shuffle_class=shuffle, shuffle_seed=7)
    t = tstates.ILStates(*args, shuffle_class=shuffle, shuffle_seed=7)
    assert _state_fields(t) == _state_fields(j)
    assert len(t) == len(j)


def test_il_states_refusals_match_jax():
    name_to_id = {n: i + 1 for i, n in enumerate(VOC)}
    for mod in (jstates, tstates):
        with pytest.raises(ValueError, match="needs 21 classes"):
            mod.ILStates(VOC, name_to_id, [20, 1])
        with pytest.raises(ValueError, match="unknown class"):
            mod.ILStates(VOC, name_to_id, [19, "unicorn"])
        with pytest.raises(IndexError):
            mod.ILStates(VOC, name_to_id, [20])[1]


# -------------------------------------------------------------------- COCO

def test_coco_queries_match_jax(toy):
    json_path, _ = toy
    j, t = jcoco.CocoJson(json_path), tcoco.CocoJson(json_path)
    assert (t.imgs, t.cats, t.anns, t.classes, t.classes_inverse) == \
        (j.imgs, j.cats, j.anns, j.classes, j.classes_inverse)
    cats = sorted(j.cats)
    assert t.cat_id_to_name(cats) == j.cat_id_to_name(cats)
    assert t.cat_id_to_name(cats[0]) == j.cat_id_to_name(cats[0])
    names = list(reversed(t.cat_id_to_name(cats)))
    assert t.cat_name_to_id(names) == j.cat_name_to_id(names)
    assert t.cat_name_to_id(names, sort=True) == j.cat_name_to_id(names, sort=True)
    for c in cats + [cats[:2]]:
        assert t.get_imgs_by_cats(c) == j.get_imgs_by_cats(c)
    for i in sorted(j.imgs) + [sorted(j.imgs)[:3]]:
        assert t.get_cats_by_imgs(i) == j.get_cats_by_imgs(i)
        assert sorted(t.get_cats_by_imgs(i, sort=False)) == sorted(j.get_cats_by_imgs(i, sort=False))
    for i in sorted(j.imgs):
        assert t.get_anns_by_img(i) == j.get_anns_by_img(i)
    assert t.image_count_per_class() == j.image_count_per_class()
    assert t.object_count_per_class() == j.object_count_per_class()


# -------------------------------------------------------------- transforms

def test_pick_canonical_and_compute_scale_match_jax():
    r = np.random.RandomState(0)
    buckets = ((64, 96), (96, 128), (480, 640))
    for _ in range(500):
        h, w = (int(v) for v in r.randint(16, 1200, 2))
        args = (h, w, int(r.randint(32, 700)), int(r.randint(64, 1400)))
        assert ttr.compute_scale(*args) == jtr.compute_scale(*args)
        for b in ((), buckets):
            assert ttr.pick_canonical(h, w, 640, 1024, b) == jtr.pick_canonical(h, w, 640, 1024, b)


def test_hflip_and_pad_annotations_match_jax():
    r = np.random.RandomState(1)
    img = r.rand(37, 53, 3).astype(np.float32)
    boxes = (r.rand(5, 4) * 40).astype(np.float32)
    labels = r.randint(0, 5, 5).astype(np.int32)
    for b in (boxes, np.zeros((0, 4), np.float32)):
        for got, want in zip(ttr.hflip(img, b), jtr.hflip(img, b)):
            np.testing.assert_array_equal(got, want)
    for m in (3, 5, 8):
        got, want = ttr.pad_annotations(boxes, labels, m), jtr.pad_annotations(boxes, labels, m)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw", [(375, 500), (500, 375), (240, 320), (480, 640), (333, 500),
                                (400, 600)])
def test_resize_and_pad_within_bars_of_jax(hw):
    """Scales 1.2x-2.6x into 640 x 1024 frames (VOC-like sizes)."""
    r = np.random.RandomState(sum(hw))
    img = r.rand(*hw, 3).astype(np.float32)
    boxes = np.array([[3, 4, 100, 120], [10, 20, 30, 40]], np.float32)
    got, gb, gs = ttr.resize_and_pad(img, boxes, 608, 1024, 640, 1024)
    want, wb, ws = jtr.resize_and_pad(img, boxes, 608, 1024, 640, 1024)
    assert 1.2 <= gs <= 2.6
    assert got.shape == want.shape and gs == ws
    np.testing.assert_array_equal(gb, wb)
    assert np.abs(got - want).max() <= 5e-5
    # measured: within one float32 spacing at 1.0 (float64 interpolation)
    assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
    q = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.int16)
    d = np.abs(q(got) - q(want))
    assert d.max() <= 1 and (d > 0).mean() <= 2e-3


@pytest.mark.parametrize("hw,frame", [((48, 64), None), ((64, 48), None), ((48, 64), (64, 96))])
def test_resize_and_pad_bit_equal_at_scale_one(hw, frame):
    img = np.random.RandomState(2).rand(*hw, 3).astype(np.float32)
    boxes = np.array([[1, 2, 30, 40]], np.float32)
    got = ttr.resize_and_pad(img, boxes, 48, 64, 64, 64, frame=frame)
    want = jtr.resize_and_pad(img, boxes, 48, 64, 64, 64, frame=frame)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_resize_bilinear_is_opencvs_interpolation():
    """Half-pixel centres, no antialiasing, edges clamped: downscaling too
    stays within the bar of OpenCV's INTER_LINEAR (no area averaging)."""
    img = np.random.RandomState(4).rand(120, 160, 3).astype(np.float32)
    for nh, nw in ((60, 80), (97, 131), (240, 320), (1, 1)):
        got = ttr.resize_bilinear(img, nh, nw)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        assert got.shape == want.shape and np.abs(got - want).max() <= 5e-5, (nh, nw)


# ---------------------------------------------------------------- image I/O

def _png(img: np.ndarray, filters, interlace: int = 0) -> bytes:
    """An 8-bit PNG of ``img`` with the given filter type per row (the
    forward filters of the PNG specification, written out here)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    raw = img.reshape(h, w * bpp).astype(np.int32)
    rows = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("library", [True, False])
def test_png_filters_decode_exactly(monkeypatch, filters, grey, library):
    """With an image library, Average and Paeth rows go to it and the
    byte-by-byte undo never runs; without one, this module undoes every
    filter type itself."""
    r = np.random.RandomState(len(filters))
    img = r.randint(0, 256, (13, 17) if grey else (13, 17, 3)).astype(np.uint8)
    data = _png(img, filters)
    want = np.repeat(img[:, :, None], 3, axis=2) if grey else img
    with monkeypatch.context() as m:
        if library:
            m.setattr(image_io, "_unfilter_sequential", None)
        else:
            _no_image_libraries(m)
        np.testing.assert_array_equal(image_io.decode_image(data), want)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(bgr[:, :, ::-1], want)


@pytest.mark.parametrize("shape", [(48, 64, 3), (375, 500, 3), (31, 7), (1, 1, 3)])
def test_png_round_trip_and_opencv_agree(tmp_path, shape):
    img = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    rgb = np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), rgb)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1], rgb)
    ok, enc = cv2.imencode(".png", np.ascontiguousarray(rgb[:, :, ::-1]))
    assert ok
    np.testing.assert_array_equal(image_io.decode_image(enc.tobytes()), rgb)


def _no_image_libraries(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_jpeg_goes_through_a_library_or_raises(monkeypatch):
    img = np.random.RandomState(6).randint(0, 256, (24, 32, 3)).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1])
    data = enc.tobytes()
    want = cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    _no_image_libraries(monkeypatch)
    with pytest.raises(ImportError, match="JPEG.*OpenCV.*PIL"):
        image_io.decode_image(data)


def test_png_outside_the_decoder_needs_a_library(monkeypatch):
    """Interlaced and 16-bit PNGs: refused with the reason when neither
    library imports. A PNG the decoder takes needs neither."""
    img = np.zeros((4, 4, 3), np.uint8)
    interlaced = _png(img, (0,), interlace=1)
    _no_image_libraries(monkeypatch)
    with pytest.raises(ImportError, match="interlaced PNG"):
        image_io.decode_image(interlaced)
    sixteen = bytearray(_png(img, (0,)))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)
    sixteen[16:29] = ihdr
    sixteen[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    with pytest.raises(ImportError, match="bit depth 16"):
        image_io.decode_image(bytes(sixteen))
    np.testing.assert_array_equal(image_io.decode_image(_png(img, (4,))), img)


def test_png_corruption_is_refused():
    data = bytearray(_png(np.zeros((4, 4, 3), np.uint8), (0,)))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_image(bytes(data))


# ---------------------------------------------------------------- toy data

@pytest.mark.parametrize("style", ["legacy", "separable"])
def test_toy_dataset_matches_jax(tmp_path, monkeypatch, style):
    """The same generator and RNG: the same JSON (but the file names'
    extension) and the same pixels; JAX writes JPEG, the port PNG."""
    arrays = []
    monkeypatch.setattr(jtoy, "_save_jpeg", lambda path, img: arrays.append(img.copy()))
    kw = dict(num_images=9, classes=VOC[:7], image_size=(40, 56), seed=4, style=style)
    jj = jtoy.make_toy_dataset(str(tmp_path / "j"), **kw)
    tj = ttoy.make_toy_dataset(str(tmp_path / "t"), **kw)
    with open(jj) as f:
        want = f.read().replace(".jpg", ".png")
    with open(tj) as f:
        got = f.read()
    assert got == want
    with open(tj) as f:
        import json
        images = json.load(f)["images"]
    assert len(images) == len(arrays) == 9
    for info, arr in zip(images, arrays):
        got_img = image_io.read_image(str(tmp_path / "t" / "images" / info["file_name"]))
        np.testing.assert_array_equal(got_img, arr)


# ---------------------------------------------------------------- datasets

def _datasets(toy, scenario, **kw):
    json_path, images = toy
    out = []
    for coco_mod, states_mod, ds_mod in ((jcoco, jstates, jdataset), (tcoco, tstates, tdataset)):
        coco = coco_mod.CocoJson(json_path)
        states = states_mod.ILStates(list(coco.classes.values()), coco.classes_inverse, scenario)
        out.append((coco, states, ds_mod))
    return out


def _all_annotations(ds):
    return [tuple(np.asarray(a).tolist() if isinstance(a, np.ndarray) else a
                  for a in ds.load_annotations(i)) for i in range(len(ds))]


@pytest.mark.parametrize("split,start_state,ratio", [("train", 0, 1.0), ("train", 1, 1.0),
                                                     ("test", 1, 1.0), ("train", 0, 0.5)])
def test_il_dataset_matches_jax(toy, split, start_state, ratio):
    (jc, js, jd), (tc, ts, td) = _datasets(toy, [3, 2])
    images = toy[1]
    j = jd.ILDataset(jc, js, images, split=split, start_state=start_state, use_data_ratio=ratio)
    t = td.ILDataset(tc, ts, images, split=split, start_state=start_state, use_data_ratio=ratio)
    assert t.image_ids == j.image_ids and t.seen_class_ids == j.seen_class_ids
    assert _all_annotations(t) == _all_annotations(j)
    assert [t.image_size(i) for i in range(len(t))] == [j.image_size(i) for i in range(len(j))]
    for i in range(len(t)):
        np.testing.assert_array_equal(t.load_image(i), j.load_image(i))
    if start_state == 0:
        j.next_state()
        t.next_state()
        assert t.image_ids == j.image_ids and _all_annotations(t) == _all_annotations(j)


def test_pseudo_labels_merge_like_jax(toy):
    (jc, js, jd), (tc, ts, td) = _datasets(toy, [3, 2])
    images = toy[1]
    ids = jd.ILDataset(jc, js, images).image_ids
    pseudo = {ids[0]: [{"bbox": [1.0, 2.0, 10.0, 12.0], "category_id": js[0].new_ids[0]},
                       {"bbox": [5.0, 5.0, 3.0, 4.0], "category_id": js[0].new_ids[1]}]}
    j = jd.ILDataset(jc, js, images, pseudo_labels=pseudo)
    t = td.ILDataset(tc, ts, images, pseudo_labels=pseudo)
    assert _all_annotations(t) == _all_annotations(j)
    assert t.load_annotations(0)[2] == 2


def test_replay_and_bic_datasets_match_jax(toy):
    (jc, js, jd), (tc, ts, td) = _datasets(toy, [3, 2])
    images = toy[1]
    j = jd.ReplayDataset(jc, js, images, per_num=1, seed=5)
    t = td.ReplayDataset(tc, ts, images, per_num=1, seed=5)
    j.reset_by_state(1)
    t.reset_by_state(1)
    assert t.image_ids == j.image_ids and t.seen_class_ids == j.seen_class_ids
    assert _all_annotations(t) == _all_annotations(j)
    j.reset_explicit(1, j.image_ids[:2], 1)
    t.reset_explicit(1, t.image_ids[:2], 1)
    assert (t.image_ids, t.seen_class_ids, t.cur_state) == (j.image_ids, j.seen_class_ids, j.cur_state)
    seen = [[1, 2], [3], [1, 2, 3, 4, 5]]
    ids = sorted(jc.imgs)[:3]
    jb = jd.BicDataset(jc, js, images, ids, seen)
    tb = td.BicDataset(tc, ts, images, ids, seen)
    assert _all_annotations(tb) == _all_annotations(jb)


# ------------------------------------------------------------------ loader

LAYOUTS = {"float32": {}, "s2d": {"s2d_stem": True},
           "fused_uint8": {"fused_stem": True, "transfer_dtype": "uint8"}}


def _loader_pair(toy, layout, workers, scenario=(5,), batch_size=3, **data):
    """JAX's loader (no workers, no prefetch) and the port's, on the same
    dataset, with hflip and the wrap-around fill."""
    (jc, js, jd), (tc, ts, td) = _datasets(toy, list(scenario))
    kw = {**dict(batch_size=batch_size, min_side=48, max_side=64, height=64, width=64,
                 max_boxes=4, hflip_prob=0.5), **LAYOUTS[layout], **data}
    j = jloader.BatchLoader(jd.ILDataset(jc, js, toy[1]), jcfg.DataConfig(**kw), seed=9,
                            prefetch=0, num_workers=0)
    t = tloader.BatchLoader(td.ILDataset(tc, ts, toy[1]), tcfg.DataConfig(**kw), seed=9,
                            prefetch=2, num_workers=workers)
    return j, t


def _assert_batches_equal(t, j):
    assert len(t) == len(j) > 0
    for bt, bj in zip(t, j):
        for field in ("images", "boxes", "labels", "num_boxes", "num_pseudo", "scales",
                      "image_ids"):
            a, b = getattr(bt, field), getattr(bj, field)
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert bt.is_replay == bj.is_replay


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loader_bit_equal_to_jax(toy, layout, workers):
    """Two epochs; 10 images in batches of 3 (the last one wraps around),
    max_boxes 4 (truncation)."""
    j, t = _loader_pair(toy, layout, workers)
    assert len(t) == len(j) == 4
    for epoch in (1, 2):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        _assert_batches_equal(list(t), list(j))
    assert len(t.batch_seconds) == 4


def test_loader_shape_buckets_bit_equal_to_jax(toy):
    """A (48, 64) bucket: landscape images land in 48 x 64 frames, portrait
    ones in 64 x 48, the batches stay frame-homogeneous."""
    j, t = _loader_pair(toy, "float32", 2, height=64, width=96, shape_buckets=((48, 64),),
                        batch_size=2)
    t.set_epoch(3)
    j.set_epoch(3)
    bt, bj = list(t), list(j)
    _assert_batches_equal(bt, bj)
    assert {b.images.shape[1:3] for b in bt} == {(48, 64), (64, 48)}


def test_loader_abandoned_iterator_stops_its_thread(toy):
    import threading
    import time

    _, t = _loader_pair(toy, "float32", 2)
    before = threading.active_count()
    it = iter(t)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before + 2 and time.time() < deadline:
        time.sleep(0.05)
    # the prefetch thread is gone (the worker pool's threads stay for reuse)
    assert threading.active_count() <= before + 2
