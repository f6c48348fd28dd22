"""The port's record and file iterators against the JAX package's on the
same files: ``ImageRecordIter`` (its threaded fast path and the general
augmenter path), ``ImageRecordUInt8Iter``, ``ImageDetIter`` and
``ImageDetRecordIter``, ``CSVIter``, ``LibSVMIter`` and ``MNISTIter``
(scenarios of tests/test_io_pipeline.py and tests/test_detection.py), and
three SSD300 train steps fed by ``ImageDetRecordIter``.

Batches are equal byte for byte, with one exception: a bilinear resize
(``imresize``: the general path's ``resize``, the detection iterators'
final force-resize) sums its float32 weights in numpy's order where the
JAX package sums them in XLA's, so resized pixels agree within 1e-3 of
the 0..255 scale (float images) or one level (uint8 images). Python's
``random`` and numpy's global stream are seeded the same before each
package runs."""
import gzip
import io as _io
import os
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.image import detection as tdet
from mxnet_tpu_torch.image import image as timage
from mxnet_tpu_torch.image.recordio_iter import _FastRecordIter

PKGS = {"jax": jmx, "torch": mx}
RESIZE_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _pack(tmp_path, n=12, edge=40, name="imgs"):
    from PIL import Image

    prefix = str(tmp_path / name)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (edge, edge, 3), np.uint8)
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        header = recordio.IRHeader(0, float(i % 5), i, 0)
        rec.write_idx(i, recordio.pack(header, buf.getvalue()))
    rec.close()
    return prefix


def _pack_gray(tmp_path, n=6, edge=40):
    prefix = str(tmp_path / "gray")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(1)
    for i in range(n):
        buf = _io.BytesIO()
        np.save(buf, rng.randint(0, 255, (edge, edge), np.uint8),
                allow_pickle=False)
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                       buf.getvalue()))
    rec.close()
    return prefix


def _seed(s=0):
    random.seed(s)
    np.random.seed(s)


def _batches(it, limit=None):
    out = []
    for i, b in enumerate(it):
        if limit is not None and i >= limit:
            break
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                    b.pad))
    return out


def _both(make, limit=None, seed=0):
    """Each package's batches from ``make(pkg)``, seeded the same."""
    out = {}
    for name, pkg in PKGS.items():
        _seed(seed)
        it = make(pkg)
        try:
            out[name] = _batches(it, limit)
        finally:
            close = getattr(getattr(it, "_iter", None), "close", None)
            if callable(close):
                close()
    return out["torch"], out["jax"]


def _assert_equal(got, want, atol=0.0):
    assert len(got) == len(want) and got
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.shape == wd.shape and gd.dtype == wd.dtype and gp == wp
        if atol:
            np.testing.assert_allclose(gd, wd, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------------------
# ImageRecordIter
# ---------------------------------------------------------------------------
def test_fast_path_shapes_and_labels(tmp_path):
    prefix = _pack(tmp_path)
    it = mx.io.ImageRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        batch_size=4, data_shape=(3, 32, 32), preprocess_threads=2)
    assert isinstance(it._iter.iters[0], _FastRecordIter)
    assert it.provide_data[0].shape == (4, 3, 32, 32)
    seen, labels = 0, []
    for batch in it:
        assert batch.data[0].shape == (4, 3, 32, 32)
        assert batch.data[0].context.device_type == "cpu"
        labels.extend(batch.label[0].asnumpy().tolist())
        seen += 4 - batch.pad
    it._iter.close()
    assert seen == 12
    assert sorted(labels[:12]) == sorted(float(i % 5) for i in range(12))


def test_fast_path_matches_general_path(tmp_path):
    prefix = _pack(tmp_path)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              batch_size=3, data_shape=(3, 32, 32), mean_r=123.0,
              mean_g=117.0, mean_b=104.0, std_r=58.0, std_g=57.0, std_b=57.0)
    fast = mx.io.ImageRecordIter(preprocess_threads=2, **kw)
    slow = mx.io.ImageRecordIter(force_general_path=True, **kw)
    assert isinstance(fast._iter.iters[0], _FastRecordIter)
    assert not isinstance(slow._iter.iters[0], _FastRecordIter)
    for bf, bs in zip(fast, slow):
        np.testing.assert_allclose(bf.data[0].asnumpy(),
                                   bs.data[0].asnumpy(), atol=1e-3)
        np.testing.assert_array_equal(bf.label[0].asnumpy(),
                                      bs.label[0].asnumpy())
    fast._iter.close()
    slow._iter.close()


NORM = dict(mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
            std_g=57.0, std_b=57.0)
RECORD_CASES = {
    "fast_plain": dict(preprocess_threads=2),
    "fast_norm": dict(preprocess_threads=2, **NORM),
    "fast_augment": dict(edge=48, rand_crop=True, rand_mirror=True,
                         shuffle=True, seed=5, preprocess_threads=2),
    "fast_resize": dict(edge=48, resize=36, rand_crop=True, seed=2,
                        preprocess_threads=1),
    "fast_partition": dict(part_index=1, num_parts=2, shuffle=True, seed=3,
                           preprocess_threads=1),
    "general_norm": dict(force_general_path=True, **NORM),
    "general_augment": dict(edge=48, force_general_path=True,
                            rand_crop=True, rand_mirror=True, shuffle=True,
                            seed=7),
    "general_partition": dict(force_general_path=True, part_index=0,
                              num_parts=3, shuffle=True, seed=4),
    "general_resize": dict(edge=48, force_general_path=True, resize=40),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_image_record_iter_matches_jax(tmp_path, case):
    kw = dict(RECORD_CASES[case])
    prefix = _pack(tmp_path, edge=kw.pop("edge", 40))
    got, want = _both(lambda pkg: pkg.io.ImageRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        batch_size=4, data_shape=(3, 32, 32), **kw))
    # the general path resizes the uint8 image: one level
    _assert_equal(got, want, 1.0 if case == "general_resize" else 0.0)


def test_uint8_iter_and_grayscale_records_match_jax(tmp_path):
    prefix = _pack(tmp_path)
    got, want = _both(lambda pkg: pkg.io.ImageRecordUInt8Iter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        batch_size=4, data_shape=(3, 24, 24), preprocess_threads=1))
    _assert_equal(got, want)
    gray = _pack_gray(tmp_path)
    got, want = _both(lambda pkg: pkg.io.ImageRecordIter(
        path_imgrec=gray + ".rec", path_imgidx=gray + ".idx", batch_size=3,
        data_shape=(3, 32, 32), preprocess_threads=2))
    _assert_equal(got, want)
    np.testing.assert_array_equal(got[0][0][:, 0], got[0][0][:, 2])


def test_record_iter_seed_and_partition(tmp_path):
    prefix = _pack(tmp_path)

    def order(seed, **kw):
        it = mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            batch_size=4, data_shape=(3, 32, 32), shuffle=True,
            preprocess_threads=1, seed=seed, **kw)
        out = []
        for b in it:
            out.extend(b.label[0].asnumpy().tolist()[:4 - b.pad])
        it._iter.close()
        return out

    assert order(1) != order(2) and order(3) == order(3)
    a, b = order(0, part_index=0, num_parts=2), order(0, part_index=1,
                                                      num_parts=2)
    assert len(a) == len(b) == 6
    assert sorted(a + b) == sorted(float(i % 5) for i in range(12))


@pytest.mark.parametrize("shape,size,interp", [
    ((40, 40, 3), (28, 24), 1), ((17, 23, 1), (40, 31), 1),
    ((40, 40, 3), (28, 24), 0), ((9, 30, 3), (30, 9), 0)])
def test_imresize_matches_jax(shape, size, interp):
    from mxnet_tpu.image import image as jimage

    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    w, h = size
    got = timage.imresize(mx.nd.array(img, dtype=np.uint8), w, h,
                          interp).asnumpy()
    want = jimage.imresize(jmx.nd.array(img, dtype=np.uint8), w, h,
                           interp).asnumpy()
    assert got.shape == want.shape == (h, w, shape[2])
    assert got.dtype == want.dtype == np.uint8
    if interp:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)
    f = img.astype(np.float32)
    got = timage.imresize(f, w, h, interp).asnumpy()
    want = np.asarray(jimage.imresize(f, w, h, interp).asnumpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


# ---------------------------------------------------------------------------
# CSV, LibSVM, MNIST
# ---------------------------------------------------------------------------
def test_csv_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    data, label = rng.rand(10, 6).astype(np.float32), rng.randint(0, 3, 10)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for kw in (dict(round_batch=True), dict(round_batch=False)):
        got, want = _both(lambda pkg: pkg.io.CSVIter(
            data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
            label_csv=str(tmp_path / "l.csv"), batch_size=4, **kw))
        _assert_equal(got, want)
    got, want = _both(lambda pkg: pkg.io.CSVIter(
        data_csv=str(tmp_path / "d.csv"), data_shape=(6,), batch_size=5))
    _assert_equal(got, want)


def test_libsvm_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    lines = []
    for i in range(9):
        cols = sorted(rng.choice(12, 4, replace=False))
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%.4f" % (c, rng.rand()) for c in cols)))
    path = tmp_path / "d.libsvm"
    path.write_text("\n".join(lines) + "\n\n")
    got, want = _both(lambda pkg: pkg.io.LibSVMIter(
        data_libsvm=str(path), data_shape=(12,), batch_size=4))
    _assert_equal(got, want)
    assert len(got) == 2


def _write_mnist(root, n=20, gz=False):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = os.path.join(root, "img-idx3-ubyte" + suffix)
    lab_path = os.path.join(root, "lab-idx1-ubyte" + suffix)
    with opener(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img_path, lab_path


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter_matches_jax(tmp_path, gz, flat, shuffle):
    img, lab = _write_mnist(str(tmp_path), gz=gz)
    got, want = _both(lambda pkg: pkg.io.MNISTIter(
        image=img, label=lab, batch_size=6, flat=flat, shuffle=shuffle,
        seed=3))
    _assert_equal(got, want)
    assert got[0][0].shape == ((6, 784) if flat else (6, 1, 28, 28))
    with open(lab, "rb") as f:
        raw = f.read()
    bad = str(tmp_path / "bad-idx1-ubyte")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 8 + raw[8:] if not gz else b"\x00" * 8)
    with pytest.raises(mx.base.MXNetError, match="bad MNIST label magic"):
        mx.io.MNISTIter(image=img, label=bad, batch_size=6)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------
def _det_dataset(tmp_path, n=12, size=64):
    """One colored box per image, class = color; labels in the detection
    format [2, 5, cls, x1, y1, x2, y2], packed as im2rec --pack-label
    packs them."""
    from PIL import Image

    rng = np.random.RandomState(0)
    prefix = str(tmp_path / "det")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = np.full((size, size, 3), 220, np.uint8)
        cls = int(rng.randint(0, 2))
        w, h = rng.randint(size // 4, size // 2, 2)
        x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
        img[y0:y0 + h, x0:x0 + w] = (255, 40, 40) if cls == 0 \
            else (40, 40, 255)
        label = [2, 5, cls, x0 / size, y0 / size, (x0 + w) / size,
                 (y0 + h) / size]
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, label, i, 0),
                                       buf.getvalue()))
    rec.close()
    return prefix


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    return _det_dataset(tmp_path_factory.mktemp("detdata"))


DET_CASES = {
    "plain": (dict(data_shape=(3, 64, 64)), 0.0),
    "resize": (dict(data_shape=(3, 96, 96)), RESIZE_ATOL),
    "augment": (dict(data_shape=(3, 64, 64), rand_mirror=True,
                     rand_crop=0.5, rand_pad=0.5, shuffle=True, mean=True,
                     std=True), RESIZE_ATOL)}


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_image_det_iter_matches_jax(det_rec, case):
    kw, atol = DET_CASES[case]
    got, want = _both(lambda pkg: pkg.image.ImageDetIter(
        batch_size=4, path_imgrec=det_rec + ".rec", **kw))
    _assert_equal(got, want, atol)
    lab = got[0][1]
    assert lab.shape == (4, 1, 5)
    assert set(np.unique(lab[:, :, 0])) <= {0.0, 1.0}


def test_image_det_record_iter_matches_jax(det_rec):
    kw = dict(path_imgrec=det_rec + ".rec", batch_size=2,
              data_shape=(3, 80, 80), rand_mirror_prob=0.5,
              rand_crop_prob=0.3, min_object_covered=0.5, mean_r=123.0,
              mean_g=117.0, mean_b=104.0, label_pad_width=10)
    got, want = _both(lambda pkg: pkg.io.ImageDetRecordIter(**kw))
    _assert_equal(got, want, RESIZE_ATOL)
    assert got[0][1].shape == (2, 2, 5)


def test_det_augmenters_keep_boxes_consistent():
    img = np.zeros((80, 80, 3), np.float32)
    img[20:60, 30:70] = 200.0
    label = np.array([[0, 30 / 80, 20 / 80, 70 / 80, 60 / 80]], np.float32)
    fimg, flab = tdet.DetHorizontalFlipAug(p=1.0)(img.copy(), label.copy())
    assert np.allclose(flab[0, 1], 1 - label[0, 3])
    x0, x1 = int(flab[0, 1] * 80), int(flab[0, 3] * 80)
    assert fimg[40, (x0 + x1) // 2, 0] == 200.0
    crop = tdet.DetRandomCropAug(min_object_covered=0.5, max_attempts=50)
    for _ in range(5):
        _cimg, clab = crop(img.copy(), label.copy())
        assert clab.shape[1] == 5 and clab.shape[0] >= 1
        assert np.all(clab[:, 1:] >= -1e-6) and np.all(clab[:, 1:] <= 1 + 1e-6)
    pimg, plab = tdet.DetRandomPadAug(max_attempts=50)(img.copy(),
                                                       label.copy())
    y0, y1 = int(plab[0, 2] * pimg.shape[0]), int(plab[0, 4] * pimg.shape[0])
    x0, x1 = int(plab[0, 1] * pimg.shape[1]), int(plab[0, 3] * pimg.shape[1])
    assert pimg[(y0 + y1) // 2, (x0 + x1) // 2, 0] == 200.0
    augs = tdet.CreateDetAugmenter((3, 64, 64), rand_crop=0.5, rand_pad=0.5,
                                   rand_mirror=True, mean=True, std=True)
    a_img, a_lab = img.copy(), label.copy()
    for aug in augs:
        a_img, a_lab = aug(a_img, a_lab)
    assert a_lab.shape[1] == 5


def test_image_det_record_iter_feeds_ssd_training(det_rec):
    """Three SSD300 train steps (MultiBoxTarget) from ImageDetRecordIter
    with augmentation: finite outputs, a positive anchor per image."""
    from mxnet_tpu_torch.models import ssd

    _seed(0)
    it = mx.io.ImageDetRecordIter(
        path_imgrec=det_rec + ".rec", batch_size=2, data_shape=(3, 300, 300),
        rand_mirror_prob=0.5, rand_crop_prob=0.3, min_object_covered=0.5,
        mean_r=123.0, mean_g=117.0, mean_b=104.0)
    assert it.provide_data[0].shape == (2, 3, 300, 300)
    mod = mx.mod.Module(ssd.get_symbol_train(num_classes=2),
                        data_names=("data",), label_names=("label",),
                        context=mx.cpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 1e-3})
    losses = []
    for i, batch in enumerate(it):
        if i >= 3:
            break
        mod.forward_backward(batch)
        mod.update()
        cls_prob, loc_loss, cls_target = [o.asnumpy()
                                          for o in mod.get_outputs()]
        assert np.all(np.isfinite(cls_prob)) and np.all(np.isfinite(loc_loss))
        assert np.all((cls_target > 0).sum(axis=1) >= 1)
        losses.append(float(np.abs(loc_loss).sum()))
    it.close()
    assert len(losses) == 3 and all(np.isfinite(losses))
