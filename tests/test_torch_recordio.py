"""The port's RecordIO (``mxnet_tpu_torch.recordio``) against the JAX
package's: files written by either package read in the other, byte for
byte, plain, indexed and with image record headers."""
import io as _io

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec

PACKAGES = {"jax": jrec, "torch": trec}
PAIRS = [("jax", "torch"), ("torch", "jax")]


def _payloads(seed=0, n=17):
    """Payloads of every length mod 4 (the padding), an empty one and one
    holding the magic word."""
    rng = np.random.RandomState(seed)
    out = [rng.bytes(int(k)) for k in rng.randint(0, 300, n)]
    out += [b"", b"\x0a\x23\xd7\xce" * 3, b"x"]
    return out


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_plain_records_cross_read(tmp_path, writer, reader):
    recs = _payloads()
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / ("%s.rec" % name))
        w = mod.MXRecordIO(paths[name], "w")
        for r in recs:
            w.write(r)
        w.close()
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    r = PACKAGES[reader].MXRecordIO(paths[writer], "r")
    got = []
    while True:
        item = r.read()
        if item is None:
            break
        got.append(item)
    r.close()
    assert got == recs


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_indexed_records_cross_read(tmp_path, writer, reader):
    recs = _payloads(seed=1)
    files = {}
    for name, mod in PACKAGES.items():
        rec, idx = (str(tmp_path / ("%s.%s" % (name, ext)))
                    for ext in ("rec", "idx"))
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, r in enumerate(recs):
            w.write_idx(3 * i + 1, r)
        w.close()
        files[name] = (idx, rec)
    for a, b in zip(files["jax"], files["torch"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    r = PACKAGES[reader].MXIndexedRecordIO(*files[writer], "r")
    assert r.keys == [3 * i + 1 for i in range(len(recs))]
    order = np.random.RandomState(2).permutation(len(recs))
    for i in order:
        assert r.read_idx(3 * int(i) + 1) == recs[int(i)]
    r.close()


@pytest.mark.parametrize("label", [3.5, [1.0, 2.5, -4.0, 0.25]],
                         ids=["scalar", "multi"])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_irheader_pack_unpack_cross(writer, reader, label):
    payload = b"\x01\x02\x03payload"
    packed = {name: mod.pack(mod.IRHeader(0, label, 7, 9), payload)
              for name, mod in PACKAGES.items()}
    assert packed["jax"] == packed["torch"]
    hdr, body = PACKAGES[reader].unpack(packed[writer])
    want, want_body = PACKAGES[writer].unpack(packed[writer])
    assert body == want_body == payload
    assert (hdr.flag, hdr.id, hdr.id2) == (want.flag, want.id, want.id2)
    np.testing.assert_array_equal(np.asarray(hdr.label),
                                  np.asarray(want.label))
    if isinstance(label, list):
        assert hdr.flag == len(label)
        np.testing.assert_array_equal(hdr.label,
                                      np.asarray(label, np.float32))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_image_records_cross(writer, reader):
    """``pack_img`` (PNG: lossless) in one package, ``unpack_img`` in the
    other; the ``.npy`` payload the decoder takes without Pillow too."""
    img = np.random.RandomState(3).randint(0, 256, (12, 10, 3), np.uint8)
    hdr = PACKAGES[writer].IRHeader(0, 2.0, 5, 0)
    rec = PACKAGES[writer].pack_img(hdr, img, img_fmt=".png")
    assert rec == PACKAGES[reader].pack_img(hdr, img, img_fmt=".png")
    got_hdr, got = PACKAGES[reader].unpack_img(rec)
    assert got_hdr.label == 2.0 and got_hdr.id == 5
    np.testing.assert_array_equal(got, img)
    buf = _io.BytesIO()
    np.save(buf, img, allow_pickle=False)
    rec = PACKAGES[writer].pack(hdr, buf.getvalue())
    np.testing.assert_array_equal(PACKAGES[reader].unpack_img(rec)[1], img)


def test_garbage_magic_raises(tmp_path, monkeypatch):
    """Each route words it as the JAX package's same route does."""
    from mxnet_tpu_torch import _native

    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(b"\xde\xad\xbe\xef" + b"\x00" * 12)
    for flag, want in (("1", "invalid record magic"),
                       ("0", "recordio read failed: bad magic")):
        monkeypatch.setenv("MXNET_TPU_NO_NATIVE", flag)
        _native._LIB = None
        r = trec.MXRecordIO(path, "r")
        assert (r._nat is not None) == (flag == "0")
        with pytest.raises(trec.MXNetError, match=want):
            r.read()
        r.close()
    monkeypatch.delenv("MXNET_TPU_NO_NATIVE")
    _native._LIB = None
    with pytest.raises(trec.MXNetError, match="Invalid flag"):
        trec.MXRecordIO(path, "a")
