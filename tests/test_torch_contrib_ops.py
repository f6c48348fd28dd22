"""The contrib and region-based vision ops of the port's 7d slice against
the JAX package's, on the CPU.

Each of the 17 names of ``mxnet_tpu/ops/contrib.py`` and
``mxnet_tpu/ops/vision.py`` is run on ``tests/test_op_sweep.py``'s spec
for it and on the cases of ``tests/test_vision.py`` and
``tests/test_golden_contrib.py``: the same numpy inputs through the JAX op
(its registry function) and the port's, outputs held together at rtol
1e-4 / atol 1e-5 (integers and masks exactly), then, for the names the
JAX registry does not mark ``nondiff``, the gradient of every float input
the case differentiates, for one seeded cotangent an output, against
``jax.vjp`` of the JAX op.

Then the places the JAX package's behaviour is kept (ROADMAP.md Queue C):
``MultiBoxTarget``'s forced matches whose scatter has duplicate indices
(the last label row wins, so padded rows cancel an earlier box's forced
match at anchor 0), its ignored hard-negative mining and first-index
ties; ``MultiBoxDetection`` over SSD300's full 8732 anchors against the
JAX ``fori_loop``, with the kept boxes exactly equal (scores and boxes
within a rounding of ``exp``), ``nms_topk`` ignored; ``ROIPooling``'s
gradient split among tied maxima and its chunks; ``ctc_loss``'s label
count. Then each op's Symbol JSON and inferred shapes, and chip_smoke's
copy of the sweep specs held equal to the sweep's.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import vision as tvision
from test_op_sweep import ALIAS_SPECS, SPECS
from test_torch_ops_coverage import CONTRIB_7D, RANDOM_7C
from test_torch_tensor_ops import _grad_pair, _infer, _outputs, _sym_json

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _spec(name):
    return SPECS.get(name) or SPECS[ALIAS_SPECS[name]]


def _run_both(name, inputs, attrs):
    jop, top = jreg.get(name), treg.get(name)
    jattrs = jop.parse_attrs(dict(attrs))
    assert top.parse_attrs(dict(attrs)) == jattrs
    jouts = _outputs(jop.fn(*[jnp.asarray(x) for x in inputs], **jattrs))
    touts = _outputs(top.fn(*[torch.tensor(x) for x in inputs], **jattrs))
    assert len(touts) == len(jouts) == jop.n_outputs(jattrs)
    return [t.numpy() for t in touts], [np.asarray(j) for j in jouts]


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind in "iub":
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


# (case id, name, inputs, attrs, differentiated inputs or None)
def _rng(seed):
    return np.random.RandomState(seed)


def _golden_cases():
    r = _rng(0)
    rois3 = np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6], [0, 1, 3, 5, 7]],
                     np.float32)
    const = np.zeros((1, 8, 6, 6), np.float32)
    for c in range(8):
        const[0, c] = c
    cases = [
        ("ROIPooling-3rois", "ROIPooling",
         [r.randn(2, 3, 8, 8).astype(np.float32), rois3],
         {"pooled_size": (2, 2), "spatial_scale": 1.0}, (0,)),
        ("ROIPooling-scale-3x3", "ROIPooling",
         [_rng(1).randn(2, 4, 10, 12).astype(np.float32),
          np.array([[1, 3, 2, 18, 15], [0, 0, 0, 23, 19],
                    [1, 5, 5, 5, 5]], np.float32)],
         {"pooled_size": (3, 3), "spatial_scale": 0.5}, (0,)),
        ("PSROIPooling-uniform", "_contrib_PSROIPooling",
         [const, np.array([[0, 0, 0, 5, 5]], np.float32)],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 2}, None),
        ("PSROIPooling-golden", "_contrib_PSROIPooling",
         [_rng(2).randn(2, 18, 9, 9).astype(np.float32),
          np.array([[0, 1, 1, 7, 6], [1, 0, 2, 8, 8], [0, 3, 3, 3, 3]],
                   np.float32)],
         {"spatial_scale": 0.9, "output_dim": 2, "pooled_size": 3}, (0,)),
        ("DeformablePSROIPooling-no_trans",
         "_contrib_DeformablePSROIPooling",
         [const[:, :4], np.array([[0, 0, 0, 5, 5]], np.float32),
          np.zeros((1, 2, 2, 2), np.float32)],
         {"spatial_scale": 1.0, "output_dim": 1, "group_size": 2,
          "pooled_size": 2, "no_trans": True}, None),
        ("DeformablePSROIPooling-trans", "_contrib_DeformablePSROIPooling",
         [_rng(3).rand(2, 8, 7, 7).astype(np.float32),
          np.array([[0, 0, 0, 6, 5], [1, 1, 1, 5, 6]], np.float32),
          (_rng(4).randn(2, 2, 3, 3) * 0.1).astype(np.float32)],
         {"spatial_scale": 1.0, "output_dim": 2, "group_size": 2,
          "pooled_size": 3, "part_size": 3, "sample_per_part": 2,
          "trans_std": 0.2}, (0, 2)),
        ("DeformableConvolution-zero-offset",
         "_contrib_DeformableConvolution",
         [r.randn(2, 4, 7, 7).astype(np.float32),
          np.zeros((2, 18, 5, 5), np.float32),
          r.randn(6, 4, 3, 3).astype(np.float32)],
         {"kernel": (3, 3), "num_filter": 6, "no_bias": True}, (0, 2)),
        ("Proposal-golden", "_contrib_Proposal",
         [_rng(0).uniform(0, 1, (1, 6, 4, 4)).astype(np.float32),
          (_rng(1).randn(1, 12, 4, 4) * 0.1).astype(np.float32),
          np.array([[64, 64, 1.0]], np.float32)],
         {"feature_stride": 16, "scales": (2.0,), "ratios": (0.5, 1.0, 2.0),
          "rpn_pre_nms_top_n": 20, "rpn_post_nms_top_n": 8,
          "threshold": 0.7, "rpn_min_size": 4}, None),
        ("MultiProposal-2-images-scores", "_contrib_MultiProposal",
         [_rng(5).uniform(0, 1, (2, 6, 5, 6)).astype(np.float32),
          (_rng(6).randn(2, 12, 5, 6) * 0.2).astype(np.float32),
          np.array([[80, 96, 1.0], [70, 90, 1.5]], np.float32)],
         {"feature_stride": 16, "scales": (2.0,), "ratios": (0.5, 1.0, 2.0),
          "rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 12,
          "threshold": 0.6, "rpn_min_size": 2, "output_score": True}, None),
        ("Proposal-dense-suppression-chains", "_contrib_Proposal",
         [_rng(14).uniform(0, 1, (1, 18, 8, 8)).astype(np.float32),
          (_rng(15).randn(1, 36, 8, 8) * 0.3).astype(np.float32),
          np.array([[128, 128, 1.0]], np.float32)],
         {"feature_stride": 16, "scales": (1.0, 2.0, 4.0),
          "ratios": (0.5, 1.0, 2.0), "rpn_pre_nms_top_n": 400,
          "rpn_post_nms_top_n": 60, "threshold": 0.5, "rpn_min_size": 2,
          "output_score": True}, None),
        ("MultiProposal-tied-scores", "_contrib_MultiProposal",
         [np.round(_rng(16).uniform(0, 1, (2, 6, 5, 5)), 1)
          .astype(np.float32),
          (_rng(17).randn(2, 12, 5, 5) * 0.2).astype(np.float32),
          np.array([[80, 80, 1.0], [80, 80, 1.0]], np.float32)],
         {"feature_stride": 16, "scales": (2.0,), "ratios": (0.5, 1.0, 2.0),
          "rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 30,
          "threshold": 0.4, "rpn_min_size": 2, "output_score": True}, None),
        # no box suppresses itself at threshold 1: the first kept one stays
        # the argmax of every later round
        ("Proposal-threshold-1-repeats", "_contrib_Proposal",
         [_rng(18).uniform(0, 1, (1, 6, 4, 4)).astype(np.float32),
          (_rng(19).randn(1, 12, 4, 4) * 0.1).astype(np.float32),
          np.array([[64, 64, 1.0]], np.float32)],
         {"feature_stride": 16, "scales": (2.0,), "ratios": (0.5, 1.0, 2.0),
          "rpn_pre_nms_top_n": 20, "rpn_post_nms_top_n": 8,
          "threshold": 1.0, "rpn_min_size": 4, "output_score": True}, None),
        ("ctc_loss-blank-first", "_contrib_ctc_loss",
         [_rng(7).randn(6, 3, 5).astype(np.float32),
          np.array([[1, 2, 0], [3, 3, 4], [2, 0, 0]], np.float32)],
         {"blank_label": "first"}, (0,)),
        ("ctc_loss-pad-minus1-lengths", "_contrib_ctc_loss",
         [_rng(8).randn(7, 2, 6).astype(np.float32),
          np.array([[1, 2, 2, -1], [0, 4, -1, -1]], np.float32)],
         {"use_data_lengths": True,
          "data_lengths": np.array([7, 5], np.float32)}, (0,)),
        ("quantize-int8", "_contrib_quantize",
         [_rng(9).uniform(-3, 2, (3, 4)).astype(np.float32),
          np.array([-3.0], np.float32), np.array([2.0], np.float32)],
         {"out_type": "int8"}, None),
        ("dequantize-int8", "_contrib_dequantize",
         [_rng(10).randint(-127, 128, (3, 4)).astype(np.int8),
          np.array([-3.0], np.float32), np.array([2.0], np.float32)], {},
         None),
        ("count_sketch-duplicate-h", "_contrib_count_sketch",
         [_rng(11).randn(3, 6).astype(np.float32),
          np.array([0, 2, 2, 5, 2, 7], np.float32),
          np.array([1, -1, 1, 1, -1, 1], np.float32)], {"out_dim": 5},
         None),
        ("fft-ifft-3d", "_contrib_fft",
         [_rng(12).randn(2, 3, 6).astype(np.float32)], {}, None),
        ("MultiBoxPrior-steps-clip", "_contrib_MultiBoxPrior",
         [np.zeros((1, 2, 5, 7), np.float32)],
         {"sizes": (0.3, 0.6, 0.9), "ratios": (1.0, 2.0, 0.5), "clip": True,
          "steps": (0.2, 0.15), "offsets": (0.4, 0.6)}, None),
        ("MultiBoxDetection-force", "_contrib_MultiBoxDetection",
         [*_detection_inputs(3, 6, 1), ],
         {"force_suppress": True, "threshold": 0.05, "nms_threshold": 0.3},
         None),
        ("MultiBoxDetection-background-2", "_contrib_MultiBoxDetection",
         [*_detection_inputs(4, 5, 2)],
         {"background_id": 2, "clip": False, "nms_topk": 3}, None),
    ]
    return cases


def _detection_inputs(classes, side, seed):
    """(cls_prob, loc_pred, anchor) over a side x side map of 3 anchors a
    centre, 2 images."""
    prior = treg.get("_contrib_MultiBoxPrior").fn
    anc = prior(torch.zeros(1, 1, side, side), sizes=(0.3, 0.5),
                ratios=(1.0, 2.0)).numpy()
    A = anc.shape[1]
    r = _rng(seed)
    logits = r.randn(2, classes, A) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return (prob.astype(np.float32),
            (r.randn(2, A * 4) * 0.2).astype(np.float32), anc)


SWEEP = [(n, n, _spec(n)["inputs"], _spec(n)["attrs"],
          _spec(n).get("diff_args")) for n in CONTRIB_7D]
CASES = SWEEP + _golden_cases()
GRAD_CASES = [c for c in CASES if not jreg.get(c[1]).nondiff]


def test_every_name_has_a_case_and_a_gradient_where_differentiable():
    assert len(CONTRIB_7D) == 17
    assert {c[1] for c in CASES} == set(CONTRIB_7D)
    diff = {n for n in CONTRIB_7D if not jreg.get(n).nondiff}
    assert diff == {"ROIPooling", "_contrib_PSROIPooling",
                    "_contrib_DeformablePSROIPooling",
                    "_contrib_DeformableConvolution", "_contrib_ctc_loss"}
    assert {c[1] for c in GRAD_CASES} == diff


@pytest.mark.parametrize("cid,name,inputs,attrs,diff", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_matches_jax(cid, name, inputs, attrs, diff):
    touts, jouts = _run_both(name, inputs, attrs)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, "%s output %d" % (cid, k))


@pytest.mark.parametrize("cid,name,inputs,attrs,diff", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax(cid, name, inputs, attrs, diff):
    attrs = jreg.get(name).parse_attrs(dict(attrs))
    if diff is None:
        diff = tuple(i for i, x in enumerate(inputs)
                     if np.asarray(x).dtype == np.float32)
    tg, jg = _grad_pair(name, inputs, attrs, diff)
    for i, t, j in zip(diff, tg, jg):
        _close(t, j, "%s gradient of input %d" % (cid, i))


def test_ifft_inverts_fft_times_the_length():
    x = _rng(13).randn(3, 8).astype(np.float32)
    spec = treg.get("_contrib_fft").fn(torch.tensor(x))
    back = treg.get("_contrib_ifft").fn(spec)
    np.testing.assert_allclose(back.numpy(), 8 * x, rtol=1e-5, atol=1e-5)
    touts, jouts = _run_both("_contrib_ifft", [spec.numpy()], {})
    _close(touts[0], jouts[0], "ifft")


# ---------------------------------------------------------------------------
# MultiBoxTarget: the forced matches' duplicate writes, the ignored mining
# ---------------------------------------------------------------------------
def test_multibox_target_forced_match_collisions_keep_the_last_row():
    """Image 0: a box whose best anchor is anchor 0 (IoU 1/3, under the
    threshold) and padded rows after it (their best anchor is anchor 0
    too): the last write wins, so anchor 0 loses its forced match; two
    boxes share best anchor 3, which goes to the later one (class 2) though
    the earlier overlaps it more. Image 1: the box after the pads keeps
    anchor 0."""
    assert np.asarray(jnp.zeros(4, jnp.int32).at[jnp.array([0, 2, 0, 0])]
                      .set(jnp.arange(4)))[0] == 3
    inputs = list(cs.multibox_collision_case(np))
    touts, jouts = _run_both("_contrib_MultiBoxTarget", inputs, {})
    np.testing.assert_array_equal(touts[2], jouts[2])
    np.testing.assert_array_equal(touts[1], jouts[1])
    # box targets: the log of the width and height ratios within a rounding
    # (XLA's log is its own polynomial)
    np.testing.assert_allclose(touts[0], jouts[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(touts[2], [[0, 0, 0, 3], [2, 0, 1, 0]])


def test_multibox_target_ignores_hard_negative_mining_and_ties_first():
    anc = np.array([[[0.0, 0.0, 0.5, 0.5], [0.0, 0.0, 0.5, 0.5],
                     [0.5, 0.5, 1.0, 1.0]]], np.float32)
    lab = np.array([[[3, 0.0, 0.0, 0.5, 0.5], [1, 0.5, 0.5, 1.0, 1.0],
                     [-1, -1, -1, -1, -1]]], np.float32)
    cls = _rng(14).rand(1, 5, 3).astype(np.float32)
    base, jbase = _run_both("_contrib_MultiBoxTarget", [anc, lab, cls], {})
    mined, jmined = _run_both(
        "_contrib_MultiBoxTarget", [anc, lab, cls],
        {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.3,
         "minimum_negative_samples": 2, "ignore_label": -1.0})
    for a, b, c, d in zip(base, mined, jbase, jmined):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)
    # anchors 0 and 1 tie for box 0: its forced match takes anchor 0; both
    # match it by IoU 1; no anchor is -1 (nothing is mined)
    np.testing.assert_array_equal(base[2], [[4, 4, 2]])
    assert (base[2] >= 0).all()


# ---------------------------------------------------------------------------
# MultiBoxDetection at SSD300's full size against the JAX fori_loop
# ---------------------------------------------------------------------------
def _ssd300_anchors():
    from mxnet_tpu_torch.models.ssd import _RATIOS, _SIZES

    prior = treg.get("_contrib_MultiBoxPrior").fn
    return torch.cat([prior(torch.zeros(1, 1, f, f), sizes=s, ratios=r,
                            clip=True)
                      for f, s, r in zip((38, 19, 10, 5, 3, 1), _SIZES,
                                         _RATIOS)], 1).numpy()


@pytest.mark.parametrize("force,ties", [(False, False), (True, True)])
def test_multibox_detection_at_8732_anchors_keeps_exactly_what_jax_keeps(
        force, ties):
    """SSD300's 8732 anchors, 21 classes, one image: the kept boxes and
    their classes equal to the JAX fori_loop's, scores equal, boxes within
    a rounding of exp. ``ties`` rounds the probabilities to 1/64, so many
    scores tie and the stable sort's order is held too. The fixed point
    needs far fewer rounds than boxes."""
    anc = _ssd300_anchors()
    A = anc.shape[1]
    assert A == 8732
    r = _rng(15 + force)
    logits = r.randn(1, 21, A) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if ties:
        prob = np.round(prob * 64) / 64
    prob = prob.astype(np.float32)
    loc = (r.randn(1, A * 4) * 0.2).astype(np.float32)
    tcontrib.nms_rounds[0] = 0
    got = treg.get("_contrib_MultiBoxDetection").fn(
        torch.tensor(prob), torch.tensor(loc), torch.tensor(anc),
        force_suppress=force).numpy()
    rounds = tcontrib.nms_rounds[0]
    want = np.asarray(jreg.get("_contrib_MultiBoxDetection").fn(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anc),
        force_suppress=force))
    assert got.shape == want.shape == (1, A, 6)
    kept = want[..., 0] >= 0
    assert 0 < kept.sum() < A
    np.testing.assert_array_equal(got[..., 0] >= 0, kept)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-6)
    assert rounds < 64, rounds
    print("MultiBoxDetection A=%d force_suppress=%s ties=%s: %d kept, %d "
          "rounds of the fixed point" % (A, force, ties, kept.sum(), rounds))


def test_multibox_detection_has_no_loop_over_boxes():
    """Rounds of the fixed point, not boxes: a chain of boxes each
    suppressing the next alternates kept and suppressed, and needs as many
    rounds as the chain is long; boxes that overlap nothing need one."""
    import inspect

    src = inspect.getsource(tcontrib.multibox_detection) + \
        inspect.getsource(tcontrib._greedy_keep) + \
        inspect.getsource(tcontrib.greedy_nms_indices)
    assert "for i in range(A)" not in src and "fori_loop" not in src
    n = 12
    x = np.arange(n, dtype=np.float32) * 0.05
    boxes = np.stack([x, np.zeros(n), x + 0.1, np.full(n, 0.1)], 1)
    keep = torch.ones(n, dtype=torch.bool)
    sup = tcontrib._suppression(torch.tensor(boxes), 0.3, torch.zeros(n))
    tcontrib.nms_rounds[0] = 0
    kept = tcontrib._greedy_keep(keep, sup)
    assert kept.tolist() == [i % 2 == 0 for i in range(n)]
    assert tcontrib.nms_rounds[0] <= n + tcontrib._CHECK_EVERY


@pytest.mark.parametrize("seed,thresh,max_out", [
    (0, 0.7, 300), (1, 0.5, 40), (2, 0.3, 300), (3, 0.7, 5), (4, 1.0, 12),
    (5, 0.0, 30)])
def test_proposal_nms_is_the_jax_argmax_rounds(seed, thresh, max_out):
    """Proposal's NMS (the fixed point, then the first ``max_out`` kept
    indices) against the JAX package's ``max_out`` argmax rounds on sorted
    candidates with pixel boxes, dead (-inf) ones at the end, and tied
    scores: the indices equal, -1 padding and the repeats of a box that
    does not suppress itself (threshold 1) included."""
    from mxnet_tpu.ops import vision as jvision

    r = _rng(40 + seed)
    n = 600
    xy = r.uniform(0, 200, (n, 2))
    wh = r.uniform(4, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = np.sort(np.round(r.uniform(0, 1, n), 2))[::-1].astype(np.float32)
    scores[-50:] = -np.inf
    got = tcontrib.greedy_nms_indices(
        torch.tensor(boxes), torch.tensor(scores) > -float("inf"), thresh,
        max_out, offset=1.0).numpy()
    want = np.asarray(jvision._nms_keep(jnp.asarray(boxes),
                                        jnp.asarray(scores), thresh, max_out))
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any()


# ---------------------------------------------------------------------------
# ROIPooling: tied maxima, chunks, and the masked tensor it does not build
# ---------------------------------------------------------------------------
def test_roi_pooling_splits_the_gradient_of_tied_maxima_as_jnp_max():
    data = np.ones((1, 2, 6, 6), np.float32)
    data[0, 1, 2:4, 1:5] = 3.0
    rois = np.array([[0, 0, 0, 5, 5], [0, 1, 1, 4, 4]], np.float32)
    attrs = {"pooled_size": (2, 3), "spatial_scale": 1.0}
    touts, jouts = _run_both("ROIPooling", [data, rois], attrs)
    _close(touts[0], jouts[0], "forward")
    tg, jg = _grad_pair("ROIPooling", [data, rois],
                        jreg.get("ROIPooling").parse_attrs(attrs), (0,))
    _close(tg[0], jg[0], "gradient")
    assert len(np.unique(np.round(tg[0][tg[0] != 0], 6))) > 2


def test_roi_pooling_in_chunks_matches_one_chunk(monkeypatch):
    r = _rng(16)
    data = torch.tensor(r.randn(2, 3, 9, 9).astype(np.float32),
                        requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 8, 8], [1, 2, 1, 7, 5], [0, 3, 3, 4, 8],
                         [1, 0, 4, 8, 8], [0, 6, 6, 6, 6]],
                        dtype=torch.float32)
    cot = torch.tensor(r.randn(5, 3, 2, 2).astype(np.float32))
    fn = treg.get("ROIPooling").fn

    def run():
        out = fn(data, rois, pooled_size=(2, 2))
        (g,) = torch.autograd.grad(out, data, cot)
        return out.detach(), g

    whole = run()
    monkeypatch.setattr(tvision, "_CHUNK_ELEMS", 3 * 81 * 2)
    assert len(tvision._chunks(5, 3 * 81)) == 3
    chunked = run()
    assert torch.equal(whole[0], chunked[0])
    torch.testing.assert_close(whole[1], chunked[1], rtol=0, atol=1e-6)


def test_psroi_pooling_in_chunks_matches_one_chunk(monkeypatch):
    inputs, attrs = _golden_cases()[3][2:4]
    fn = treg.get("_contrib_PSROIPooling").fn
    whole = fn(*map(torch.tensor, inputs), **attrs)
    monkeypatch.setattr(tvision, "_CHUNK_ELEMS", 18 * 81)
    torch.testing.assert_close(fn(*map(torch.tensor, inputs), **attrs),
                               whole, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# ctc_loss's label count, quantization round trips
# ---------------------------------------------------------------------------
def test_ctc_loss_counts_labels_in_range_wherever_they_sit():
    """``(lab >= 0) & (lab < C)`` counts the labels: with blank "last" a 0
    is a label, a -1 is not, even between labels (the count shortens, the
    positions do not); with blank "first" the labels shift down by one."""
    data = _rng(17).randn(5, 3, 4).astype(np.float32)
    lab = np.array([[1, 0, 2], [1, -1, 2], [2, 2, -1]], np.float32)
    for blank in ("last", "first"):
        touts, jouts = _run_both("_contrib_ctc_loss", [data, lab],
                                 {"blank_label": blank})
        _close(touts[0], jouts[0], "ctc blank %s" % blank)
        assert np.isfinite(touts[0]).all()


def test_quantize_round_trips_within_a_step():
    x = _rng(18).uniform(-1, 1, (64,)).astype(np.float32)
    lo, hi = np.array([-1.0], np.float32), np.array([1.0], np.float32)
    for out_type, step in (("uint8", 2 / 255), ("int8", 1 / 127)):
        q, qmin, qmax = treg.get("_contrib_quantize").fn(
            *map(torch.tensor, (x, lo, hi)), out_type=out_type)
        back = treg.get("_contrib_dequantize").fn(q, qmin, qmax).numpy()
        assert np.abs(back - x).max() <= step / 2 + 1e-6


# ---------------------------------------------------------------------------
# symbols: JSON and shape inference, the namespaces, chip_smoke's specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONTRIB_7D)
def test_symbol_json_matches_jax(name):
    spec = _spec(name)
    assert _sym_json(mx, name, spec) == _sym_json(jmx, name, spec)


@pytest.mark.parametrize("name", CONTRIB_7D)
def test_shape_inference_matches_jax(name):
    spec = _spec(name)
    got, want = _infer(mx, name, spec), _infer(jmx, name, spec)
    assert [list(map(tuple, g)) for g in got] == \
        [list(map(tuple, w)) for w in want]


def test_contrib_namespaces_hold_the_jax_names():
    for pkg in (mx, jmx):
        for ns in (pkg.nd.contrib, pkg.sym.contrib):
            for name in ("MultiBoxPrior", "MultiBoxTarget",
                         "MultiBoxDetection", "Proposal", "MultiProposal",
                         "PSROIPooling", "DeformableConvolution",
                         "DeformablePSROIPooling", "ctc_loss", "CTCLoss",
                         "fft", "ifft", "quantize", "dequantize",
                         "count_sketch", "quantize_2bit",
                         "dequantize_2bit"):
                assert callable(getattr(ns, name)), (pkg, name)
    x = mx.nd.array(np.zeros((1, 2, 3, 3), np.float32))
    a = mx.nd.contrib.MultiBoxPrior(x, sizes=(0.5,), ratios=(1.0, 2.0))
    b = jmx.nd.contrib.MultiBoxPrior(jmx.nd.array(np.zeros((1, 2, 3, 3))),
                                     sizes=(0.5,), ratios=(1.0, 2.0))
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    assert mx.contrib.ndarray is mx.nd.contrib
    assert mx.contrib.symbol is mx.sym.contrib


def test_multi_output_counts_of_the_symbols():
    for pkg in (mx, jmx):
        v = [pkg.sym.var("v%d" % i) for i in range(3)]
        assert len(pkg.sym.contrib.MultiBoxTarget(*v).list_outputs()) == 3
        assert len(pkg.sym.contrib.Proposal(*v).list_outputs()) == 1
        assert len(pkg.sym.contrib.Proposal(
            *v, output_score=True).list_outputs()) == 2
        assert len(pkg.sym.contrib.DeformablePSROIPooling(
            *v).list_outputs()) == 1
        assert len(pkg.sym.contrib.quantize(*v).list_outputs()) == 3


@pytest.mark.parametrize("name", CONTRIB_7D + RANDOM_7C)
def test_chip_smoke_contrib_spec_is_the_sweeps(name):
    inputs, attrs, diff = cs.contrib_sweep_specs(np)[name]
    spec = _spec(name)
    assert attrs == spec["attrs"]
    assert diff == spec.get("diff_args")
    assert len(inputs) == len(spec["inputs"])
    for a, b in zip(inputs, spec["inputs"]):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))


def test_chip_smoke_contrib_sweep_covers_the_slices():
    assert sorted(cs.contrib_sweep_specs(np)) == \
        sorted(CONTRIB_7D + RANDOM_7C)
    assert sorted(cs.random_moment_cases(np)) == sorted(RANDOM_7C)


def test_the_registered_json_parses_back():
    with mx.name.NameManager():
        s = mx.sym.contrib.MultiBoxDetection(
            mx.sym.var("p"), mx.sym.var("l"), mx.sym.var("a"),
            nms_threshold=0.45, variances=(0.1, 0.1, 0.2, 0.2), name="det")
    back = mx.sym.load_json(s.tojson())
    assert json.loads(back.tojson()) == json.loads(s.tojson())
