"""Item 7b's tensor ops over the batch axis under a data-parallel mesh (the
rule C7's repair set), on 2 gloo ranks on the CPU.

Inside ``spmd_scope`` each rank holds its 4 rows of a global batch of 8
(each row (3, 4)). An op that reduces, reorders or moves axis 0 raises by
name there: cumsum, nansum, nanprod and ``_square_sum`` over axis 0 or
all axes; sort, argsort and topk along axis 0; flip of axis 0,
``SequenceReverse`` and shuffle (always axis 0); tile and pad of axis 0,
tile with a new leading axis, stack and ``SliceChannel`` on axis 0; the
``slice*`` and ``_slice_assign*`` that cut axis 0; gather_nd, scatter_nd
and ``_scatter_set_nd`` (their indices address axis 0); ``reshape_like``
(its target is a literal shape, checked as a ``Reshape``'s); khatri_rao,
diag and the ``_linalg_*`` on a 2-D operand (axis 0 is a matrix axis);
``SequenceMask``/``SequenceLast`` time-major (axis 0: the batch is axis 1
there, as for ``RNN``) and pick along axis 0. The same ops on other axes,
``repeat`` along axis 0 (each row's copies follow it) and the row-wise
ops give the rank's rows of the whole batch's result: floats at rtol
1e-6, indices and copies bit for bit.

C8, repaired: ``dot(..., transpose_a=True)`` on a batch-leading input
would contract axis 0, each rank its own rows (a partial sum): it raises
by name. The executor marks which tensors are batch-leading (the data and
labels the scope shards, and what keeps their axis 0 first): run by it, a
``dot(transpose_a=True)`` of weights, a reduction over a weight's axis 0,
and ``MultiBoxPrior``'s anchors (no batch rows) run and give the single
device's result, while the same on the data raises.

Items 7c and 7d, called directly: the RoI poolings and proposals (their
batch-index column addresses axis 0) raise by name; MultiBoxTarget,
MultiBoxDetection, ctc_loss (batch on axis 1), count_sketch, fft/ifft and
the quantize ops give the rank's rows.
"""
import numpy as np
import pytest
import torch

import torch_dp_workers as w

RANK_TIMEOUT = 120
WORLD = 2

RAISE = ("cumsum-axis0", "cumsum-all", "nansum-axis0", "nansum-all",
         "nanprod-axis0", "_square_sum-axis0", "_square_sum-all",
         "sort-axis0", "argsort-axis0", "topk-axis0", "flip-axis0",
         "SequenceReverse", "shuffle", "tile-axis0", "tile-new-axis",
         "pad-axis0", "stack-axis0", "SliceChannel-axis0", "slice-axis0",
         "slice_axis-axis0", "slice_like-axis0", "_slice_assign-axis0",
         "_slice_assign_scalar-axis0", "gather_nd", "scatter_nd",
         "_scatter_set_nd", "reshape_like", "khatri_rao", "diag-2d",
         "_linalg_gemm2-2d", "_linalg_syrk-2d", "_linalg_extractdiag-2d",
         "SequenceMask-axis0", "SequenceLast-axis0", "pick-axis0")
ROWS = ("cumsum-axis1", "nansum-axis1", "nanprod-axis2",
        "_square_sum-axis1", "sort-axis1", "argsort-axis2", "topk-axis1",
        "flip-axis1", "tile-axis1", "repeat-axis0", "repeat-axis2",
        "pad-axis2", "stack-axis1", "SliceChannel-axis1", "slice-axis1",
        "slice_axis-axis2", "slice_like-axis1", "_slice_assign-axis2",
        "_slice_assign_scalar-axis1", "diag-3d", "_linalg_gemm2-3d",
        "_linalg_syrk-3d", "SequenceMask-axis1", "SequenceLast-axis1",
        "pick-axis1", "batch_take", "Embedding", "where", "smooth_l1",
        "broadcast_hypot", "depth_to_space", "add_n")
EXACT = ("sort-axis1", "argsort-axis2", "topk-axis1", "flip-axis1",
         "tile-axis1", "repeat-axis0", "repeat-axis2", "pad-axis2",
         "stack-axis1", "SliceChannel-axis1", "slice-axis1",
         "slice_axis-axis2", "slice_like-axis1", "_slice_assign-axis2",
         "_slice_assign_scalar-axis1", "diag-3d", "SequenceMask-axis1",
         "SequenceLast-axis1", "pick-axis1", "batch_take", "Embedding",
         "where", "depth_to_space")
RAISE_7CD = ("ROIPooling", "PSROIPooling", "DeformablePSROIPooling",
             "Proposal", "MultiProposal")
ROWS_7CD = ("MultiBoxTarget", "MultiBoxDetection", "ctc_loss",
            "count_sketch", "fft", "ifft", "quantize", "dequantize",
            "quantize_2bit")
EXACT_7CD = ("MultiBoxTarget", "MultiBoxDetection", "quantize",
             "dequantize")
C8 = ("dot-transpose_a",)
GRAPH_ROWS = ("dot-weights", "dot-weights-alone", "sum-axis0-weight",
              "MultiBoxPrior-sum-axis0")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_batch_axis")
    ctx = w.start_ranks("tensor_batch_axis_worker", WORLD, out)
    return w.join_ranks(ctx, out, RANK_TIMEOUT)


def test_every_case_is_classified():
    assert sorted(RAISE + ROWS + C8) == sorted(w.tensor_batch_axis_cases())
    assert set(EXACT) <= set(ROWS)
    assert sorted(RAISE_7CD + ROWS_7CD) == \
        sorted(w.contrib_batch_axis_cases())
    assert set(EXACT_7CD) <= set(ROWS_7CD)
    assert sorted(w.GRAPH_RAISE + w.GRAPH_WHOLE + GRAPH_ROWS) == \
        sorted(w.graph_batch_axis_cases())


def _raised(ranks, name, op):
    for r in ranks:
        kind, msg = r[name][0]
        assert kind == "raised", (name, msg)
        assert msg.startswith("MXNetError") and op in msg, msg
        assert "data-parallel" in msg, msg


def _rows(ranks, name, exact):
    for rank, r in enumerate(ranks):
        (kind, got), whole = r[name]
        assert kind == "ok", (name, got)
        rows = whole.shape[0] // WORLD
        want = whole[rank * rows:(rank + 1) * rows]
        if exact:
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("name", RAISE)
def test_raises_by_name_under_the_scope(ranks, name):
    _raised(ranks, name, name.split("-")[0])


@pytest.mark.parametrize("name", ROWS)
def test_gives_the_ranks_rows_of_the_whole_batch(ranks, name):
    _rows(ranks, name, name in EXACT)


def test_c8_dot_transpose_a_contracts_each_ranks_rows_only(ranks):
    """C8, repaired: ``dot(transpose_a=True)`` on batch-leading rows would
    contract each rank's rows only (2 ranks: each result 0.7643 of the
    whole batch's away, relative L2); it raises by name, called directly
    and inside the executor, where the data are batch-leading."""
    _raised(ranks, "dot-transpose_a", "dot")
    _raised(ranks, "graph:dot-transpose_a-data", "dot")


@pytest.mark.parametrize("name", RAISE_7CD)
def test_7cd_raises_by_name_under_the_scope(ranks, name):
    _raised(ranks, name, name)


@pytest.mark.parametrize("name", ROWS_7CD)
def test_7cd_gives_the_ranks_rows_of_the_whole_batch(ranks, name):
    _rows(ranks, name, name in EXACT_7CD)


@pytest.mark.parametrize("name", w.GRAPH_RAISE)
def test_executor_raises_on_the_batch_leading_data(ranks, name):
    _raised(ranks, "graph:" + name, name.split("-")[0])


@pytest.mark.parametrize("name", GRAPH_ROWS)
def test_executor_runs_weights_and_anchors_as_one_device(ranks, name):
    """A ``dot(transpose_a=True)`` of weights, a sum over a weight's axis
    0 and over MultiBoxPrior's anchors: not batch rows, so the executor
    runs them, and the graph gives the rank's rows of one device's."""
    _rows(ranks, "graph:" + name, False)


@pytest.mark.parametrize("name", w.GRAPH_WHOLE)
def test_executor_output_that_is_no_batch_rows_is_the_whole(ranks, name):
    for r in ranks:
        (kind, got), whole = r["graph:" + name]
        assert kind == "ok", got
        assert torch.equal(got, whole), name


def test_dot_of_a_marked_rhs_raises_and_a_weight_rhs_runs():
    """The rule on the rhs, with the executor's marks given by hand: a
    batch-leading ``rhs`` without ``transpose_b`` would contract its axis
    0; unmarked (called directly) the rhs counts as a weight."""
    from mxnet_tpu_torch.kernels.fused_block import (batch_operands,
                                                     spmd_scope)
    from mxnet_tpu_torch.ops import nn, registry
    from mxnet_tpu_torch import MXNetError

    dot = registry.get("dot").fn
    a, b = torch.ones(2, 4), torch.ones(4, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "dp_group", lambda: (object(), 2))
        with spmd_scope(None, ("dp",)):
            assert dot(a, b).shape == (2, 3)
            with batch_operands((False, True)):
                with pytest.raises(MXNetError, match="rhs.*data-parallel"):
                    dot(a, b)
                assert dot(a, b.t(), transpose_b=True).shape == (2, 3)
            with batch_operands((True, False)):
                with pytest.raises(MXNetError, match="data-parallel"):
                    dot(b, b, transpose_a=True)
            with batch_operands((False, False)):
                assert dot(b, b, transpose_a=True).shape == (3, 3)

