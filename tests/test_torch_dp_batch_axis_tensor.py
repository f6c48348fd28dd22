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

C8: ``dot(..., transpose_a=True)`` on a batch-leading input contracts
axis 0, and nothing guards it: each rank contracts its own rows, so its
result is a partial sum (the two ranks' results add up to the whole
batch's). The test pins that state and prints the gap (ROADMAP.md Queue
C).
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
C8 = ("dot-transpose_a",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_batch_axis")
    ctx = w.start_ranks("tensor_batch_axis_worker", WORLD, out)
    return w.join_ranks(ctx, out, RANK_TIMEOUT)


def test_every_case_is_classified():
    assert sorted(RAISE + ROWS + C8) == sorted(w.tensor_batch_axis_cases())
    assert set(EXACT) <= set(ROWS)


@pytest.mark.parametrize("name", RAISE)
def test_raises_by_name_under_the_scope(ranks, name):
    op = name.split("-")[0]
    for r in ranks:
        kind, msg = r[name][0]
        assert kind == "raised", (name, msg)
        assert msg.startswith("MXNetError") and op in msg, msg
        assert "data-parallel" in msg, msg


@pytest.mark.parametrize("name", ROWS)
def test_gives_the_ranks_rows_of_the_whole_batch(ranks, name):
    for rank, r in enumerate(ranks):
        (kind, got), whole = r[name]
        assert kind == "ok", (name, got)
        rows = whole.shape[0] // WORLD
        want = whole[rank * rows:(rank + 1) * rows]
        if name in EXACT:
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_c8_dot_transpose_a_contracts_each_ranks_rows_only(ranks):
    """Pins C8 until the guard can tell a batch-leading operand: no rank
    raises, each gives the contraction of its own rows, and the ranks'
    results add up to the whole batch's."""
    parts = []
    for r in ranks:
        (kind, got), whole = r["dot-transpose_a"]
        assert kind == "ok", got
        parts.append(got)
    x = torch.from_numpy(w.batch_axis_input()).reshape(WORLD, 4, 12)
    for p, xr in zip(parts, x):
        np.testing.assert_allclose(p.numpy(), (xr.t() @ xr).numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    gap = max(float((p - whole).norm() / whole.norm()) for p in parts)
    print("C8: dot(transpose_a=True) on a rank's rows is %.4f of the whole "
          "batch's result away from it (relative L2)" % gap)
    assert gap > 0.1
