"""Selective rematerialization: a save/recompute plan over the training
graph (counterpart of ``mxnet_tpu/ir/remat.py``).

The decision is per graph node, stated as a table of op names
(:data:`SAVE_OPS`): the outputs of the expensive products (convolutions,
matmuls, the fused units) are kept for the backward; everything else (BN
apply, activations, softmax, reshapes, adds) is recomputed in the backward
from the nearest kept output.

The JAX package lowers a plan with ``checkpoint_name`` tags and
``save_only_these_names``; PyTorch has no such policy, so the port lowers
it in the graph closure (``executor._graph_closure(remat_names=...)``):
each recompute node runs under its own non-reentrant checkpoint, and a
tensor the backward keeps whose memory belongs to a recompute node's
output is stored as a recipe that recomputes that output when the backward
needs it.
"""
from __future__ import annotations

from ..base import MXNetError

# Op families whose outputs are kept under the selective plan; every other
# op is recomputed in the backward from the nearest kept producer.
SAVE_OPS = frozenset((
    "Convolution",
    "Deconvolution",
    "FullyConnected",
    "FusedBottleneckUnit",
    "_ConvResidualAdd",
    "_int8_convolution",
    "_int8_fully_connected",
    "dot",
    "batch_dot",
    "_linalg_gemm",
    "_linalg_gemm2",
    "Correlation",
))


class RematPlan:
    """One graph's save/recompute decision: ``save`` and ``recompute`` are
    tuples of node names."""

    def __init__(self, save, recompute):
        self.save = tuple(save)
        self.recompute = tuple(recompute)

    @property
    def n_save(self):
        return len(self.save)

    @property
    def n_recompute(self):
        return len(self.recompute)

    def to_dict(self):
        return {"save": list(self.save), "recompute": list(self.recompute),
                "n_save": self.n_save, "n_recompute": self.n_recompute}

    def __repr__(self):
        return ("RematPlan(save=%d, recompute=%d)"
                % (self.n_save, self.n_recompute))


def plan_remat(symbol, save_ops=None, record=True):
    """Classify every computing node of ``symbol`` as save or recompute.
    ``save_ops`` overrides :data:`SAVE_OPS`. Records the counts into
    ``profiler.pass_stats`` under the ``remat`` pass unless ``record`` is
    false."""
    ops = SAVE_OPS if save_ops is None else frozenset(save_ops)
    save, recompute = [], []
    for node in symbol._topo():
        if node.is_variable():
            continue
        if not node.name:
            raise MXNetError(
                "plan_remat: unnamed %s node — the plan keys on node "
                "names, every computing node needs one" % node.op.name)
        (save if node.op.name in ops else recompute).append(node.name)
    plan = RematPlan(save, recompute)
    if record:
        from .. import profiler

        profiler.pass_record("remat", remat_saved=plan.n_save,
                             remat_recomputed=plan.n_recompute)
    return plan
