"""Symbol-level transformer encoder (counterpart of
``mxnet_tpu/models/bench_transformer.py``): ``n_layers`` pre-LN
self-attention blocks over an already-embedded ``(batch, seq_len,
d_model)`` input, a classification head and a ``SoftmaxOutput`` loss.

The graph the training passes and remat are held on: every block
materializes ``(batch * heads, seq_len, seq_len)`` attention scores and
softmax weights and a ``(batch, seq_len, d_ff)`` ReLU, so without remat
each is kept for the backward. The graph is the JAX package's
``get_symbol``'s, node for node and name for name: the two packages'
Symbol JSON is equal.
"""
from __future__ import annotations

import math

from .. import symbol as sym


def get_symbol(num_classes=16, seq_len=64, d_model=128, n_heads=4,
               n_layers=2, d_ff=512):
    """Transformer encoder Symbol over pre-embedded ``data`` ``(batch,
    seq_len, d_model)`` with a ``softmax`` SoftmaxOutput head. Every node
    is named (remat plans key on node names)."""
    if d_model % n_heads:
        raise ValueError("d_model %d not divisible by n_heads %d"
                         % (d_model, n_heads))
    dh = d_model // n_heads

    def split_heads(t, nm):
        # (B, S, d) -> (B*H, S, dh)
        t = sym.Reshape(t, shape=(0, 0, n_heads, dh), name=nm + "_split")
        t = sym.transpose(t, axes=(0, 2, 1, 3), name=nm + "_perm")
        return sym.Reshape(t, shape=(-3, 0, 0), name=nm + "_fold")

    x = sym.Variable("data")
    for i in range(n_layers):
        p = "blk%d_" % i
        h = sym.LayerNorm(x, name=p + "ln1")
        q = split_heads(sym.FullyConnected(h, num_hidden=d_model,
                                           flatten=False, name=p + "q"),
                        p + "q")
        k = split_heads(sym.FullyConnected(h, num_hidden=d_model,
                                           flatten=False, name=p + "k"),
                        p + "k")
        v = split_heads(sym.FullyConnected(h, num_hidden=d_model,
                                           flatten=False, name=p + "v"),
                        p + "v")
        # (B*H, S, S) scores; the 1/sqrt(dh) scale rides softmax's
        # temperature, so the scores node is a pure batch_dot (saved by
        # the remat plan)
        scores = sym.batch_dot(q, k, transpose_b=True, name=p + "scores")
        attn = sym.softmax(scores, axis=-1, temperature=math.sqrt(dh),
                           name=p + "attn")
        ctx = sym.batch_dot(attn, v, name=p + "ctx")
        # (B*H, S, dh) -> (B, S, d)
        ctx = sym.Reshape(ctx, shape=(-4, -1, n_heads, 0, 0),
                          name=p + "ctx_unfold")
        ctx = sym.transpose(ctx, axes=(0, 2, 1, 3), name=p + "ctx_perm")
        ctx = sym.Reshape(ctx, shape=(0, 0, -3), name=p + "ctx_merge")
        proj = sym.FullyConnected(ctx, num_hidden=d_model, flatten=False,
                                  name=p + "proj")
        x = sym.broadcast_add(x, proj, name=p + "res1")
        h2 = sym.LayerNorm(x, name=p + "ln2")
        up = sym.FullyConnected(h2, num_hidden=d_ff, flatten=False,
                                name=p + "ffn_up")
        act = sym.Activation(up, act_type="relu", name=p + "ffn_relu")
        down = sym.FullyConnected(act, num_hidden=d_model, flatten=False,
                                  name=p + "ffn_down")
        x = sym.broadcast_add(x, down, name=p + "res2")
    x = sym.LayerNorm(x, name="final_ln")
    x = sym.Flatten(x, name="head_flatten")
    x = sym.FullyConnected(x, num_hidden=num_classes, name="head_fc")
    return sym.SoftmaxOutput(x, name="softmax")
