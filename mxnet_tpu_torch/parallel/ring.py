"""Sequence parallelism: ring attention and Ulysses all-to-all, over an
``sp`` axis of ranks (counterpart of ``mxnet_tpu/parallel/ring.py``).

- **Ring attention** (:func:`ring_attention_inner`): q stays put, the K/V
  chunks go round the ``sp`` ring by :func:`~.tensor_parallel.ppermute`,
  and an online softmax (running max ``m``, running sum ``l``, an
  unnormalised accumulator, all fp32) makes the per-chunk combine exact,
  as flash attention's outer loop does. Each step is PyTorch ops, as the
  JAX package's is ``lax``.
- **Ulysses** (:func:`ulysses_attention_inner`): an all-to-all
  (:func:`~.tensor_parallel.all_to_all`) reshards the sequence-sharded
  q, k, v to head-sharded ones, attention runs on the whole sequence of
  the rank's heads (``attn_fn``: :func:`full_attention` by default, or the
  flash kernel), and a second all-to-all reshards back. ``num_heads`` must
  divide by the axis size.

The inner functions take the local shards and the axis's ``(group, n,
index)`` (:func:`.mesh.axis_group`; ``None`` is one rank): a module such as
the transformer calls them with its own shards. The standalone functions
take the global ``(B, H, S, D)`` tensors (every rank passes the same) and a
mesh, and each rank computes its own shard: the rows of its index along
``batch_axis`` (if any) and the sequence chunk of its index along
``axis_name``. A rank returns that shard of the output, ``(B / n_batch,
H, S / n, D)``. Its gradient in the global q, k and v, of any loss of its
shard, is its share: q's lies in its own shard; k's and v's come back
round the ring (or through the inverse all-to-all) to the rank that
holds their chunk, so they too lie in its shard, summed over every rank's
queries. The shares summed over the ranks are the gradient of the sum of
the ranks' losses, which is what the JAX package's global function gives.
"""
from __future__ import annotations

import torch

from .tensor_parallel import all_to_all, ppermute

__all__ = ["ring_attention_inner", "ring_attention",
           "ulysses_attention_inner", "ulysses_attention",
           "full_attention"]

_NEG_INF = -1e30  # finite -inf stand-in: keeps online-softmax NaN-free


def _scale(sm_scale, d):
    return sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)


def _scores(q, k, scale, causal, q_offset, k_offset):
    """fp32 ``q . k * scale``, with the causal mask of global positions
    ``q_offset + i`` against ``k_offset + j``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        ki = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, _NEG_INF)
    return s


def full_attention(q, k, v, *, causal=False, sm_scale=None, q_offset=0,
                   k_offset=0):
    """Plain softmax attention, (B, H, S, D) layout, fp32 softmax, the
    probabilities cast to v's dtype before the second product.

    ``q_offset``/``k_offset`` are the global positions of q[...,0,:] and
    k[...,0,:], for the causal mask of sequence *shards*.
    """
    s = _scores(q, k, _scale(sm_scale, q.shape[-1]), causal, q_offset,
                k_offset)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _attend_chunk(q, k, v, m, l, acc, *, scale, causal, q_offset, k_offset):
    """One online-softmax accumulation step against a K/V chunk.

    m: (B,H,Sq) running max; l: (B,H,Sq) running denominator;
    acc: (B,H,Sq,D) unnormalized numerator. All fp32.
    """
    s = _scores(q, k, scale, causal, q_offset, k_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)                    # rescale old state
    p = torch.exp(s - m_new[..., None])             # (B,H,Sq,Sk)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def ring_attention_inner(q, k, v, *, axis=None, causal=False, sm_scale=None):
    """Ring attention over a sequence-sharded axis, on this rank's shards.

    q, k, v: (B, H, S_local, D), the rank's sequence chunk (index ``i`` of
    the axis's ``n``: global positions ``[i * S_local, (i + 1) *
    S_local)``). ``axis``: the ``(group, n, index)`` of the ``sp`` axis
    (None: one rank). Returns the rank's output chunk (B, H, S_local, D)
    in q's dtype.

    ``n`` steps: at step ``t`` the rank holds the K/V chunk of rank ``(i -
    t) mod n``, folds it into the running softmax (under the causal mask a
    chunk from a later rank adds exactly zero), then passes K and V on to
    the next rank, the last step included, as the JAX package does. Every
    rank runs the same ops and collectives in the same order, so the
    backward's reverse permutes pair up across the ranks.
    """
    _group, n, my_idx = axis if axis is not None else (None, 1, 0)
    s_local = k.shape[2]
    scale = _scale(sm_scale, q.shape[-1])
    q32 = q.float()
    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q32)
    kc, vc = k, v
    for t in range(n):
        src = (my_idx - t) % n
        m, l, acc = _attend_chunk(
            q32, kc, vc, m, l, acc, scale=scale, causal=causal,
            q_offset=my_idx * q.shape[2], k_offset=src * s_local)
        kc = ppermute(kc, axis)
        vc = ppermute(vc, axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _shard(t, mesh, axis, batch_axis):
    """The rank's shard of a global (B, H, S, D) tensor: its rows along
    ``batch_axis`` and its sequence chunk along ``axis``."""
    from .mesh import axis_group

    if batch_axis is not None:
        _g, nb, ib = axis_group(mesh, (batch_axis,))
        t = t.narrow(0, ib * (t.shape[0] // nb), t.shape[0] // nb)
    _g, n, i = axis
    if t.shape[2] % n:
        raise ValueError("sequence length %d does not divide over %d ranks"
                         % (t.shape[2], n))
    return t.narrow(2, i * (t.shape[2] // n), t.shape[2] // n)


def _standalone(inner, q, k, v, mesh, axis_name, batch_axis, **kw):
    from .mesh import axis_group, default_mesh

    mesh = mesh or default_mesh()
    axis = axis_group(mesh, (axis_name,))
    q, k, v = (_shard(t, mesh, axis, batch_axis) for t in (q, k, v))
    return inner(q, k, v, axis=axis, **kw)


def ring_attention(q, k, v, mesh=None, *, axis_name="sp", causal=False,
                   sm_scale=None, batch_axis=None):
    """Standalone ring attention: the sequence (dim 2) sharded over
    ``axis_name`` of ``mesh`` (default :func:`.mesh.default_mesh`).

    q, k, v: the *global* (B, H, S, D) tensors, the same on every rank;
    S % axis size == 0. With ``batch_axis`` the batch dim also shards over
    that mesh axis (dp composition). Returns this rank's output shard (see
    the module docstring for the shard and its gradients).
    """
    return _standalone(ring_attention_inner, q, k, v, mesh, axis_name,
                       batch_axis, causal=causal, sm_scale=sm_scale)


def ulysses_attention_inner(q, k, v, *, axis=None, causal=False,
                            sm_scale=None, attn_fn=None):
    """Ulysses sequence parallelism on this rank's shards.

    Input is sequence-sharded (B, H, S_local, D); the all-to-all swaps the
    shard dim to heads (B, H/n, S, D), attention runs on the whole
    sequence of the rank's heads, and a second all-to-all swaps back.
    ``attn_fn(q, k, v, causal=, sm_scale=)`` defaults to
    :func:`full_attention`; pass the flash kernel
    (``kernels.flash_attention.flash_attention``) for the fused path.
    """
    def to_heads(x):   # (B, H, S/n, D) -> (B, H/n, S, D)
        return all_to_all(x, axis, split_dim=1, concat_dim=2)

    def to_seq(x):     # (B, H/n, S, D) -> (B, H, S/n, D)
        return all_to_all(x, axis, split_dim=2, concat_dim=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    fn = full_attention if attn_fn is None else attn_fn
    return to_seq(fn(qh, kh, vh, causal=causal, sm_scale=sm_scale))


def ulysses_attention(q, k, v, mesh=None, *, axis_name="sp", causal=False,
                      sm_scale=None, batch_axis=None, attn_fn=None):
    """Standalone Ulysses attention on the global (B, H, S, D) tensors;
    returns this rank's output shard, as :func:`ring_attention`."""
    return _standalone(ulysses_attention_inner, q, k, v, mesh, axis_name,
                       batch_axis, causal=causal, sm_scale=sm_scale,
                       attn_fn=attn_fn)
