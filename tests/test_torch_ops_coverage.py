"""The port's op registry against the JAX package's: every canonical name
the JAX registry holds is registered in the port (249 of 249 since item
13's ``Custom``), or is listed below with the ROADMAP.md Queue A item that
defers it. Each list holds only names
that the JAX package defines in the module that item names (item 7b's
``ops/tensor.py`` registers some ``jax.numpy`` and ``jax.scipy``
functions directly, so their functions' modules are JAX's)."""
import inspect

import pytest

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

PORTED = 249

# the 95 names of item 7b, from mxnet_tpu/ops/tensor.py
TENSOR_7B = (
    "Embedding", "SequenceLast", "SequenceMask", "SequenceReverse",
    "SliceChannel", "_CrossDeviceCopy", "_arange", "_eye", "_full",
    "_hypot_scalar", "_identity_with_attr_like_rhs",
    "_linalg_extractdiag", "_linalg_extracttrian", "_linalg_gelqf",
    "_linalg_gemm", "_linalg_gemm2", "_linalg_makediag",
    "_linalg_potrf", "_linalg_potri", "_linalg_sumlogdiag",
    "_linalg_syevd", "_linalg_syrk", "_linalg_trmm", "_linalg_trsm",
    "_logical_and_scalar", "_logical_or_scalar", "_logical_xor_scalar",
    "_ones", "_scatter_elemwise_div", "_scatter_set_nd", "_slice_assign",
    "_slice_assign_scalar", "_sparse_retain", "_square_sum", "_zeros",
    "add_n", "argmax_channel", "argsort", "batch_take", "broadcast_axis",
    "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "cast_storage", "cumsum", "depth_to_space",
    "diag", "flip", "gamma", "gather_nd", "khatri_rao", "logical_not",
    "nanprod", "nansum", "pad", "pick", "rcbrt", "repeat",
    "reshape_like", "scatter_nd", "shuffle", "slice", "slice_axis",
    "slice_like", "smooth_l1", "sort", "space_to_depth", "stack",
    "tile", "topk", "where",
    # jax.numpy / jax.scipy / jax.nn functions registered there
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "broadcast_hypot", "cbrt", "cos", "cosh", "degrees", "expm1", "fix",
    "log10", "log1p", "log2", "radians", "sin", "sinh", "tan", "erf",
    "erfinv", "gammaln", "softsign")

# the aliases the JAX package gives these names
TENSOR_7B_ALIASES = (
    "ElementWiseSum", "_sum", "Pad", "reverse", "split", "slice_channel",
    "broadcast_axes", "sequence_mask", "sequence_last", "sequence_reverse",
    "_shuffle", "_hypot", "_logical_and", "_logical_or", "_logical_xor",
    "_contrib_SparseEmbedding")

# the 14 names of item 7c, from mxnet_tpu/ops/random_ops.py
RANDOM_7C = (
    "_random_exponential", "_random_gamma",
    "_random_generalized_negative_binomial", "_random_negative_binomial",
    "_random_normal", "_random_poisson", "_random_randint",
    "_random_uniform", "_sample_exponential", "_sample_gamma",
    "_sample_multinomial", "_sample_normal", "_sample_poisson",
    "_sample_uniform")
# the 17 names of item 7d, from mxnet_tpu/ops/vision.py and contrib.py
CONTRIB_7D = (
    "ROIPooling", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling", "_contrib_MultiProposal",
    "_contrib_PSROIPooling", "_contrib_Proposal",
    "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
    "_contrib_MultiBoxTarget", "_contrib_count_sketch",
    "_contrib_ctc_loss", "_contrib_dequantize",
    "_contrib_dequantize_2bit", "_contrib_fft", "_contrib_ifft",
    "_contrib_quantize", "_contrib_quantize_2bit")
# the aliases the JAX package gives these names
SLICE_7CD_ALIASES = (
    "uniform", "random_uniform", "normal", "random_normal", "random_gamma",
    "random_exponential", "random_poisson", "random_negative_binomial",
    "random_generalized_negative_binomial", "random_randint",
    "sample_uniform", "sample_normal", "sample_gamma", "sample_exponential",
    "sample_poisson", "sample_multinomial", "ctc_loss", "CTCLoss",
    "_contrib_CTCLoss", "MultiBoxPrior", "MultiBoxTarget",
    "MultiBoxDetection", "PSROIPooling", "Proposal", "MultiProposal",
    "DeformableConvolution", "DeformablePSROIPooling")

# the 4 names of item 11's first part, from mxnet_tpu/ops/quantized.py
QUANT_11 = ("_int8_convolution", "_int8_fully_connected", "_quantize_int8",
            "_quantize_rows_int8")
# the one name of item 13's first part, from mxnet_tpu/ops/custom.py
CUSTOM_13 = ("Custom",)
DEFERRED = {}
MODULES = {"7c": ("mxnet_tpu.ops.random_ops",),
           "7d": ("mxnet_tpu.ops.vision", "mxnet_tpu.ops.contrib"),
           "11": ("mxnet_tpu.ops.quantized",),
           "13": ("mxnet_tpu.ops.custom",)}
PORTED_ITEMS = {"7c": RANDOM_7C, "7d": CONTRIB_7D, "11": QUANT_11,
                "13": CUSTOM_13}

# the 22 names of this slice, from mxnet_tpu/ops/nn.py
NN_7A = ("Dropout", "LeakyReLU", "Deconvolution", "InstanceNorm",
         "L2Normalization", "LRN", "UpSampling", "Crop", "BlockGrad",
         "make_loss", "SoftmaxActivation", "softmax_cross_entropy",
         "LinearRegressionOutput", "MAERegressionOutput",
         "LogisticRegressionOutput", "SVMOutput", "GridGenerator",
         "BilinearSampler", "SpatialTransformer", "RNN", "Correlation",
         "IdentityAttachKLSparseReg")


def test_every_jax_name_is_ported_or_deferred_by_item():
    jax_names, port = set(jreg._OPS), set(treg._OPS)
    deferred = [n for names in DEFERRED.values() for n in names]
    assert len(deferred) == len(set(deferred))
    assert not port & set(deferred)
    assert port <= jax_names
    assert jax_names == port | set(deferred)
    assert len(port) == PORTED
    assert len(jax_names) - len(port) == len(deferred) == 0


@pytest.mark.parametrize("item", sorted(MODULES))
def test_each_deferred_name_comes_from_its_items_module(item):
    """A deferred item's names come from its module; a ported item's
    module has every one of its names registered in the port."""
    if item in PORTED_ITEMS:
        names = {n for n, op in jreg._OPS.items()
                 if op.fn.__module__ in MODULES[item]}
        assert names == set(PORTED_ITEMS[item])
        assert names <= set(treg._OPS)
        return
    for name in DEFERRED[item]:
        mod = jreg._OPS[name].fn.__module__
        assert mod in MODULES[item], (name, mod)


def test_the_random_and_contrib_slices_are_registered_with_the_jax_aliases():
    """Items 7c and 7d: the 31 names, their 27 aliases, and the flags,
    output counts, inputs and attribute defaults equal to the JAX
    registry's."""
    assert len(RANDOM_7C) == 14 and len(CONTRIB_7D) == 17
    slice_ = set(RANDOM_7C) | set(CONTRIB_7D)
    want = {a for a, c in jreg._ALIASES.items() if c in slice_}
    assert want == set(SLICE_7CD_ALIASES)
    for a in SLICE_7CD_ALIASES:
        assert treg._ALIASES.get(a) == jreg._ALIASES[a], a
    attrs = {"output_score": True}
    for name in slice_:
        jop, top = jreg._OPS[name], treg._OPS[name]
        assert top.nondiff == jop.nondiff, name
        assert top.needs_rng == jop.needs_rng, name
        assert top.n_outputs(attrs) == jop.n_outputs(attrs), name
        assert top.n_outputs({}) == jop.n_outputs({}), name
        assert top.n_visible_outputs({}) == jop.n_visible_outputs({}), name
        assert top.input_names == jop.input_names, name
        assert top.attr_defaults == jop.attr_defaults, name
    assert all(treg._OPS[n].needs_rng and treg._OPS[n].nondiff
               for n in RANDOM_7C)


def test_the_tensor_slice_is_registered_with_the_jax_aliases():
    """Item 7b: the 95 names of ``mxnet_tpu/ops/tensor.py`` (some registered
    there as ``jax.numpy``/``jax.scipy`` functions), their 16 aliases, and
    ``nondiff``/``needs_rng`` equal to the JAX registry's; the flags of
    every ported name too."""
    import mxnet_tpu.ops.tensor as jtensor

    tensor_src = inspect.getsource(jtensor)
    assert len(TENSOR_7B) == len(set(TENSOR_7B)) == 95
    for name in TENSOR_7B:
        mod = jreg._OPS[name].fn.__module__
        if mod.split(".")[0] == "jax":
            assert '"%s"' % name in tensor_src, name
        else:
            assert mod == "mxnet_tpu.ops.tensor", (name, mod)
        assert name in treg._OPS, name
    want = {a for a, c in jreg._ALIASES.items() if c in TENSOR_7B}
    assert want == set(TENSOR_7B_ALIASES)
    for a in TENSOR_7B_ALIASES:
        assert treg._ALIASES.get(a) == jreg._ALIASES[a], a
    for name, op in treg._OPS.items():
        assert op.nondiff == jreg._OPS[name].nondiff, name
        assert op.needs_rng == jreg._OPS[name].needs_rng, name


def test_the_nn_slice_is_registered_with_the_jax_aliases():
    for name in NN_7A:
        assert jreg._OPS[name].fn.__module__ == "mxnet_tpu.ops.nn", name
        assert name in treg._OPS, name
        assert treg._OPS[name].needs_rng == jreg._OPS[name].needs_rng, name
    for alias, canon in jreg._ALIASES.items():
        if canon in NN_7A or canon == "Pooling":
            assert treg._ALIASES.get(alias) == canon, alias
