"""The port's op registry against the JAX package's: every canonical name
the JAX registry holds is registered in the port, or is listed below with
the ROADMAP.md Queue A item that defers it. Each list holds only names
that the JAX package defines in the module that item names (item 7b's
``ops/tensor.py`` registers some ``jax.numpy`` and ``jax.scipy``
functions directly, so their functions' modules are JAX's)."""
import inspect

import pytest

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

PORTED = 118

DEFERRED = {
    "7b": (
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
        "erfinv", "gammaln", "softsign"),
    "7c": (
        "_random_exponential", "_random_gamma",
        "_random_generalized_negative_binomial", "_random_negative_binomial",
        "_random_normal", "_random_poisson", "_random_randint",
        "_random_uniform", "_sample_exponential", "_sample_gamma",
        "_sample_multinomial", "_sample_normal", "_sample_poisson",
        "_sample_uniform"),
    "7d": (
        "ROIPooling", "_contrib_DeformableConvolution",
        "_contrib_DeformablePSROIPooling", "_contrib_MultiProposal",
        "_contrib_PSROIPooling", "_contrib_Proposal",
        "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
        "_contrib_MultiBoxTarget", "_contrib_count_sketch",
        "_contrib_ctc_loss", "_contrib_dequantize",
        "_contrib_dequantize_2bit", "_contrib_fft", "_contrib_ifft",
        "_contrib_quantize", "_contrib_quantize_2bit"),
    "11": ("_int8_convolution", "_int8_fully_connected", "_quantize_int8",
           "_quantize_rows_int8"),
    "13": ("Custom",),
}
MODULES = {"7b": ("mxnet_tpu.ops.tensor",),
           "7c": ("mxnet_tpu.ops.random_ops",),
           "7d": ("mxnet_tpu.ops.vision", "mxnet_tpu.ops.contrib"),
           "11": ("mxnet_tpu.ops.quantized",),
           "13": ("mxnet_tpu.ops.custom",)}

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
    assert len(jax_names) - len(port) == len(deferred) == 131


@pytest.mark.parametrize("item", sorted(DEFERRED))
def test_each_deferred_name_comes_from_its_items_module(item):
    import mxnet_tpu.ops.tensor as jtensor

    tensor_src = inspect.getsource(jtensor)
    for name in DEFERRED[item]:
        mod = jreg._OPS[name].fn.__module__
        if item == "7b" and mod.split(".")[0] == "jax":
            assert '"%s"' % name in tensor_src, name
        else:
            assert mod in MODULES[item], (name, mod)


def test_the_nn_slice_is_registered_with_the_jax_aliases():
    for name in NN_7A:
        assert jreg._OPS[name].fn.__module__ == "mxnet_tpu.ops.nn", name
        assert name in treg._OPS, name
        assert treg._OPS[name].needs_rng == jreg._OPS[name].needs_rng, name
    for alias, canon in jreg._ALIASES.items():
        if canon in NN_7A or canon == "Pooling":
            assert treg._ALIASES.get(alias) == canon, alias
