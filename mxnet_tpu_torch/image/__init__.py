"""Image utilities (counterpart of ``mxnet_tpu/image``, exporting the same
names)."""
from .detection import (  # noqa: F401
    CreateDetAugmenter,
    DetAugmenter,
    DetBorrowAug,
    DetHorizontalFlipAug,
    DetRandomCropAug,
    DetRandomPadAug,
    DetRandomSelectAug,
    ImageDetIter,
)
from .image import (  # noqa: F401
    Augmenter,
    CastAug,
    CenterCropAug,
    ColorJitterAug,
    CreateAugmenter,
    HorizontalFlipAug,
    ImageIter,
    RandomCropAug,
    ResizeAug,
    center_crop,
    color_normalize,
    fixed_crop,
    imdecode,
    imread,
    imresize,
    random_crop,
    resize_short,
)
