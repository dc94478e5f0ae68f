"""Data layer: Datum/dataset framework, transforms, batchers, datasets, device
prefetch. Copies of the JAX package's numpy + PIL modules
(``summer_clip_tpu/data``) under the same names; nothing here imports it."""

from summer_clip_torch.data.core import (  # noqa: F401
    Datum, DatasetBase, read_json, write_json, read_split, save_split,
    split_trainval, generate_fewshot, listdir_nohidden,
)
from summer_clip_torch.data.transforms import (  # noqa: F401
    CLIP_MEAN, CLIP_STD, EvalTransform, TrainTransform, eval_transform,
    train_transform, load_image,
)
from summer_clip_torch.data.loader import (  # noqa: F401
    Batch, ImageBatcher, labels_of, pad_to_batch,
)
from summer_clip_torch.data.datasets import (  # noqa: F401
    build_dataset, DATASET_REGISTRY, register_dataset, SyntheticDataset,
    SyntheticBatcher, SyntheticImageNetScale,
)
from summer_clip_torch.data.views import DatasetView, TipAdapterDataset, NoImageDataset  # noqa: F401
from summer_clip_torch.data import array_datasets  # noqa: F401  (registers cifar10/100, mnist)
from summer_clip_torch.data.prefetch import prefetch_to_device, to_device  # noqa: F401
