"""Dataset adapters ported so far: name -> class."""
from demovlp_tpu_torch.data.datasets.base import RegionDataset
from demovlp_tpu_torch.data.datasets.synthetic import SyntheticObjectSelect

DATASET_REGISTRY = {cls.__name__: cls for cls in [SyntheticObjectSelect]}


def dataset_object_loader(dataset_name: str, **kwargs) -> RegionDataset:
    if dataset_name not in DATASET_REGISTRY:
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported (ported: {sorted(DATASET_REGISTRY)})"
        )
    return DATASET_REGISTRY[dataset_name](dataset_name=dataset_name, **kwargs)


__all__ = ["RegionDataset", "SyntheticObjectSelect", "DATASET_REGISTRY",
           "dataset_object_loader"]
