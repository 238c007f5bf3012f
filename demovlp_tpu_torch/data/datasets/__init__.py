"""Dataset adapters: name -> class (the JAX package's registry,
demovlp_tpu/data/datasets/__init__.py), and the port's pixel datasets."""
from demovlp_tpu_torch.data.datasets.base import RegionDataset
from demovlp_tpu_torch.data.datasets.cc3m import ConceptualCaptions3MObjectSelect
from demovlp_tpu_torch.data.datasets.didemo import DiDeMoObjectSelect
from demovlp_tpu_torch.data.datasets.lsmdc import LSMDCMCObjectSelect, LSMDCObjectSelect
from demovlp_tpu_torch.data.datasets.msrvtt import (MSRVTTMCObjectSelect, MSRVTTObjectSelect,
                                                    MSRVTTQAObjectSelect)
from demovlp_tpu_torch.data.datasets.msvd import MSVDObjectSelect, MSVDQAObjectSelect
from demovlp_tpu_torch.data.datasets.pixels import SyntheticPixels
from demovlp_tpu_torch.data.datasets.synthetic import SyntheticObjectSelect
from demovlp_tpu_torch.data.datasets.tgif import TGIFFrameObjectSelect
from demovlp_tpu_torch.data.datasets.webvid import WebVidObjectSelect

DATASET_REGISTRY = {
    cls.__name__: cls
    for cls in [
        MSRVTTObjectSelect,
        MSRVTTQAObjectSelect,
        MSRVTTMCObjectSelect,
        WebVidObjectSelect,
        ConceptualCaptions3MObjectSelect,
        MSVDObjectSelect,
        MSVDQAObjectSelect,
        DiDeMoObjectSelect,
        LSMDCObjectSelect,
        LSMDCMCObjectSelect,
        TGIFFrameObjectSelect,
        SyntheticObjectSelect,
    ]
}

#: datasets of raw frames (`video` uint8 (F, 3, R, R) a sample), for pixel models
PIXEL_REGISTRY = {SyntheticPixels.__name__: SyntheticPixels}


def dataset_object_loader(dataset_name: str, video_params=None, **kwargs):
    """The region dataset `dataset_name`, or the pixel dataset, which reads
    `video_params`."""
    if dataset_name in PIXEL_REGISTRY:
        return PIXEL_REGISTRY[dataset_name](dataset_name=dataset_name,
                                            video_params=video_params, **kwargs)
    if dataset_name not in DATASET_REGISTRY:
        raise NotImplementedError(f"Dataset: {dataset_name} not found.")
    return DATASET_REGISTRY[dataset_name](dataset_name=dataset_name, **kwargs)


__all__ = (["RegionDataset", "DATASET_REGISTRY", "PIXEL_REGISTRY", "dataset_object_loader"]
           + list(DATASET_REGISTRY) + list(PIXEL_REGISTRY))
