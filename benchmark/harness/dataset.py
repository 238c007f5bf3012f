"""The run's inputs (reference/data.py) as a dataset of the port's loader:
the program's `RegionDataLoader` shuffles, batches, assembles and
prefetches them on its threads, as it does a dataset that reads region
archives."""
from __future__ import annotations

from typing import Any, Dict

from benchmark.reference.data import Inputs


class BenchDataset:
    dataset_name = "BenchRegions"

    def __init__(self, inputs: Inputs):
        self.inputs = inputs

    def __len__(self) -> int:
        return self.inputs.n

    def get_item(self, index: int, rng=None) -> Dict[str, Any]:
        feats, mask = self.inputs.sample(index)
        text = self.inputs.caption(index)
        return {"object": feats, "object_mask": mask, "text": text,
                "meta": {"paths": f"bench://{index}", "raw_captions": text,
                         "dataset": self.dataset_name}}


def make_loader(inputs: Inputs, batch_size: int, workers: int, seed: int, train: bool):
    """The port's loader over the inputs: shuffled by `seed` and without a
    partial last batch for training, in order for an index."""
    from demovlp_tpu_torch.data.loader import RegionDataLoader

    return RegionDataLoader(BenchDataset(inputs), batch_size=batch_size, shuffle=train,
                            num_workers=workers, drop_last=train, seed=seed,
                            process_index=0, process_count=1)
