"""A pixel cell's inputs (reference/frames.py) as a dataset of the port's
loader: the program's `RegionDataLoader` shuffles, batches, stacks the
uint8 clips and prefetches them on its threads, as it does a pixel
dataset of the program's own."""
from __future__ import annotations

from typing import Any, Dict

from benchmark.reference.frames import FrameInputs


class BenchFrames:
    dataset_name = "BenchFrames"

    def __init__(self, inputs: FrameInputs):
        self.inputs = inputs

    def __len__(self) -> int:
        return self.inputs.n

    def get_item(self, index: int, rng=None) -> Dict[str, Any]:
        text = self.inputs.caption(index)
        return {"video": self.inputs.sample(index), "text": text,
                "meta": {"paths": f"bench://{index}", "raw_captions": text,
                         "dataset": self.dataset_name}}


def make_loader(inputs: FrameInputs, batch_size: int, workers: int, seed: int):
    """The port's train loader over the inputs: shuffled by `seed`, without
    a partial last batch."""
    from demovlp_tpu_torch.data.loader import RegionDataLoader

    return RegionDataLoader(BenchFrames(inputs), batch_size=batch_size, shuffle=True,
                            num_workers=workers, drop_last=True, seed=seed,
                            process_index=0, process_count=1)
