"""The reference's side of a pixel cell's comparison (Frozen in Time): the
first steps from the program's starting weights and the same inputs,
with the text tower's dropout masks drawn as the program draws them
(checks.dropout_masks: torch's default generator of the device seeded per
step with (seed, step, data rank)), NormSoftmax over the global
embeddings, the gradients worked out a chunk of videos at a time
(frozen.loss_and_grads) and optax's AdamW. Returns what
checks.compare_train reads: loss_gap, grad_gap and update_gap are those
of the region cells."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import checks, frozen, losses, model
from benchmark.reference.precision import exact


def reference_train(cfg: dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                    p0: Dict[str, torch.Tensor], device: torch.device, op=exact,
                    chunk: int = 16, half_batch: bool = False) -> dict:
    """{losses, grad_norms, g1, names, p3} of the reference's first steps
    from the weights p0, one step a batch; `op` rounds every product
    operand of both towers (a control's lower precision). `half_batch` is
    a planted fault: the loss over the first half of the rows only."""
    w = frozen.Widths.from_config(cfg)
    tw = model.Widths.from_config(cfg)  # the text tower's widths, for its dropout masks
    compute = checks.DTYPES[cfg.get("precision", {}).get("compute", "float32")]
    oa = cfg["optimizer"].get("args", {})
    names = sorted(p0)
    P = {n: p0[n].detach().to(device, torch.float32).clone().requires_grad_(True) for n in names}
    opt = losses.AdamW(P, lr=float(oa["lr"]), b1=float(oa.get("b1", 0.9)),
                       b2=float(oa.get("b2", 0.999)), eps=float(oa.get("eps", 1e-6)),
                       weight_decay=float(oa.get("weight_decay", 0.0)))
    out = {"losses": [], "grad_norms": None, "g1": None, "names": names}
    for step, arrays in enumerate(batches):
        b = checks._device_arrays(arrays, device)
        n, length = b["input_ids"].shape
        masks = checks.dropout_masks(tw, n, length, compute, device,
                                     checks.dropout_key(seed, step))
        if half_batch:
            b = {k: v[: n // 2] for k, v in b.items()}
            masks = [m[: n // 2] for m in masks]
        loss, grads = frozen.loss_and_grads(P, w, b, iter(masks), op, chunk)
        if step == 0:
            out["grad_norms"] = losses.leaf_norms(grads, names)
            out["g1"] = grads
        opt.step(grads)
        out["losses"].append(float(loss))
        del loss, grads, masks, b
    out["p3"] = {k: v.detach() for k, v in P.items()}
    return out
