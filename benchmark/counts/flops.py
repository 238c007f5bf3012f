"""The frozen operation counts: the FLOP model of a retrieval step and of a
query call, and the operations and bytes of the local-similarity kernels,
each a function of the call's shapes and the configuration's stated
precision only (never of which kernel ran).

The step model is the port's `utils/flops.py` `retrieval_step_flops_model`
as it stood when the benchmark was defined (it agreed with torch's
FlopCounterMode to 0.9978 on the towers); kept here so that no later change
to the program moves the yardstick.
"""
from __future__ import annotations

from typing import Dict


def tower_flops(seq: int, d: int, ffn: int, layers: int) -> float:
    """Forward FLOP of one encoder stack on one sequence (a product is 2
    per multiply-add; norms, softmax and elementwise work omitted):
    q, k, v, out projections 4 seq d^2, attention 2 seq^2 d, FFN 2 seq d ffn."""
    per_layer = 4 * seq * d * d * 2 + 2 * seq * seq * d * 2 + 2 * seq * d * ffn * 2
    return float(layers * per_layer)


def text_forward(text_len: int, text_dim: int = 768, text_layers: int = 6,
                 proj: int = 256) -> float:
    return tower_flops(text_len, text_dim, 4 * text_dim, text_layers) + text_len * text_dim * proj * 2


def object_forward(frames: int, regions: int, obj_dim: int = 768, obj_depth: int = 12,
                   proj: int = 256) -> float:
    seq = frames * regions + 1
    return (tower_flops(seq, obj_dim, 4 * obj_dim, obj_depth)
            + frames * regions * 2054 * obj_dim * 2 + seq * obj_dim * proj * 2)


def local_pair_flops(text_len: int, regions_total: int, proj: int) -> float:
    """FLOP of both directions of the local similarity of one (video,
    caption) pair, forward."""
    lt, lr = text_len - 1, regions_total
    return 2 * (2 * lt * lr * proj * 2 + 2 * lt * proj)


def retrieval_step(batch: int, frames: int, regions: int, text_len: int, proj: int = 256,
                   obj_depth: int = 12, obj_dim: int = 768, text_layers: int = 6,
                   text_dim: int = 768, use_local: bool = True) -> float:
    """FLOP of one training step over `batch` pairs: both towers forward and
    backward (backward = 2 x forward), the global sims and the local
    similarity over batch^2 pairs, forward and backward."""
    towers = 3.0 * batch * (object_forward(frames, regions, obj_dim, obj_depth, proj)
                            + text_forward(text_len, text_dim, text_layers, proj))
    sims = 3.0 * 2 * batch * batch * proj
    local = 3.0 * batch * batch * local_pair_flops(text_len, frames * regions, proj) if use_local else 0.0
    return towers + sims + local


def query_call(queries: int, videos: int, frames: int, regions: int, text_len: int,
               proj: int = 256, text_layers: int = 6, text_dim: int = 768,
               use_local: bool = True) -> float:
    """FLOP of one query call: the text tower forward on the queries, the
    global sims and the local similarity of every (query, video) pair,
    forward only (the gallery's embeddings are the index's)."""
    text = queries * text_forward(text_len, text_dim, text_layers, proj)
    sims = 2.0 * queries * videos * proj
    local = queries * videos * local_pair_flops(text_len, frames * regions, proj) if use_local else 0.0
    return text + sims + local


def xattn_work(name: str, bc: int, bq: int, ls: int, lq: int, d: int) -> Dict[str, float]:
    """{"flops", "bytes"} the algorithm needs for one launch of a local-
    similarity kernel: the forward (`fwd`) 4 units of bc bq lq ls d (two
    products), d_query (`dq`) 8 and d_context (`dc`) 4 (the backward's 12
    counted once); every input byte read once (f32 context, query, mask),
    every output written once."""
    unit = float(bc) * bq * lq * ls * d
    inputs = 4.0 * (bc * ls * d + bq * lq * d + bc * ls)
    if name == "fwd":
        return {"flops": 4 * unit, "bytes": inputs + 4.0 * bc * bq}
    if name == "dq":
        return {"flops": 8 * unit, "bytes": inputs + 4.0 * (bc * bq + bq * lq * d)}
    if name == "dc":
        return {"flops": 4 * unit, "bytes": inputs + 4.0 * (bc * bq + bc * ls * d)}
    raise ValueError(f"no kernel {name!r}: expected fwd, dq or dc")
