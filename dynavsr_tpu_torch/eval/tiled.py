"""Tiled (chopped) inference for large frames (port of
dynavsr_tpu/eval/tiled.py).

Frames are cut into overlapping spatial tiles, every tile runs through the
same batched forward, and the output is reassembled from each tile's core
(the pixels at least `overlap` from any interior tile edge). With an
overlap at least the network's receptive-field radius the result equals
the whole-frame forward (a toy conv net and DUF are tested so); EDVR's
deformable offsets are unbounded, so tiled EDVR is close to, not equal to,
the whole-frame forward.

The schedule is JAX's: all tiles of a call's windows run in ONE batched
call of (n_tiles * F, N, th, tw, 3). On one card that call holds the
activations of n_tiles * tile area >= the frame's area, so tiling alone
does not bound memory: the caller's window chunking
(`adapt.infer_chunk`, `eval.infer_chunk`) does. Tile starts and core bounds
are Python ints; extraction is slicing and one stack, reassembly slicing
and `torch.cat`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["tile_plan", "make_tiled_apply", "TILE_OVERLAP"]

TILE_OVERLAP = 32  # the configs' eval.tile_overlap default


def tile_plan(d: int, t: int, ov: int) -> Tuple[List[int], List[Tuple[int, int]]]:
    """1-D plan: tile starts and each tile's core bounds (tile coordinates).

    Tiles of size `t` step by t - 2*ov; the last start clamps to d - t so
    the frame is covered. Tile k's core spans [b_k, b_{k+1}) in frame
    coordinates with b_k = start_k + ov (b_0 = 0, b_n = d): the cores are
    contiguous and disjoint, and every core pixel lies at least ov from any
    interior tile edge."""
    if t >= d:
        return [0], [(0, d)]
    if ov < 0 or 2 * ov >= t:
        raise ValueError(f"need 0 <= 2*overlap < tile, got tile={t} overlap={ov}")
    starts = list(range(0, d - t + 1, t - 2 * ov))
    if starts[-1] != d - t:
        starts.append(d - t)
    bounds = [0] + [s + ov for s in starts[1:]] + [d]
    cores = [(bounds[k] - s, bounds[k + 1] - s) for k, s in enumerate(starts)]
    return starts, cores


def make_tiled_apply(apply: Callable, tile: Union[int, Sequence[int]],
                     overlap: Optional[int], scale: int) -> Callable:
    """Wrap apply(model, windows (F, N, h, w, 3)) -> (F, h*scale, w*scale, 3)
    so frames larger than `tile` (an int or (th, tw), as eval.tile) run as
    overlapping tiles; `overlap` None takes TILE_OVERLAP.

    A frame that fits one tile passes through unchanged (the adaptation
    pseudo-task's small SLR windows do)."""
    th_cfg, tw_cfg = (int(tile), int(tile)) if isinstance(tile, int) else map(int, tile)
    ov = TILE_OVERLAP if overlap is None else int(overlap)

    def tiled(model, x: torch.Tensor) -> torch.Tensor:
        f, h, w = x.shape[0], x.shape[-3], x.shape[-2]
        th, tw = min(th_cfg, h), min(tw_cfg, w)
        hs, hcores = tile_plan(h, th, ov)
        ws, wcores = tile_plan(w, tw, ov)
        if len(hs) == 1 and len(ws) == 1:
            return apply(model, x)
        tiles = torch.stack([x[..., i: i + th, j: j + tw, :] for i in hs for j in ws])
        sr = apply(model, tiles.reshape(len(hs) * len(ws) * f, *tiles.shape[2:]))
        sr = sr.reshape(len(hs), len(ws), f, *sr.shape[1:])
        rows = [torch.cat([sr[i, j, :, ha * scale: hb * scale, wa * scale: wb * scale]
                           for j, (wa, wb) in enumerate(wcores)], dim=-2)
                for i, (ha, hb) in enumerate(hcores)]
        return torch.cat(rows, dim=-3)

    return tiled
