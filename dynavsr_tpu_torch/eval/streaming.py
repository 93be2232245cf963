"""Streaming (online) SR serving (port of dynavsr_tpu/eval/streaming.py).

Frames arrive one at a time; each SR frame is emitted as soon as its
sliding window is final. EDVR's pyramid-split forward (models/edvr.py
extract_pyramid / fuse_pyramid) makes the per-frame cost O(1): each
arriving frame is feature-extracted once, its pyramid goes into a ring of
preallocated device tensors, and each emitted frame costs one window fuse
(PCD + TSA + reconstruction). A steady-state push is extract -> slot write
-> gather -> one fuse_pyramid.

The ring holds the last R = 2N arrival slots (slot = frame index % R), as
(R, B, ...) tensors written in place: no padding policy references a frame
more than 2N below the newest one when its window is emitted (circle's
end case is the extremal one). The dtypes are those of the first extracted
features (bf16 for a bf16 EDVR). Window gathers use index tensors cached on
the device. An emitted SR frame is the fuse's own output, never a view of
the ring. Serving runs under torch.no_grad(); the warm-up adaptation needs
autograd and runs outside it.

Exactness: the emitted frames equal the offline window-batched forward
over data/windows.all_windows with the same padding (the tests hold it).
The price is latency: frame i's window may reference up to i + 2*(N//2)
(padding-dependent), so emission lags arrival by N//2 frames
(reflection / replicate) or up to 2*(N//2) (reflection_circle / new_info /
circle), and the last windows drain in flush() once the length is known.

Adapt-then-serve (DynaVSR online): with `adapter` (make_streaming_adapter)
and `adapt_windows=K`, frames buffer on the host until every frame the
first K windows reference has arrived; those windows equal the offline
protocol's first K rows (index_generation's start branches do not depend
on the clip length). The adaptation runs once, then the buffered frames
replay through the ring with the adapted net. A stream shorter than the
warm-up adapts at flush() on min(K, T) windows of its true length, the
offline n_adapt clamp.

MultiStreamSR serves B streams in lockstep. The streams share one module,
or G groups of consecutive B/G streams each have their own (a sequence of
G modules; per-stream when G = B): each body loops over the groups, running
the plain batch-B/G computation with the group's module (JAX measured
vmapping over parameters as slow and maps over the groups). With a batched
adapter each group adapts once, on the pooled first-K windows of its
streams, and serving continues with the G adapted copies. G = 1 is the
shared path.

Backbones without a pyramid split (TOF, DUF) stream through WindowStreamSR:
only the raw frames ring, and each emission runs one full window forward
(`apply_fn`, default models/padding.make_model_apply(model.arch, model.scale)).

    stream = StreamingSR(model, n_frames=5)
    for frame in source:                  # (H, W, 3) float32 in [0, 1]
        for i, sr in stream.push(frame):  # zero or more ready SR frames
            sink(i, sr)
    for i, sr in stream.flush():
        sink(i, sr)
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_fn
from dynavsr_tpu_torch.data.windows import index_generation
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.utils.observability import span

__all__ = ["StreamingSR", "MultiStreamSR", "WindowStreamSR", "make_streaming_adapter"]

# "No end border in sight" clip length: windows computed with it equal the
# true-length windows whenever center + N//2 <= T - 1, which the emission
# rule guarantees (_due).
_OPEN = 1 << 30

Modules = Union[nn.Module, Sequence[nn.Module]]


def make_streaming_adapter(cfg: AdaptConfig, est: nn.Module, apply_fn: Optional[Callable] = None,
                           mutable_apply_fn: Optional[Callable] = None,
                           batched: bool = False) -> Callable:
    """The warm-up `adapter(model, windows) -> (adapted module, losses)`:
    the estimator's pseudo-task (SLR = est(windows) -> LR centre), then the
    k adaptation steps of adapt/adaptation.make_adapt_fn (apply_fn /
    mutable_apply_fn as there).

    windows (K, N, h, w, 3); with batched=True (G, K', N, h, w, 3), and the
    adapter returns a list of G adapted copies and (G, n_steps) losses, the
    groups adapted one after another from the same module."""
    adapt = make_adapt_fn(cfg, apply_fn, mutable_apply_fn)

    def one(model, windows):
        with torch.no_grad():
            slr = est(windows)
        return adapt(model, slr, windows[:, windows.shape[1] // 2])

    if not batched:
        return one

    def many(model, windows):
        outs = [one(model, w) for w in windows]
        return [m for m, _ in outs], torch.stack([losses for _, losses in outs])

    return many


class _StreamCore:
    """B lockstep streams over one ring on the device.

    Two modes, fixed at construction: pyramid (window_apply None) rings
    EDVR's per-frame (l1, l2, l3) and the raw frames, and fuses with
    fuse_pyramid; window mode rings only the raw frames and runs
    window_apply(model, (B', N, h, w, 3)) per emission.

    The served modules are `self.models`: one shared module (`_g` 0) or g
    modules for g consecutive blocks of B/g streams."""

    def __init__(self, model: Modules, n_streams: int, n_frames: int, padding: str,
                 adapter=None, adapt_windows: int = 0, n_groups: Optional[int] = None,
                 window_apply: Optional[Callable] = None, batched_adapter: bool = False):
        stacked = not isinstance(model, nn.Module)
        if stacked and adapter is not None:
            raise ValueError("per-group modules and adapter are mutually exclusive: the "
                             "warm-up adapts every group from the same module (pass one module)")
        models = list(model) if stacked else [model]
        self.b, self.n, self.pad = int(n_streams), int(n_frames), padding
        self.adapter, self.k_adapt = adapter, int(adapt_windows)
        self._batched_adapter = batched_adapter
        self._window_apply = window_apply
        # Group count for the modules passed in, and after the warm-up.
        self._g0 = (n_groups or len(models)) if stacked else 0
        self._g_adapt = (n_groups or self.b) if adapter is not None else 0
        for g in {self._g0, self._g_adapt} - {0}:
            if self.b % g:
                raise ValueError(f"n_groups={g} must divide n_streams={self.b}")
        if stacked and self._g0 != len(models):
            raise ValueError(f"n_groups={self._g0}, but {len(models)} modules were given")
        if self._g0 == 1:  # one group is the shared path
            self._g0 = 0
        self._models0 = models
        self.device = next(models[0].parameters()).device
        self.adapt_losses = None
        self._R = 2 * self.n
        # Adaptation may start once every frame the first K windows
        # reference has arrived: circle-type paddings reach up to 2*(N//2)
        # past a start window's centre.
        self._warm_need = (1 + max(self._needs(i) for i in range(self.k_adapt))
                           if self.k_adapt > 0 else 0)
        self._idx_cache: dict = {}
        self.reset()

    def reset(self) -> None:
        self.models = list(self._models0)
        self._g = self._g0
        self._t = 0  # frames pushed so far
        self._next = 0  # next centre to emit
        self._rings = None  # (feature rings, frame ring), allocated at the first arrival
        self._adapted = self.adapter is None or self.k_adapt <= 0
        self._raw: List[Any] = []  # warm-up frames (B, h, w, 3), as pushed

    # ------------------------------------------------------------- schedule
    def _needs(self, i: int) -> int:
        """Largest frame index window i references with no end border in
        sight (valid exactly when that frame has arrived)."""
        return max(index_generation(i, _OPEN, self.n, self.pad))

    def _ring_idx(self, center: int, max_n: int) -> torch.Tensor:
        """The ring slots of window `center`, as an index tensor on the
        device; a steady stream cycles through R patterns, each uploaded
        once."""
        slots = tuple(j % self._R for j in index_generation(center, max_n, self.n, self.pad))
        idx = self._idx_cache.get(slots)
        if idx is None:
            idx = self._idx_cache[slots] = torch.tensor(slots, dtype=torch.long,
                                                        device=self.device)
        return idx

    def _due(self, t: int) -> List[int]:
        """Centres whose windows become final once t frames have arrived: a
        window is final only if it cannot be an end window of the true clip,
        so its full right reach (centre + N//2) must have arrived, not
        merely its mirror."""
        out, c = [], self._next
        while c + self.n // 2 < t and self._needs(c) < t:
            out.append(c)
            c += 1
        return out

    # ------------------------------------------------------------- the ring
    def _blocks(self):
        """(module, stream slice) pairs of the served groups."""
        if not self._g:
            return [(self.models[0], slice(None))]
        bg = self.b // self._g
        return [(m, slice(i * bg, (i + 1) * bg)) for i, m in enumerate(self.models)]

    def _ingest(self, frames: torch.Tensor) -> None:
        """Write arrival self._t's frames (B, h, w, 3) and, in pyramid mode,
        their features into slot t % R."""
        with span("stream.ingest"):
            slot = self._t % self._R
            feats = None
            if self._window_apply is None:
                parts = [m.extract_pyramid(frames[sl]) for m, sl in self._blocks()]
                feats = [torch.cat(level) if len(parts) > 1 else level[0]
                         for level in zip(*parts)]
            if self._rings is None:
                def ring(t):
                    return torch.zeros((self._R, *t.shape), dtype=t.dtype, device=t.device)
                self._rings = ([ring(f) for f in feats or ()], ring(frames))
            for r, f in zip(self._rings[0], feats or ()):
                r[slot] = f
            self._rings[1][slot] = frames

    def _emit(self, idx: torch.Tensor) -> torch.Tensor:
        """The SR frames (B, H, W, 3) of the window whose ring slots are idx."""
        with span("stream.emit"):
            feat_rings, frame_ring = self._rings
            frames_w = frame_ring[idx].transpose(0, 1)  # (B, N, h, w, 3)
            feats_w = [r[idx].transpose(0, 1) for r in feat_rings]  # (B, N, C, h', w')
            outs = []
            for m, sl in self._blocks():
                # A block's window as contiguous tensors, as the kernels take
                # them (a copy unless the block is one stream).
                if self._window_apply is not None:
                    outs.append(self._window_apply(m, frames_w[sl].contiguous()))
                else:
                    l1, l2, l3 = (f[sl].contiguous() for f in feats_w)
                    outs.append(m.fuse_pyramid(l1, l2, l3, frames_w[sl, self.n // 2]))
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _ingest_emit(self, frames: torch.Tensor) -> List[Tuple[int, torch.Tensor]]:
        with torch.no_grad():
            self._ingest(frames)
            self._t += 1
            out = [(c, self._emit(self._ring_idx(c, _OPEN))) for c in self._due(self._t)]
        self._next += len(out)
        return out

    # ------------------------------------------------------------- warm-up
    def _device_frames(self, frames) -> torch.Tensor:
        with span("stream.upload"):
            if torch.is_tensor(frames):
                return frames.to(self.device)
            return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _warmup(self, k: int, max_n: int) -> List[Tuple[int, torch.Tensor]]:
        """Adapt on the first k windows of the buffered frames, then replay
        the buffer through the ring with the adapted modules (the features
        must come from the net that serves them)."""
        raw, self._raw = self._raw, []
        frames = torch.stack([self._device_frames(f) for f in raw])  # (t, B, h, w, 3)
        idx = torch.tensor([index_generation(i, max_n, self.n, self.pad) for i in range(k)],
                           dtype=torch.long, device=self.device)
        windows = frames[idx].permute(2, 0, 1, 3, 4, 5)  # (B, K, N, h, w, 3)
        if not self._batched_adapter:
            adapted, self.adapt_losses = self.adapter(self.models[0], windows[0].contiguous())
            self.models = [adapted]
        else:
            g = self._g_adapt
            # Group i pools its streams' windows in stream order.
            windows = windows.reshape(g, self.b // g * k, *windows.shape[2:])
            self.models, self.adapt_losses = self.adapter(self.models[0], windows)
            self._g = 0 if g == 1 else g
        self._adapted = True
        out = []
        for f in frames:
            out.extend(self._ingest_emit(f))
        return out

    # ------------------------------------------------------------- public
    def _push(self, frames) -> List[Tuple[int, torch.Tensor]]:
        with span("stream.push"):
            if not self._adapted:
                self._raw.append(frames)
                if len(self._raw) >= self._warm_need:
                    return self._warmup(self.k_adapt, _OPEN)
                return []
            return self._ingest_emit(self._device_frames(frames))

    def _flush(self) -> List[Tuple[int, torch.Tensor]]:
        out = []
        if not self._adapted:
            t = len(self._raw)
            if t == 0:
                self.reset()
                return []
            out.extend(self._warmup(min(self.k_adapt, t), t))
        t = self._t
        with torch.no_grad():
            out.extend((i, self._emit(self._ring_idx(i, t))) for i in range(self._next, t))
        self.reset()
        return out


def _batch1(frame):
    """(H, W, 3) -> (1, H, W, 3), on the host for a host frame."""
    return frame[None] if torch.is_tensor(frame) else np.asarray(frame)[None]


class StreamingSR(_StreamCore):
    """Online sliding-window SR over one frame stream, for EDVR-family
    modules with extract_pyramid / fuse_pyramid. Frames must be EDVR's
    size (H, W divisible by 4), as the JAX streamer takes them.

    With `adapter` (make_streaming_adapter) and `adapt_windows=K`, frames
    buffer until the first K windows are complete, the adaptation runs
    once, and the stream is served by the adapted copy."""

    def __init__(self, model: nn.Module, n_frames: int = 5, padding: str = "reflection",
                 adapter=None, adapt_windows: int = 0):
        super().__init__(model, 1, n_frames, padding, adapter=adapter,
                         adapt_windows=adapt_windows)

    def push(self, frame) -> List[Tuple[int, torch.Tensor]]:
        """Feed one (H, W, 3) frame (numpy or tensor); returns the SR
        frames whose windows became final, as (index, (H*s, W*s, 3)) pairs
        on the module's device."""
        return [(i, sr[0]) for i, sr in self._push(_batch1(frame))]

    def flush(self) -> List[Tuple[int, torch.Tensor]]:
        """End of stream: emit the tail windows with the true clip length,
        then reset."""
        return [(i, sr[0]) for i, sr in self._flush()]


class WindowStreamSR(_StreamCore):
    """Online streamer for backbones without a pyramid split (TOF, DUF):
    the last 2N raw frames ring on the device, and each emission runs one
    full window forward, apply_fn(model, (B, N, h, w, 3)) -> (B, H', W', 3)
    (default models/padding.make_model_apply(model.arch, model.scale): the
    architecture's input convention, eval mode). The adapt-then-serve
    contract is StreamingSR's; build the adapter with the same padded
    forwards (make_streaming_adapter(..., apply_fn, mutable_apply_fn))."""

    def __init__(self, model: nn.Module, n_frames: int = 7, padding: str = "replicate",
                 apply_fn: Optional[Callable] = None, adapter=None, adapt_windows: int = 0):
        super().__init__(model, 1, n_frames, padding, adapter=adapter,
                         adapt_windows=adapt_windows,
                         window_apply=apply_fn or make_model_apply(model.arch, model.scale))

    def push(self, frame) -> List[Tuple[int, torch.Tensor]]:
        return [(i, sr[0]) for i, sr in self._push(_batch1(frame))]

    def flush(self) -> List[Tuple[int, torch.Tensor]]:
        return [(i, sr[0]) for i, sr in self._flush()]


class MultiStreamSR(_StreamCore):
    """B streams served in lockstep with StreamingSR's pyramid ring: push
    takes frame t of every stream as one (B, H, W, 3) stack, emissions are
    (index, (B, H', W', 3)) pairs.

    model: one module shared by every stream, or a sequence of G modules
    (`n_groups` G, default len(model)), each serving a block of B/G
    consecutive streams. With `adapter` built by
    make_streaming_adapter(batched=True), each of the n_groups groups
    (default: each stream) adapts on the pooled first-K windows of its
    streams, and serving continues with the group's copy."""

    def __init__(self, model: Modules, n_streams: int, n_frames: int = 5,
                 padding: str = "reflection", adapter=None, adapt_windows: int = 0,
                 n_groups: Optional[int] = None):
        super().__init__(model, n_streams, n_frames, padding, adapter=adapter,
                         adapt_windows=adapt_windows, n_groups=n_groups,
                         batched_adapter=adapter is not None)

    def push(self, frames) -> List[Tuple[int, torch.Tensor]]:
        """Feed frame t of all B streams as one (B, H, W, 3) stack."""
        if frames.shape[0] != self.b:
            raise ValueError(f"a push takes {self.b} frames, got {tuple(frames.shape)}")
        return self._push(frames)

    def flush(self) -> List[Tuple[int, torch.Tensor]]:
        return self._flush()
