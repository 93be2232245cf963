"""Dataset and loader factories (port of dynavsr_tpu/data/loader.py).

create_dataset dispatches on a dataset block's `mode`, as the JAX package
does. create_dataloader returns a PrefetchLoader: shuffled batches of
stacked numpy items, decoded ahead by a small thread pool (image decode and
the numpy copies release the interpreter lock).

Under torch.distributed the config's `batch_size` is the global batch, as
in JAX's one-process mesh and the reference's DDP; it must divide by the
world size. Every rank walks the same (seed, epoch) index stream in global
batches and decodes its contiguous share of each (parallel/mesh.batch_rows),
each item with the augmentation rng of its global stream position: the W
ranks' batches, concatenated in rank order, are the one-process run's
batch, item for item, and resume skip-ahead counts global batches.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Mapping, Optional

import numpy as np

from dynavsr_tpu_torch.data.datasets import (
    MetaVideoDataset,
    REDSDataset,
    VideoTestDataset,
    Vimeo90KDataset,
    Vimeo90KTestDataset,
)
from dynavsr_tpu_torch.parallel import mesh

__all__ = ["create_dataset", "create_dataloader", "PrefetchLoader"]

_VIDEO_TEST = ("video_test", "video_samedirs", "Vid4", "REDS4")
_VIMEO_TEST = ("Vimeo90K_test", "vimeo90k_test")
_META = ("meta", "meta_learner", "MetaREDS", "MetaVimeo")
_PREFETCH = 4  # batches decoded ahead


def create_dataset(dataset_opt: Mapping):
    mode = dataset_opt["mode"]
    if mode == "REDS":
        return REDSDataset(dataset_opt)
    if mode == "Vimeo90K":
        return Vimeo90KDataset(dataset_opt)
    if mode in _VIDEO_TEST:
        return VideoTestDataset(dataset_opt)
    if mode in _VIMEO_TEST:
        return Vimeo90KTestDataset(dataset_opt)
    if mode in _META:
        return MetaVideoDataset(dataset_opt)
    raise NotImplementedError(f"Dataset [{mode}] is not recognized.")


class PrefetchLoader:
    """Iterates a dataset in shuffled batches, a background thread pool
    decoding up to _PREFETCH batches ahead. The index stream of an epoch
    and each item's augmentation rng are functions of (seed, epoch, stream
    position) only, so set_skip_batches resumes a run on exactly the
    batches it would have seen. A worker's exception is raised in the
    consumer. `batch_size` is the global batch; rank `rank` of `world`
    yields its contiguous share of each (batch_size / world items)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 3, rank: int = 0, world: int = 1):
        self.rows = mesh.batch_rows(batch_size, rank, world)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (the reference's DistIterSampler.set_epoch)."""
        self.epoch = epoch

    def set_skip_batches(self, n: int) -> None:
        """The next iteration starts at batch n of the epoch; the skipped
        items are not decoded."""
        self._skip_batches = n

    def _fetch(self, index: int, stream_pos: int):
        get = getattr(self.dataset, "get_item", None)
        if get is None:
            return self.dataset[int(index)]
        return get(int(index), random.Random(hash((self.seed, self.epoch, int(stream_pos)))))

    def _index_stream(self) -> np.ndarray:
        n = len(self.dataset)
        return mesh.process_local_slice(n, self.seed, self.epoch) if self.shuffle \
            else np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Full batches only: a last partial batch is dropped."""
        idx = self._index_stream()
        nb = len(idx) // self.batch_size
        first = min(self._skip_batches, nb)
        self._skip_batches = 0
        out_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for b in range(first, nb):
                        pos0 = b * self.batch_size + self.rows.start
                        batch_idx = idx[pos0: b * self.batch_size + self.rows.stop]
                        items = list(ex.map(self._fetch, batch_idx,
                                            range(pos0, pos0 + len(batch_idx))))
                        batch: Dict[str, np.ndarray] = {}
                        for k, v0 in items[0].items():
                            if isinstance(v0, np.ndarray):
                                batch[k] = np.stack([it[k] for it in items], axis=0)
                            else:
                                batch[k] = [it[k] for it in items]
                        if not put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)

    def __len__(self) -> int:
        return len(self._index_stream()) // self.batch_size


def create_dataloader(dataset, dataset_opt: Mapping, opt: Optional[Mapping] = None
                      ) -> PrefetchLoader:
    """The training set's loader: shuffled batches of `batch_size` (seed
    train.manual_seed, `n_workers` decode threads), this rank's share of
    each under torch.distributed. Test and validation sets are read by
    eval/harness.evaluate_dataset, not through a loader."""
    if dataset_opt.get("phase", "test") != "train":
        raise ValueError(f"phase {dataset_opt.get('phase')!r}: the loader serves the training "
                         "set; evaluate_dataset reads test sets")
    return PrefetchLoader(
        dataset,
        batch_size=dataset_opt.get("batch_size", 16),
        shuffle=dataset_opt.get("use_shuffle", True) is not False,
        seed=((opt or {}).get("train") or {}).get("manual_seed") or 0,
        num_workers=dataset_opt.get("n_workers", 3),
        rank=mesh.get_rank(),
        world=mesh.get_world_size(),
    )
