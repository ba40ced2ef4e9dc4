"""The BYOL data loaders, and a device prefetcher.

:class:`HostDataLoader` is the port's copy of ``nrse_tpu/data/loader.py:
28-114``: a thread pool decodes and assembles fixed-shape numpy batches
(the native C++ decoder of ``runtime/native.py`` releases the GIL, so
threads are enough), the train loader drops the last ragged batch and an
eval loader pads it and reports the true count.
:func:`create_dataloaders` is ``nrse_tpu/data/noisy_speech_dataset.py:
172-230``: the seeded random train/validation split of the port's
``NoiseRobustSpeechDataset`` (``data/noisy_speech_dataset.py``), and under
data parallelism each rank's strided shard of both at the per-rank batch.
Batches are numpy: ``clean [B, T]``,
``noise [B, T]`` float32, ``snr [B]`` float32 and ``__count__``, the number
of real rows (the validation loader pads its last batch).

:class:`DevicePrefetcher` is the counterpart of ``PrefetchLoader``
(``nrse_tpu/data/loader.py:117-181``): a thread reads host batches,
copies them into pinned memory and on to the card on a side stream, with
``depth`` batches in flight; the consumer's stream waits on each batch's
event before using it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from nrse_tpu_torch.data.noisy_speech_dataset import NoiseRobustSpeechDataset
from nrse_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
    process_local_indices,
)
from nrse_tpu_torch.runtime.native import native_readahead
from nrse_tpu_torch.utils.logging_utils import logger


class HostDataLoader:
    """Batched iterator over a dataset with per-item worker threads.

    ``dataset`` must expose ``sample(index, rng) -> Dict[str, np.ndarray]``
    returning fixed-shape arrays; failures are handled inside ``sample``
    (the retry semantics live in the dataset, as in the reference's
    ``__getitem__`` retry loop).  A dataset may also expose
    ``sample_batch(indices, rngs)`` (a vectorised decode, or None to fall
    back to per-item workers) and ``readahead_paths(indices)`` (files to
    advise the kernel about ``readahead_batches`` batches ahead).
    """

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, readahead_batches: int = 4):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0
        self.readahead_batches = readahead_batches

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.indices
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(order)
        self.epoch += 1

        bs = self.batch_size
        n_batches = len(self)
        fast_path = getattr(self.dataset, "sample_batch", None)
        ra_hook = getattr(self.dataset, "readahead_paths", None)
        ra_depth = self.readahead_batches if ra_hook is not None else 0

        def advise(b_future):
            if b_future < n_batches:
                native_readahead(ra_hook(
                    order[b_future * bs : (b_future + 1) * bs]))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(n_batches):
                if ra_depth:
                    # fire-and-forget: a pool worker opens, advises and
                    # closes the files batch b + depth will decode
                    pool.submit(advise, b + ra_depth if b else 1)
                    if b == 0:  # prime the window on the first batch
                        for k in range(2, ra_depth + 1):
                            pool.submit(advise, k)
                chunk = order[b * bs : (b + 1) * bs]
                true_count = len(chunk)
                if true_count < bs:  # pad for fixed shapes (eval only)
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - true_count)]
                    )
                item_rngs = [
                    np.random.default_rng((self.seed, self.epoch, b, i))
                    for i in range(bs)
                ]
                batch = fast_path(chunk, item_rngs) if fast_path else None
                if batch is None:
                    items = list(pool.map(
                        lambda a: self.dataset.sample(int(a[0]), a[1]),
                        zip(chunk, item_rngs),
                    ))
                    batch = {
                        k: np.stack([it[k] for it in items]) for k in items[0]
                    }
                batch["__count__"] = np.asarray(true_count, np.int32)
                yield batch


def create_dataloaders(config, mesh=None
                       ) -> Tuple[HostDataLoader, HostDataLoader]:
    """Seeded random split + train/validation loaders.  In a group of
    ranks (``parallel.distributed``) each rank loads its strided shard of
    both splits at ``batch_size / ranks`` (the batch must divide), every
    shard truncated to one length, so that every rank takes the same
    number of steps (a ragged tail would deadlock the gradient
    reduction).  With a ``mesh`` (a ``parallel.mesh.DataMesh``) the shards
    are its data axis's: the ranks of a model group load the same rows."""
    data_cfg = config["data"]
    train_cfg = config["training"]
    dataset = NoiseRobustSpeechDataset(
        clean_data_path=data_cfg["clean_data_path"],
        noise_data_path=data_cfg["noise_data_path"],
        sample_rate=data_cfg["sample_rate"],
        max_audio_length=data_cfg["max_audio_length"],
        snr_range=data_cfg["snr_range"],
    )
    n = len(dataset)
    val_size = int(n * data_cfg.get("validation_ratio", 0.1))
    train_size = n - val_size
    logger.info(f"Splitting dataset: {train_size} training samples, "
                f"{val_size} validation samples")
    seed = train_cfg.get("seed", 42)
    perm = np.random.default_rng(seed).permutation(n)
    train_idx, val_idx = perm[:train_size], perm[train_size:]
    num_workers = train_cfg.get("num_workers", 8)
    bs = train_cfg["batch_size"]
    pid, nproc = ((mesh.data_index, mesh.data) if mesh is not None
                  else (process_index(), process_count()))
    if nproc > 1:  # the split above is seeded: every rank agrees on it
        if bs % nproc != 0:
            raise ValueError(f"training.batch_size={bs} must be divisible "
                             f"by the data axis's {nproc} ranks")
        bs //= nproc
        train_idx = train_idx[process_local_indices(len(train_idx), None,
                                                    pid, nproc)]
        val_idx = val_idx[process_local_indices(len(val_idx), None, pid,
                                                nproc)]
    train_loader = HostDataLoader(dataset, train_idx, bs, shuffle=True,
                                  seed=seed, num_workers=num_workers,
                                  drop_last=True)
    val_loader = HostDataLoader(dataset, val_idx, bs, shuffle=False,
                                seed=seed, num_workers=num_workers,
                                drop_last=False)
    return train_loader, val_loader


class DevicePrefetcher:
    """Iterates ``loader``'s numpy batches as tensors on ``device``, a
    thread keeping ``depth`` batches ahead.  On a CUDA device each batch is
    pinned and copied on a side stream, and the current stream waits on
    the copy's event when the batch is handed out; on the CPU the batches
    are only converted.  ``__count__`` is handed out as an int.

    The side stream comes from torch's high-priority pool.  The streams a
    CUDA graph is captured on (``torch.cuda.graph``'s capture stream, the
    warm-up side streams of ``runtime.graphs`` and ``train.step_graphs``)
    come from the normal-priority pool, which hands its 32 streams out in
    turn: a side stream of that pool is, every so often, the very stream
    the main thread is capturing on, and a copy or an event the thread
    enqueues there during a capture (a program's first batch, a train
    step's first step) joins the graph; waiting on that event then
    fails."""

    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(1, int(depth))

    def _place(self, batch, stream):
        count = int(batch.pop("__count__"))
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if stream is None:
            return host, count, None
        with torch.cuda.stream(stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return dev, count, event

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:  # the caller's current card
            self.device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(self.device, priority=-1) if cuda \
            else None
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        err: list = []
        stop = threading.Event()

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in self.loader:
                    item = self._place(batch, stream)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                batch, count, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for t in batch.values():  # freed only after its use
                        t.record_stream(current)
                batch["__count__"] = count
                yield batch
        finally:
            stop.set()
            while thread.is_alive():  # drain so the producer can finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
