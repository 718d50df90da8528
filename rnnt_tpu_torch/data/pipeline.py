"""Corpus featurisation and the batching pipeline over record shards: the
port of `rnnt_tpu.data.pipeline`.

`preprocess_utterance` turns one (audio, transcript) into a training
example: the transcript is tokenised, the audio goes to `device` and
through `ops.features.preprocess_audio` (on the card, the frontend kernel
K1, then mean subtraction and frame stacking), and the features come back
as float32 numpy.  `preprocess_corpus` streams a corpus through it;
`preprocess_corpus_parallel` reads, decodes and tokenises in spawned worker
processes while this process featurises each example on `device` in the
corpus order, so its shards are byte-identical to the serial path's.

Examples are grouped into (T, U) buckets and padded to the bucket
boundaries, so a run sees a small closed set of shapes; a partial bucket is
repeat-padded to the batch size with `loss_weight` 0 on the filler rows and
`num_real` set.  `prefetch` assembles batches on a background thread.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.data import records as records_mod


def _featurise(audio: np.ndarray, sample_rate: int, labels: np.ndarray,
               cfg: RNNTConfig, device) -> Optional[Dict]:
    """The example of tokenised `labels` and `audio`, featurised on
    `device`; None for an empty tokenisation or no stacked frame."""
    import torch

    from rnnt_tpu_torch.ops import features as F

    if sample_rate != cfg.sample_rate:
        raise ValueError(f"expected {cfg.sample_rate} Hz, got {sample_rate}")
    if labels.size == 0:
        return None
    audio = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    mel = F.preprocess_audio(audio, cfg).cpu().numpy().astype(np.float32)
    if mel.shape[0] == 0:
        return None
    pred_inp = np.concatenate([np.zeros(1, np.int32), labels])
    return {
        "mel_specs": mel,
        "pred_inp": pred_inp,
        "labels": labels,
        "spec_lengths": np.int32(mel.shape[0]),
        "label_lengths": np.int32(labels.shape[0]),
    }


def preprocess_utterance(audio: np.ndarray, sample_rate: int, text: str,
                         tokenizer, cfg: RNNTConfig,
                         device="cuda") -> Optional[Dict]:
    """One (audio, transcript) -> training example dict: stacked log-mel
    features made on `device`, the tokenised labels, and pred_inp, the
    labels after a leading blank 0.  Returns None for an empty tokenisation
    or fewer stacked frames than one."""
    from rnnt_tpu_torch.device import resolve_device

    labels = np.asarray(tokenizer.encode(text), np.int32)
    return _featurise(audio, sample_rate, labels, cfg, resolve_device(device))


def preprocess_corpus(utterances: Iterable[Tuple[np.ndarray, int, str]],
                      tokenizer, cfg: RNNTConfig,
                      max_length_seconds: float = 0.0,
                      device="cuda") -> Iterator[Dict]:
    """Featurise a corpus stream on `device`, dropping audio longer than
    `max_length_seconds` (0: keep all) and the utterances
    `preprocess_utterance` drops."""
    from rnnt_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    for audio, sr, text in utterances:
        if max_length_seconds > 0 and len(audio) > sr * max_length_seconds:
            continue
        ex = preprocess_utterance(audio, sr, text, tokenizer, cfg, dev)
        if ex is not None:
            yield ex


_PP_STATE: Dict = {}  # per-worker-process preprocessing context


def _pp_worker_init(sidecar_dir: str, token_type: str, vocab_size: int,
                    max_length_seconds: float) -> None:
    from rnnt_tpu_torch.data.tokenizer import get_tokenizer

    _PP_STATE["tok"] = get_tokenizer(sidecar_dir, token_type, vocab_size)
    _PP_STATE["max_s"] = max_length_seconds


def _pp_read(pair) -> Optional[Tuple[np.ndarray, int, np.ndarray]]:
    """Worker body: read, decode and tokenise one (audio_path, transcript);
    None for audio over the length limit.  A read error propagates."""
    from rnnt_tpu_torch.data import audio_io

    path, text = pair
    audio, sr = audio_io.read_audio(path)
    if _PP_STATE["max_s"] > 0 and len(audio) > sr * _PP_STATE["max_s"]:
        return None
    return audio, sr, np.asarray(_PP_STATE["tok"].encode(text), np.int32)


def preprocess_corpus_parallel(file_text_pairs, sidecar_dir: str,
                               cfg: RNNTConfig, *, workers: int,
                               max_length_seconds: float = 0.0,
                               device="cuda") -> Iterator[Dict]:
    """Featurise a corpus of (audio_path, transcript) pairs with a pool of
    `workers` spawned processes that read, decode and tokenise, while this
    process featurises each example on `device`.

    Ordered `imap` keeps the example order of the serial path, and the
    featuriser runs in this process on the same device, so the shards are
    byte-identical to `preprocess_corpus`'s.  The tokenizer sidecar must
    already be saved under `sidecar_dir` (the preprocess CLIs write it
    before the split loop)."""
    import multiprocessing as mp

    from rnnt_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers, initializer=_pp_worker_init,
                  initargs=(sidecar_dir, cfg.token_type, cfg.vocab_size,
                            max_length_seconds)) as pool:
        for item in pool.imap(_pp_read, file_text_pairs, chunksize=4):
            if item is None:
                continue
            ex = _featurise(*item, cfg, dev)
            if ex is not None:
                yield ex


def _round_up(n: int, sizes: Sequence[int]) -> int:
    i = bisect.bisect_left(sizes, n)
    return sizes[i] if i < len(sizes) else sizes[-1]


def default_buckets(max_t: int = 2000, max_u: int = 400):
    """Geometric-ish bucket boundaries for frame/label lengths."""
    t = [64, 128, 192, 256, 384, 512, 768, 1024, 1536, max_t]
    u = [16, 32, 48, 64, 96, 128, 192, 256, max_u]
    return t, u


def pad_batch(examples: List[Dict], t_pad: int, u_pad: int) -> Dict[str, np.ndarray]:
    """Stack examples, padding mel to t_pad frames and labels to u_pad.

    `loss_weight` [B] marks real rows (1.0) vs repeat-padding fillers (0.0,
    set by bucket_batches) — the train step weights per-example losses by it
    so fillers contribute neither loss nor gradient."""
    B = len(examples)
    feat = examples[0]["mel_specs"].shape[1]
    mel = np.zeros((B, t_pad, feat), np.float32)
    pred_inp = np.zeros((B, u_pad + 1), np.int32)
    labels = np.zeros((B, u_pad), np.int32)
    spec_lengths = np.zeros((B,), np.int32)
    label_lengths = np.zeros((B,), np.int32)
    for i, ex in enumerate(examples):
        t, u = ex["mel_specs"].shape[0], ex["labels"].shape[0]
        mel[i, :t] = ex["mel_specs"]
        pred_inp[i, :u + 1] = ex["pred_inp"]
        labels[i, :u] = ex["labels"]
        spec_lengths[i] = t
        label_lengths[i] = u
    return {
        "mel_specs": mel, "pred_inp": pred_inp, "labels": labels,
        "spec_lengths": spec_lengths, "label_lengths": label_lengths,
        "loss_weight": np.ones((B,), np.float32),
    }


def shuffle_stream(examples: Iterable[Dict], buffer_size: int,
                   seed: int = 0) -> Iterator[Dict]:
    """Reservoir-style shuffle over a streaming iterator (the tf.data
    .shuffle(buffer) equivalent the reference pipeline lacked): keeps
    `buffer_size` examples resident, yields a random one per pull."""
    if buffer_size <= 1:
        yield from examples
        return
    rng = np.random.default_rng(seed)
    buf: List[Dict] = []
    for ex in examples:
        buf.append(ex)
        if len(buf) >= buffer_size:
            idx = rng.integers(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def bucket_batches(
    examples: Iterable[Dict],
    batch_size: int,
    *,
    t_buckets: Optional[Sequence[int]] = None,
    u_buckets: Optional[Sequence[int]] = None,
    drop_oversize: bool = True,
    flush_partial: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Group examples into per-(t,u)-bucket batches with fixed padded shapes."""
    if t_buckets is None or u_buckets is None:
        dt, du = default_buckets()
        t_buckets = t_buckets or dt
        u_buckets = u_buckets or du
    t_buckets, u_buckets = sorted(t_buckets), sorted(u_buckets)
    pending: Dict[Tuple[int, int], List[Dict]] = {}
    for ex in examples:
        # .item() (not int()): record deserialization yields 1-element arrays,
        # and int() on those is a NumPy deprecation headed for an error
        t = int(np.asarray(ex["spec_lengths"]).item())
        u = int(np.asarray(ex["label_lengths"]).item())
        if t > t_buckets[-1] or u > u_buckets[-1]:
            if drop_oversize:
                continue
            raise ValueError(f"example T={t} U={u} exceeds bucket bounds")
        key = (_round_up(t, t_buckets), _round_up(u, u_buckets))
        group = pending.setdefault(key, [])
        group.append(ex)
        if len(group) == batch_size:
            yield pad_batch(group, key[0], key[1])
            pending[key] = []
    if flush_partial:
        for key, group in pending.items():
            if group:
                # repeat-pad to full batch size so shapes stay closed-set
                reps = (batch_size + len(group) - 1) // len(group)
                full = (group * reps)[:batch_size]
                batch = pad_batch(full, key[0], key[1])
                n_real = len(group)
                batch["spec_lengths"][n_real:] = 1
                batch["label_lengths"][n_real:] = 0
                batch["loss_weight"][n_real:] = 0.0  # fillers: no loss/grad
                batch["num_real"] = np.int32(n_real)
                yield batch


_END, _ERR = object(), object()


def _pump(iterable, q, stop) -> None:
    """Producer-thread body: move items into `q` until exhausted or stopped.

    Always terminates with _END (or an (_ERR, exc) pair) and honors `stop`
    even when the queue is full, so an abandoned consumer can never leave
    the thread blocked in q.put holding batches and open shard files."""
    import queue as queue_mod

    try:
        for item in iterable:
            while True:
                if stop.is_set():
                    return
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue_mod.Full:
                    continue
        q.put(_END)
    except BaseException as ex:  # noqa: BLE001 — re-raised at consumer
        q.put((_ERR, ex))
    finally:
        close = getattr(iterable, "close", None)  # free generator resources
        if close is not None:
            try:
                close()
            except Exception:
                pass


def _drain(q, stop, n_producers: int) -> Iterator:
    """Consumer side of _pump: yield until every producer finished.

    Implemented as a generator so an early-exiting consumer (eval's
    max_batches break, preemption) triggers GeneratorExit here and the
    finally block signals the producers to stop."""
    try:
        done = 0
        while done < n_producers:
            item = q.get()
            if item is _END:
                done += 1
            elif isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            else:
                yield item
    finally:
        stop.set()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run `iterable` on a background thread, keeping `depth` items queued.

    The host-side batch assembly (read + CRC + shuffle + pad copies) then
    overlaps with device steps beyond the single step JAX's async dispatch
    hides — the tf.data `.prefetch()` equivalent (run_rnnt.py:84).
    Exceptions on the producer thread re-raise at the consumer; abandoning
    the iterator stops the producer thread."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    threading.Thread(target=_pump, args=(iterable, q, stop),
                     daemon=True).start()
    return _drain(q, stop, 1)


def _threaded_examples(paths: List[str], n_threads: int,
                       queue_size: int = 512) -> Iterator[Dict]:
    """Interleave examples from shard files read by `n_threads` workers.

    Scales the read+deserialize rate past one core (CRC32 and numpy buffer
    copies release the GIL).  Interleaving order is nondeterministic — use
    only with shuffle_buffer > 1 (training); keep the default single-threaded
    reader where byte-for-byte reproducibility matters (eval, tests)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=queue_size)
    stop = threading.Event()
    for i in range(n_threads):
        threading.Thread(
            target=_pump,
            args=(records_mod.read_shards(paths[i::n_threads]), q, stop),
            daemon=True).start()
    return _drain(q, stop, n_threads)


def batches_from_shards(pattern: str, batch_size: int, *,
                        process_index: int = 0, process_count: int = 1,
                        shuffle_buffer: int = 0, seed: int = 0,
                        reader_threads: int = 1,
                        **bucket_kw) -> Iterator[Dict[str, np.ndarray]]:
    """records shards -> bucketed padded batches (the get_dataset equivalent,
    run_rnnt.py:66-90, with host-disjoint shard reading for multi-host).

    shuffle_buffer > 1 enables streaming shuffle; pass a per-epoch seed so
    every epoch sees a different order.  reader_threads > 1 parallelizes
    shard reading (nondeterministic interleave; requires shuffle_buffer > 1)
    for hosts feeding many chips."""
    if reader_threads > 1:
        if shuffle_buffer <= 1:
            raise ValueError("reader_threads > 1 requires shuffle_buffer > 1 "
                             "(parallel reads interleave nondeterministically)")
        import glob as globlib
        paths = sorted(globlib.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"no shards match {pattern}")
        mine = paths[process_index::process_count]
        stream = (_threaded_examples(mine, min(reader_threads, len(mine)))
                  if mine else iter(()))  # this host owns no shards
    else:
        stream = records_mod.read_shards(
            pattern, process_index=process_index, process_count=process_count)
    if shuffle_buffer > 1:
        stream = shuffle_stream(stream, shuffle_buffer, seed)
    yield from bucket_batches(stream, batch_size, **bucket_kw)
