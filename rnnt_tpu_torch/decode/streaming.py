"""Streaming (chunked) transcription with carried state.

The port of `rnnt_tpu.decode.streaming.StreamingTranscriber`: audio arrives
in chunks, and each chunk continues the previous one's state, namely

- a priming buffer: the first `prime_seconds` of audio are held until the
  causal feature mean has a usable estimate;
- the sample remainder (a frame's overlap straddles chunk boundaries), the
  frame remainder (frames that do not fill a stack of `downsample_factor`)
  and the stacked remainder (stacks that do not fill a TimeReduction pair),
  so that chunked encoding equals one-shot encoding of the same features;
- the causal running mean of the raw log-mels, summed in float64 on the
  host: training features were whole-utterance mean-subtracted, a statistic
  that exists only at stream end; held-back frames stay raw and are
  normalized with the best mean available when they are fed;
- the encoder's LSTM state, greedy decoding's carry (pred_out, pred_state),
  and the decode bound `n_valid`: flush() pads the tail with zeros to push
  the remainders through, and frames made only of that pad are not decoded.

On the card each chunk runs the frontend kernel (raw log-mels), the encoder
(the LSTM kernel at chunk shapes, with carried state) and greedy decoding;
on the CPU their plain versions.  Eager PyTorch compiles nothing per chunk
length, so every session calls the same `_run_chunk`.

`streamed_vs_offline` is the quality harness: it decodes utterances both
offline and chunk-streamed and scores each by WER.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
from rnnt_tpu_torch.models.encoder import require_lstm_encoder
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import features as F


@torch.no_grad()
def _run_chunk(model: Transducer, mel: torch.Tensor, enc_state, carry,
               n_valid: int, max_tokens: int):
    """Encode one chunk's features [T, feat] from `enc_state` and greedy-
    decode at most its first n_valid encoder frames from `carry`.  Returns
    (token ids, new encoder state, new carry)."""
    encoded, new_state = model.encode(mel[None], state=enc_state)
    enc_len = torch.tensor([min(encoded.shape[1], n_valid)],
                           dtype=torch.int32, device=mel.device)
    tokens, lengths, new_carry = greedy_decode_encoded(
        model, encoded, enc_len, max_output_length=max_tokens, carry=carry)
    return tokens[0, : int(lengths[0])].tolist(), new_state, new_carry


class StreamingTranscriber:
    """Stateful chunk-by-chunk transcription (batch 1) on the model's
    device."""

    def __init__(self, model: Transducer, tokenizer, *,
                 max_tokens_per_chunk: int = 64, prime_seconds: float = 0.5,
                 device_lock=None):
        """prime_seconds: audio buffered before the first decode, so that
        the causal feature mean starts from a usable estimate (0 disables).
        device_lock: a lock serializing device work with other users of the
        same card (the server shares one across HTTP requests and every
        stream); None means the caller owns the device."""
        require_lstm_encoder(model.cfg, "streaming transcription")
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_tokens_per_chunk = max_tokens_per_chunk
        self.prime_samples = int(prime_seconds * self.cfg.sample_rate)
        self._device_lock = device_lock
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.model.joint.w1.device

    def reset(self) -> None:
        cfg = self.cfg
        self._primed = self.prime_samples == 0
        self._prime_buf = np.zeros((0,), np.float32)
        self._sample_rem = np.zeros((0,), np.float32)
        self._frame_rem = np.zeros((0, cfg.mel_bins), np.float32)
        self._stacked_rem = np.zeros((0, cfg.input_feat_size), np.float32)
        self._lm_sum = np.zeros((cfg.mel_bins,), np.float64)
        self._lm_count = 0
        self._enc_state = None
        self._carry = None
        self._text_ids: List[int] = []
        self._decoded_n = 0
        self._decoded_text = ""
        self._real_samples = 0
        self._enc_done = 0  # encoder frames already decoded
        self._flushed = False

    @property
    def text(self) -> str:
        # decode the ids again only when new tokens arrived
        if len(self._text_ids) != self._decoded_n:
            self._decoded_text = self.tokenizer.decode(self._text_ids)
            self._decoded_n = len(self._text_ids)
        return self._decoded_text

    def _reduction(self) -> int:
        cfg = self.cfg
        return cfg.time_reduction_factor if cfg.time_reduction_index >= 0 \
            else 1

    def flush(self) -> str:
        """Drain the held-back tail at the end of the stream: zero samples
        complete every alignment boundary, so that the real tail is decoded.
        Returns the final transcript.  Terminal: the pad is in the encoder
        state, so a new utterance starts with reset()."""
        cfg = self.cfg
        if not self._primed:  # a short stream: force the buffered audio out
            self._primed = True
            pending, self._prime_buf = self._prime_buf, np.zeros(
                (0,), np.float32)
            self.process_chunk(pending, real=False)  # counted when buffered
        pad = (cfg.frame_length_samples + cfg.frame_step_samples
               * cfg.downsample_factor * (self._reduction() + 1))
        out = self.process_chunk(np.zeros(pad, np.float32), real=False)
        self._flushed = True
        return out

    def _valid_enc_frames(self) -> int:
        """Upper bound on encoder frames backed by real audio."""
        cfg = self.cfg
        frames = -(-self._real_samples // cfg.frame_step_samples)
        stacked = -(-frames // cfg.downsample_factor)
        return -(-stacked // self._reduction())

    def process_chunk(self, samples: np.ndarray, real: bool = True) -> str:
        """Feed raw audio samples; returns the transcript so far.
        real=False marks filler samples (the flush pad, the priming
        re-feed) that must not extend the decoded region."""
        cfg = self.cfg
        if self._flushed and real:
            raise RuntimeError(
                "process_chunk after flush(): flush is terminal (its zero "
                "pad is already in the encoder state); call reset() before "
                "streaming a new utterance")
        if real:
            self._real_samples += len(samples)
        if not self._primed:
            self._prime_buf = np.concatenate(
                [self._prime_buf, np.asarray(samples, np.float32)])
            if len(self._prime_buf) < self.prime_samples:
                return self.text
            samples, self._prime_buf = self._prime_buf, np.zeros(
                (0,), np.float32)
            self._primed = True
        buf = np.concatenate([self._sample_rem,
                              np.asarray(samples, np.float32)])

        frame_len, step = cfg.frame_length_samples, cfg.frame_step_samples
        n_frames = max(0, 1 + (len(buf) - frame_len) // step)
        if n_frames == 0:
            self._sample_rem = buf
            return self.text
        consumed = n_frames * step
        self._sample_rem = buf[consumed:]

        with self._locked():
            audio = torch.from_numpy(
                np.ascontiguousarray(buf[: consumed + (frame_len - step)]))
            log_mel = F.log_mel_spectrogram(
                audio.to(self.device), cfg, mean_subtract=False).cpu().numpy()
        self._lm_sum += log_mel.sum(axis=0, dtype=np.float64)
        self._lm_count += len(log_mel)
        mean = (self._lm_sum / max(self._lm_count, 1)).astype(np.float32)

        frames = np.concatenate([self._frame_rem, log_mel], 0)
        n_stack = (len(frames) // cfg.downsample_factor) \
            * cfg.downsample_factor
        self._frame_rem = frames[n_stack:]
        mel_raw = np.concatenate([
            self._stacked_rem,
            frames[:n_stack].reshape(-1, cfg.input_feat_size)], 0)
        mel = mel_raw - np.tile(mean, cfg.downsample_factor)
        # feed a multiple of the reduction factor (exact state continuation)
        r = self._reduction()
        n_feed = (len(mel) // r) * r
        self._stacked_rem = mel_raw[n_feed:]  # raw: normalized when fed
        if n_feed == 0:
            return self.text

        n_valid = max(0, self._valid_enc_frames() - self._enc_done)
        self._enc_done += n_feed // r
        with self._locked():
            ids, self._enc_state, self._carry = _run_chunk(
                self.model, torch.from_numpy(mel[:n_feed]).to(self.device),
                self._enc_state, self._carry, n_valid,
                self.max_tokens_per_chunk)
        self._text_ids.extend(ids)
        return self.text

    def _locked(self):
        """The device lock, or a no-op context without one.  Reading the
        results back inside it also waits for the card, so a concurrent
        session waits at most one chunk's work."""
        if self._device_lock is None:
            return contextlib.nullcontext()
        return self._device_lock


@torch.no_grad()
def streamed_vs_offline(model: Transducer, tokenizer, utterances, *,
                        chunk_samples: int = 1024,
                        max_output_length: int = 256):
    """Decode (audio, sr, ref_text) utterances offline AND chunk-streamed,
    on the model's device.

    Measures the quality cost of causal streaming (the running-mean feature
    normalization is exact only at stream end, so early chunks see a
    noisier estimate).  Offline, each utterance's features are padded to a
    multiple of 128 frames and greedy-decoded; streamed, a
    `StreamingTranscriber` is reset, fed `chunk_samples` at a time and
    flushed.  Both are scored with `metrics.wer` against the normalized
    references.  Returns (offline_wer, streamed_wer, details), details being
    [(ref, offline_text, streamed_text)].

    The offline phase runs over every utterance before the streamed one, as
    in the JAX package; the raw audio is held on the host between them, so
    host memory grows with the utterance set (`utterances` may be a one-shot
    generator): bound it with the caller's max_utts."""
    from rnnt_tpu_torch.data.tokenizer import normalize_text
    from rnnt_tpu_torch.decode.greedy import greedy_decode
    from rnnt_tpu_torch.metrics import wer as wer_fn

    cfg = model.cfg
    dev = model.joint.w1.device
    refs, off_texts, str_texts = [], [], []
    audios = []
    for audio, sr, ref in utterances:
        if sr != cfg.sample_rate:
            raise ValueError(f"expected {cfg.sample_rate} Hz audio, got {sr}")
        audio = np.asarray(audio, np.float32)
        audios.append(audio)
        mel = F.preprocess_audio(torch.from_numpy(audio).to(dev), cfg)
        t = mel.shape[0]
        pad_t = -(-t // 128) * 128
        mel_p = torch.zeros((1, pad_t, mel.shape[1]), device=dev)
        mel_p[0, :t] = mel
        tokens, lengths = greedy_decode(
            model, mel_p, torch.tensor([t], dtype=torch.int32, device=dev),
            max_output_length=max_output_length)
        off_texts.append(tokenizer.decode(
            tokens[0, : int(lengths[0])].tolist()))
        refs.append(normalize_text(ref))

    st = StreamingTranscriber(model, tokenizer)
    for audio in audios:
        st.reset()
        for o in range(0, len(audio), chunk_samples):
            st.process_chunk(audio[o: o + chunk_samples])
        str_texts.append(st.flush())

    return (wer_fn(refs, off_texts), wer_fn(refs, str_texts),
            list(zip(refs, off_texts, str_texts)))
