"""Model and frontend configuration, with `config.json` load and save.

The same frozen dataclass as the JAX package's `rnnt_tpu.config`, kept as
the port's own copy so that the port never imports the JAX package.  Field
names and defaults are identical, so a `config.json` written by either
package loads in the other.  The defaults are the parity configuration:
8x2048/640 encoder, 2x2048 prediction net, joint 640, V=4096, 80 mels x 3.

The port adds one choice the JAX package lacks: `encoder_type` "conformer"
(`models.conformer`, Gulati et al. 2020) in place of the projected LSTMs,
with its `conformer_*` widths and `encoder_layers` blocks; the JAX package
ignores those fields when it loads such a file.
"""

from __future__ import annotations

import dataclasses
import json
import os

# the fields only a Conformer reads: an LSTM model's config.json leaves
# them out, so that it is the JAX package's byte for byte
CONFORMER_FIELDS = ("encoder_type", "conformer_dim", "conformer_heads",
                    "conformer_ffn_size", "conformer_kernel_size")


@dataclasses.dataclass(frozen=True)
class RNNTConfig:
    # Tokenization
    token_type: str = "word-piece"          # "word-piece" | "character"
    vocab_size: int = 4096

    # Feature frontend
    mel_bins: int = 80
    frame_length: float = 0.025             # seconds
    frame_step: float = 0.01                # seconds
    hertz_low: float = 125.0
    hertz_high: float = 7600.0
    downsample_factor: int = 3              # frame stacking
    sample_rate: int = 16000

    # Model
    embedding_size: int = 500
    encoder_layers: int = 8
    encoder_size: int = 2048                # LSTM hidden size
    projection_size: int = 640              # LSTM output projection
    time_reduction_index: int = 1           # after this encoder layer
    time_reduction_factor: int = 2
    pred_net_layers: int = 2
    pred_net_size: int = 2048
    joint_size: int = 640
    dropout: float = 0.0
    init_blank_bias: float = 0.0
    # "lstm" (the fields above) or "conformer": 4x convolutional
    # subsampling, then encoder_layers Conformer blocks of conformer_dim
    # (time_reduction_index -1, no input BatchNorm)
    encoder_type: str = "lstm"
    conformer_dim: int = 512
    conformer_heads: int = 8
    conformer_ffn_size: int = 2048
    conformer_kernel_size: int = 32

    # Optimization (read and written for config.json compatibility; the
    # port's training slice has not landed)
    learning_rate: float = 1e-4
    momentum: float = 0.9
    optimizer: str = "sgd"
    grad_clip_norm: float = 0.0
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    decay_steps: int = 0
    lr_final_factor: float = 0.0
    input_noise_stddev: float = 0.0
    specaug_freq_masks: int = 0
    specaug_freq_width: int = 15
    specaug_time_masks: int = 0
    specaug_time_width: int = 20
    compute_dtype: str = "float32"          # "float32" | "bfloat16"
    loss_band: int = 32
    lstm_impl: str = "auto"

    # Decoding
    max_symbols_per_frame: int = 30
    beam_width: int = 4

    # Parallelism
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    model_parallel_size: int = 1

    def __post_init__(self):
        if self.encoder_type not in ("lstm", "conformer"):
            raise ValueError(f"encoder_type={self.encoder_type!r} (want "
                             "'lstm' or 'conformer')")
        if self.encoder_type == "conformer":
            if self.time_reduction_index >= 0:
                raise ValueError(
                    "encoder_type='conformer' subsamples by 4 itself: set "
                    "time_reduction_index=-1")
            if self.conformer_dim % self.conformer_heads:
                raise ValueError(
                    f"conformer_dim={self.conformer_dim} is not a multiple "
                    f"of conformer_heads={self.conformer_heads}")
            return
        # TimeReduction widens its output, and the additive joint needs the
        # encoder's last layer to emit projection_size: it cannot be last.
        if self.time_reduction_index >= self.encoder_layers - 1 and \
                self.encoder_layers > 0 and self.time_reduction_index >= 0:
            raise ValueError(
                f"time_reduction_index={self.time_reduction_index} must be < "
                f"encoder_layers-1={self.encoder_layers - 1}")

    @property
    def input_feat_size(self) -> int:
        """Encoder input width: mel_bins x frame stacking."""
        return self.mel_bins * self.downsample_factor

    @property
    def encoder_output_size(self) -> int:
        """Width of the encoder's output (the joint's encoder side)."""
        return (self.conformer_dim if self.encoder_type == "conformer"
                else self.projection_size)

    @property
    def frame_length_samples(self) -> int:
        return int(round(self.sample_rate * self.frame_length))

    @property
    def frame_step_samples(self) -> int:
        return int(round(self.sample_rate * self.frame_step))

    def replace(self, **kw) -> "RNNTConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """The fields as `config.json` holds them (`CONFORMER_FIELDS` only
        for a Conformer)."""
        d = dataclasses.asdict(self)
        if self.encoder_type == "lstm":
            for k in CONFORMER_FIELDS:
                del d[k]
        return d

    def save(self, directory: str, filename: str = "config.json") -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, filename)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, directory: str, filename: str = "config.json") -> "RNNTConfig":
        with open(os.path.join(directory, filename)) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def tiny_config(**overrides) -> RNNTConfig:
    """A debug-scale config, the same as the JAX package's `tiny_config`."""
    base = dict(
        token_type="character",
        vocab_size=31,
        embedding_size=32,
        encoder_layers=2,
        encoder_size=64,
        projection_size=48,
        pred_net_layers=1,
        pred_net_size=64,
        joint_size=32,
        mel_bins=16,
        downsample_factor=1,
        time_reduction_index=0,
    )
    base.update(overrides)
    return RNNTConfig(**base)
