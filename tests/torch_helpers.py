"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
JAX parameters carried into the port's modules, and small WAV bodies."""

import io

import jax
import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
from rnnt_tpu_torch.models.transducer import Transducer as TorchTransducer
from rnnt_tpu_torch.train.checkpoint import params_from_numpy

# tier-1 runs several xdist workers on a few cores
torch.set_num_threads(1)


def numpy_tree(params):
    """JAX param pytree -> the same nesting of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)


def torch_model(cfg, params) -> TorchTransducer:
    """The port's Transducer holding a JAX config's parameters (fp32, CPU)."""
    model = TorchTransducer(TorchConfig(**cfg.__dict__))
    model.load_state_dict(params_from_numpy(numpy_tree(params)))
    return model.eval()


def sharpen_joint(params, factor: float = 8.0):
    """The params with the joint's output layer scaled by `factor`.  A
    random tiny model's joint is so flat that blank wins every frame and
    every search decodes to nothing; a sharp one emits a few tokens per
    utterance, so that the parity tests compare real hypotheses."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["joint"] = dict(params["joint"], w2=params["joint"]["w2"] * factor)
    return params


def sharp_train_state(cfg, seed: int, factor: float = 8.0):
    """A JAX TrainState (for checkpoints) whose joint is sharpened."""
    from rnnt_tpu.train.state import create_train_state

    state = create_train_state(jax.random.PRNGKey(seed), cfg)
    return state._replace(params=sharpen_joint(state.params, factor))


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    from rnnt_tpu_torch.data.audio_io import write_wav

    buf = io.BytesIO()
    write_wav(buf, audio, sr)
    return buf.getvalue()
