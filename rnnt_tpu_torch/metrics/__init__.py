"""Decode metrics."""

from rnnt_tpu_torch.metrics.edit_distance import (accuracy, cer,  # noqa: F401
                                                  edit_distance, error_rate,
                                                  wer)
