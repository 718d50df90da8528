"""Scalar metrics to JSONL (always) and TensorBoard (optional): the port of
`rnnt_tpu.train.observe`.  One `metrics.jsonl` record per call
({"step", "time", name: value...}) and an `hparams.json` of the config,
under log_dir/run_name; JSONL is the source of truth.  When `tensorboard`
is importable, the same scalars and an HParams plugin session summary also
go to TensorBoard event files in that directory."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: str, run_name: Optional[str] = None):
        run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:  # the optional TensorBoard writer
            from tensorboard.summary import Writer
        except ImportError:
            self._tb = None
        else:
            self._tb = Writer(self.dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def hparams(self, cfg) -> None:
        """The run's hyperparameters: `hparams.json` always; with
        TensorBoard also an HParams plugin session summary, so runs compare
        in its HPARAMS tab.  `tensorboard.summary.Writer` has no raw-summary
        hook, so the event goes through its underlying event writer, as the
        JAX package's writer does."""
        d = cfg.to_dict()
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)
        if self._tb is None:
            return
        from tensorboard.compat.proto import event_pb2
        # summary_v2 holds hparams_pb; the `api` module would import
        # TensorFlow where it is installed
        from tensorboard.plugins.hparams import summary_v2 as hp

        flat = {k: (v if isinstance(v, (bool, int, float, str))
                    else json.dumps(v)) for k, v in d.items()}
        ev = event_pb2.Event(wall_time=time.time(), summary=hp.hparams_pb(flat))
        self._tb._output._ev_writer.add_event(ev)  # noqa: SLF001

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
