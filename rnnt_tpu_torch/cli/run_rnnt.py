"""Train or evaluate a model on preprocessed record shards, on the card
(PyTorch/CUDA port of `rnnt_tpu.cli.run_rnnt`, one process, one device).

  python -m rnnt_tpu_torch.cli.run_rnnt --mode train \\
      --data_dir data/ls --output_dir runs/ls100 [--checkpoint runs/ls100]
  python -m rnnt_tpu_torch.cli.run_rnnt --mode test --data_dir data/ls \\
      --checkpoint runs/ls100

Modes: train | eval (dev split) | test (test split).  The flags are the JAX
CLI's, plus --device (cuda by default; cpu runs the plain PyTorch path).
Checkpoints use the JAX package's npz layout, so either package resumes the
other's.  --quantized A replaces the weights by an int8 artifact's
(`cli.quantize_model`), dequantized; with --int8_exec (eval/test only) the
prediction net's and joint's products run in int8, beam decoding searches
with the XLA beam's counterpart, and no loss is reported (the loss paths
read fp joint weights).  Not yet ported, and refused with an error:
--model_parallel > 1, --multihost, --ckpt_backend orbax, --loss_impl
banded, --profile_dir.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="train", choices=["train", "eval", "test"])
    p.add_argument("--data_dir", required=True,
                   help="directory of preprocessed .rnr shards + tokenizer")
    p.add_argument("--output_dir", default="./model",
                   help="checkpoints and logs")
    p.add_argument("--checkpoint", default=None,
                   help="resume/eval from this checkpoint dir; 'auto' resumes "
                        "from the latest checkpoint in --output_dir if any")
    p.add_argument("--init_from", default=None, metavar="CKPT_DIR",
                   help="warm start: weights from this checkpoint, fresh "
                        "optimizer and step (ignored when a resume "
                        "checkpoint applies)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_epochs", type=int, default=1000)
    p.add_argument("--steps_per_log", type=int, default=10)
    p.add_argument("--steps_per_checkpoint", type=int, default=1000)
    p.add_argument("--eval_size", type=int, default=50,
                   help="max eval batches per periodic eval")
    p.add_argument("--reader_threads", type=int, default=1,
                   help="parallel shard-reader threads for training")
    p.add_argument("--shuffle_buffer", type=int, default=4096,
                   help="streaming shuffle buffer for training (0 = off; "
                        "reseeded per epoch)")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 parameters and activations")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--transfer_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype of the mel features sent to the device")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size (only 1 in the PyTorch port)")
    p.add_argument("--loss_impl", default="fused",
                   choices=["fused", "banded", "auto", "ref", "pallas"],
                   help="fused = joint + loss kernels, never materialising "
                        "the lattice logits; ref/pallas materialise them "
                        "(pallas: lattice kernel); banded is not yet ported")
    p.add_argument("--decode", default="greedy", choices=["greedy", "beam"],
                   help="eval-time decoder")
    p.add_argument("--quantized", default=None, metavar="MODEL_INT8_NPZ",
                   help="int8-quantized weights (cli.quantize_model output), "
                        "dequantized: measures the WER delta against fp")
    p.add_argument("--int8_exec", action="store_true",
                   help="with --quantized: execute the prediction net's and "
                        "joint's products in int8 (eval/test only; no loss "
                        "metrics)")
    p.add_argument("--profile_dir", default=None, help="not yet ported")
    p.add_argument("--ckpt_backend", default="auto",
                   choices=["auto", "npz", "orbax"],
                   help="auto and npz write npz checkpoints; orbax is not "
                        "yet ported")
    p.add_argument("--multihost", action="store_true",
                   help="not yet ported")
    p.add_argument("--coordinator_address", default=None,
                   help="with --multihost only")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--pad_frames", type=int, default=0,
                   help="pad every batch to this many mel frames (one "
                        "static shape instead of (T, U) buckets)")
    p.add_argument("--pad_tokens", type=int, default=0,
                   help="pad every batch to this many label tokens")
    p.add_argument("--config_override", nargs="*", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    if args.reader_threads > 1 and args.shuffle_buffer <= 1:
        p.error("--reader_threads > 1 requires --shuffle_buffer > 1 "
                "(parallel reads interleave nondeterministically)")
    unported = [flag for flag, on in (
        ("--model_parallel > 1", args.model_parallel > 1),
        ("--multihost", args.multihost),
        ("--ckpt_backend orbax", args.ckpt_backend == "orbax"),
        ("--loss_impl banded", args.loss_impl == "banded"),
        ("--profile_dir", args.profile_dir is not None)) if on]
    if unported:
        p.error(f"not yet ported to the PyTorch port: {', '.join(unported)}")
    return args


def _load_config(args):
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.checkpoint import sidecar_dir

    # the config travels with the checkpoint (its run dir for a pinned
    # checkpoint_NNNNNNNN dir), else the data dir, else the defaults
    for src in [sidecar_dir(args.checkpoint) if args.checkpoint else None,
                args.data_dir]:
        if src and os.path.exists(os.path.join(src, "config.json")):
            cfg = RNNTConfig.load(src)
            break
    else:
        cfg = RNNTConfig()
    overrides = {}
    for kv in args.config_override:
        k, _, v = kv.partition("=")
        field_type = type(getattr(cfg, k))
        overrides[k] = field_type(v) if field_type is not bool else v == "True"
    return cfg.replace(**overrides) if overrides else cfg


def main(argv=None):
    args = parse_args(argv)

    import torch

    from rnnt_tpu_torch.data import pipeline
    from rnnt_tpu_torch.data.tokenizer import SUBWORD_FILENAME, get_tokenizer
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod
    from rnnt_tpu_torch.train.loop import run_evaluate, run_training
    from rnnt_tpu_torch.train.state import create_train_state

    dev = resolve_device(args.device)
    if args.checkpoint == "auto":
        args.checkpoint = (args.output_dir if ckpt_mod.list_checkpoint_steps(
            args.output_dir) else None)
    cfg = _load_config(args)
    os.makedirs(args.output_dir, exist_ok=True)

    # the tokenizer travels with the checkpoint's run dir, else the data dir
    tok_src = args.data_dir
    if args.checkpoint:
        cand = ckpt_mod.sidecar_dir(args.checkpoint, SUBWORD_FILENAME)
        if os.path.exists(os.path.join(cand, SUBWORD_FILENAME)):
            tok_src = cand
    tokenizer = get_tokenizer(tok_src, cfg.token_type, cfg.vocab_size)
    if cfg.token_type == "word-piece" and args.mode == "train":
        src = os.path.join(tok_src, SUBWORD_FILENAME)
        dst = os.path.join(args.output_dir, SUBWORD_FILENAME)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copy(src, dst)
    cfg = cfg.replace(vocab_size=tokenizer.vocab_size)
    # the sidecar records the training recipe: eval/test never rewrite it
    if args.mode == "train":
        cfg.save(args.output_dir)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.checkpoint:
        state = ckpt_mod.restore_checkpoint(args.checkpoint, cfg, dtype, dev)
    elif args.init_from:
        print(f"warm-start: weights from {args.init_from}, fresh "
              "optimizer/step")
        state = ckpt_mod.init_from_checkpoint(args.init_from, cfg, dtype, dev)
    else:
        state = create_train_state(cfg, dtype, dev)
    int8_exec = bool(args.quantized) and args.int8_exec
    if args.quantized:
        from rnnt_tpu_torch.ops.quantize import load_quantized_into_

        if int8_exec and args.mode == "train":
            sys.exit("--int8_exec is an inference path: use --mode "
                     "eval/test (beam decode routes through the XLA "
                     "beam's int8-aware pred/joint steps)")
        load_quantized_into_(state.model, args.quantized, int8_exec)
    mel_dtype = (torch.bfloat16 if args.transfer_dtype == "bfloat16"
                 else torch.float32)

    bucket_kw = {}
    if args.pad_frames and args.pad_tokens:
        bucket_kw = dict(t_buckets=[args.pad_frames],
                         u_buckets=[args.pad_tokens])

    def batches(split, shuffle=False):
        def gen(epoch=0):
            stream = pipeline.batches_from_shards(
                os.path.join(args.data_dir, f"{split}-*.rnr"), args.batch_size,
                shuffle_buffer=args.shuffle_buffer if shuffle else 0,
                seed=epoch * 9973,
                reader_threads=args.reader_threads if shuffle else 1,
                **bucket_kw)
            yield from pipeline.prefetch(stream, depth=2)
        return gen

    if args.mode == "train":
        run_training(cfg, state, batches("train", shuffle=True),
                     output_dir=args.output_dir,
                     eval_batches_fn=batches("dev"), tokenizer=tokenizer,
                     n_epochs=args.n_epochs, steps_per_log=args.steps_per_log,
                     steps_per_checkpoint=args.steps_per_checkpoint,
                     eval_max_batches=args.eval_size,
                     loss_impl=args.loss_impl, mel_dtype=mel_dtype)
        return state
    if not args.checkpoint:
        sys.exit("eval/test requires --checkpoint")
    split = "dev" if args.mode == "eval" else "test"
    t0 = time.time()
    # int8 joint weights cannot feed the loss; WER and CER are the int8
    # measurement
    metrics = run_evaluate(cfg, state.model, batches(split)(),
                           tokenizer=tokenizer, decode=args.decode,
                           loss_impl=args.loss_impl, mel_dtype=mel_dtype,
                           loss_metrics=not int8_exec)
    print(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    print(f"eval wall-clock: {time.time() - t0:.1f}s")
    return metrics


if __name__ == "__main__":
    main()
