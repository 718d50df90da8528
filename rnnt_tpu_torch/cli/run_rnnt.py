"""Train or evaluate a model on preprocessed record shards, on the card
(PyTorch/CUDA port of `rnnt_tpu.cli.run_rnnt`, one process a device).

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
read fp joint weights).  --profile_dir P wraps the mode's work in
torch.profiler (CPU activities, and CUDA activities on the card) and
writes a Chrome trace under P.  --loss_impl banded trains (and, in
eval/test, scores) on the banded loss with the config's loss_band.

--multihost runs data parallel over torch.distributed, one process a
device (NCCL on the card, gloo on the CPU): each process is started with
--coordinator_address HOST:PORT --num_processes N --process_id I, or by
torchrun, whose environment gives the same (then the three flags are left
out).  --batch_size is then each process's batch (the global batch is
batch_size x N), --pad_frames and --pad_tokens are required (every rank
runs the same shapes), each process reads its own shards, the epochs run
in lockstep (the fewest batches any rank keeps), the BatchNorm statistics
and the loss are the global batch's, eval sums its statistics across
ranks and process 0 reports, and checkpoints are collective
(checkpoint_NNNNNNNN.dcp; --ckpt_backend auto picks dcp across processes).
--model_parallel M (with --multihost; M divides the process count) lays
the processes out as a (N/M data, M model) grid, row-major: the M ranks of
a data row read the same batches (--batch_size is then each data row's),
the joint's W2 and b2 are column-sharded over the vocabulary across them
when M divides V (else replicated), the fused and banded losses run on the
shards and combine the planes over the model group, the encoder and the
prediction net are replicated, eval decodes with W2 gathered over the
model group, and checkpoints hold the whole W2 (npz, written by rank 0,
when the grid is one data row; dcp otherwise).  --ckpt_backend orbax is
the JAX package's and refused (the port writes npz or dcp).
"""

from __future__ import annotations

import argparse
import itertools
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
    p.add_argument("--batch_size", type=int, default=32,
                   help="examples a step; under --multihost each data "
                        "row's (each process's at --model_parallel 1)")
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
                   help="model-axis size: vocab tensor parallelism over "
                        "that many processes (needs --multihost)")
    p.add_argument("--loss_impl", default="fused",
                   choices=["fused", "banded", "auto", "ref", "pallas"],
                   help="fused = joint + loss kernels, never materialising "
                        "the lattice logits (exact); banded = the same "
                        "kernels over a label window of the config's "
                        "loss_band around the alignment diagonal, a "
                        "lower-bound objective on the log-likelihood that "
                        "is exact when the band covers U+1; auto, ref and "
                        "pallas materialise the logits (pallas: the lattice "
                        "kernel, else the plain lattice)")
    p.add_argument("--decode", default="greedy", choices=["greedy", "beam"],
                   help="eval-time decoder")
    p.add_argument("--quantized", default=None, metavar="MODEL_INT8_NPZ",
                   help="int8-quantized weights (cli.quantize_model output), "
                        "dequantized: measures the WER delta against fp")
    p.add_argument("--int8_exec", action="store_true",
                   help="with --quantized: execute the prediction net's and "
                        "joint's products in int8 (eval/test only; no loss "
                        "metrics)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here "
                        "(run_rnnt_<mode>.pt.trace.json); meant for runs "
                        "of a few steps: the trace is held in host memory "
                        "until the run ends")
    p.add_argument("--ckpt_backend", default="auto",
                   choices=["auto", "npz", "dcp", "orbax"],
                   help="auto = dcp (torch.distributed.checkpoint, "
                        "collective) across processes, npz otherwise; "
                        "orbax is the JAX package's and is refused")
    p.add_argument("--multihost", action="store_true",
                   help="data parallel over torch.distributed, one process "
                        "a device (see above)")
    p.add_argument("--coordinator_address", default=None,
                   help="HOST:PORT of process 0 (omit under torchrun)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--pad_frames", type=int, default=0,
                   help="pad every batch to this many mel frames (one "
                        "static shape instead of (T, U) buckets); "
                        "required with --multihost")
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
    if args.model_parallel > 1 and not args.multihost:
        p.error("--model_parallel > 1 runs one process a device: start "
                "every process with --multihost (or torchrun)")
    if args.model_parallel > 1 and args.quantized:
        p.error("--quantized loads replicated inference weights: evaluate "
                "an int8 artifact without --model_parallel")
    if args.ckpt_backend == "orbax":
        p.error("--ckpt_backend orbax: the PyTorch port cannot write orbax "
                "checkpoints; use dcp (collective) or npz")
    if args.multihost and not (args.pad_frames and args.pad_tokens):
        p.error("--multihost requires --pad_frames/--pad_tokens: every "
                "rank must run the same batch shape each step (bucketed "
                "per-rank padding would desynchronise the collectives)")
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

    import torch.distributed as dist

    # a process group this call creates is destroyed when it returns
    owns_group = args.multihost and not dist.is_initialized()
    try:
        return _run(args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args):
    import torch

    from rnnt_tpu_torch.data import pipeline
    from rnnt_tpu_torch.data import records as records_mod
    from rnnt_tpu_torch.data.tokenizer import SUBWORD_FILENAME, get_tokenizer
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod
    from rnnt_tpu_torch.train.loop import run_evaluate, run_training
    from rnnt_tpu_torch.train.state import create_train_state

    mesh = None
    if args.multihost:
        dev = mesh_mod.init_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            args.device)
        if mesh_mod.dist.get_world_size() % args.model_parallel:
            sys.exit(f"--model_parallel {args.model_parallel} does not "
                     f"divide the {mesh_mod.dist.get_world_size()} "
                     "processes")
        mesh = mesh_mod.make_mesh(data=-1, model=args.model_parallel,
                                  device=dev)
        if args.mode == "train" and args.batch_size % mesh.shape["data"]:
            sys.exit(f"--batch_size {args.batch_size} must be divisible by "
                     f"the data-axis size {mesh.shape['data']} of the "
                     f"{mesh.shape} mesh")
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
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
    # every rank has read the sidecars before the first rank rewrites them
    mesh_mod.barrier(mesh)
    if cfg.token_type == "word-piece" and args.mode == "train" and lead:
        src = os.path.join(tok_src, SUBWORD_FILENAME)
        dst = os.path.join(args.output_dir, SUBWORD_FILENAME)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copy(src, dst)
    cfg = cfg.replace(vocab_size=tokenizer.vocab_size)
    # the sidecar records the training recipe: eval/test never rewrite it
    if args.mode == "train" and lead:
        cfg.save(args.output_dir)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.checkpoint:
        state = ckpt_mod.restore_checkpoint(args.checkpoint, cfg, dtype, dev,
                                            mesh)
    elif args.init_from:
        if lead:
            print(f"warm-start: weights from {args.init_from}, fresh "
                  "optimizer/step")
        state = ckpt_mod.init_from_checkpoint(args.init_from, cfg, dtype, dev,
                                              mesh)
    else:
        state = create_train_state(cfg, dtype, dev)
    # every rank starts from rank 0's parameters, then keeps its shard
    mesh_mod.broadcast_module_(state.model, mesh)
    if mesh is not None:
        mesh_mod.shard_state_(state, mesh.vocab_shard(cfg.vocab_size))
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

    # each read group (one rank on the data axis) reads its own shards
    read_group, read_groups = (mesh_mod.data_read_group(mesh)
                               if mesh is not None else (0, 1))
    steps_per_epoch = None
    if mesh is not None and args.mode == "train":
        # lockstep: a rank that ran out of batches while the others step
        # would hang their collectives, so every epoch stops at the fewest
        # batches any rank keeps (a metadata scan, counting only the
        # examples inside the --pad_frames/--pad_tokens bounds)
        kept = sum(1 for d in records_mod.scan_lengths(
            os.path.join(args.data_dir, "train-*.rnr"),
            process_index=read_group, process_count=read_groups)
            if d.get("spec_lengths", 0) <= args.pad_frames
            and d.get("label_lengths", 0) <= args.pad_tokens)
        counts = mesh_mod.all_gather_ints(-(-kept // args.batch_size), mesh)
        steps_per_epoch = min(counts)
        if lead:
            print(f"multi-process lockstep: {steps_per_epoch} steps/epoch "
                  f"(per-rank batch counts {counts})")

    def batches(split, shuffle=False):
        def gen(epoch=0):
            stream = pipeline.batches_from_shards(
                os.path.join(args.data_dir, f"{split}-*.rnr"), args.batch_size,
                process_index=read_group, process_count=read_groups,
                shuffle_buffer=args.shuffle_buffer if shuffle else 0,
                # seeded by read group: replicas of one group read alike
                seed=epoch * 9973 + read_group,
                reader_threads=args.reader_threads if shuffle else 1,
                **bucket_kw)
            out = pipeline.prefetch(stream, depth=2)
            if steps_per_epoch is not None and split == "train":
                out = itertools.islice(out, steps_per_epoch)
            yield from out
        return gen

    def run_mode():
        if args.mode == "train":
            run_training(cfg, state, batches("train", shuffle=True),
                         output_dir=args.output_dir,
                         eval_batches_fn=batches("dev"), tokenizer=tokenizer,
                         n_epochs=args.n_epochs,
                         steps_per_log=args.steps_per_log,
                         steps_per_checkpoint=args.steps_per_checkpoint,
                         eval_max_batches=args.eval_size,
                         loss_impl=args.loss_impl, mel_dtype=mel_dtype,
                         ckpt_backend=args.ckpt_backend, mesh=mesh)
            return state
        split = "dev" if args.mode == "eval" else "test"
        t0 = time.time()
        # int8 joint weights cannot feed the loss; WER and CER are the int8
        # measurement
        metrics = run_evaluate(cfg, state.model, batches(split)(),
                               tokenizer=tokenizer, decode=args.decode,
                               loss_impl=args.loss_impl, mel_dtype=mel_dtype,
                               loss_metrics=not int8_exec, mesh=mesh)
        if lead:
            print(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            print(f"eval wall-clock: {time.time() - t0:.1f}s")
        return metrics

    if args.mode != "train" and not args.checkpoint:
        sys.exit("eval/test requires --checkpoint")
    if not args.profile_dir:
        return run_mode()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        result = run_mode()
    os.makedirs(args.profile_dir, exist_ok=True)
    rank = f".rank{mesh.rank}" if mesh is not None and mesh.size > 1 else ""
    path = os.path.join(args.profile_dir,
                        f"run_rnnt_{args.mode}{rank}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")
    return result


if __name__ == "__main__":
    main()
