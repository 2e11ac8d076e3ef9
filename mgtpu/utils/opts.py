"""Two-stage option parsing — rebuild of `/root/reference/opts.lua`:
global flags first, then the selected model's `arguments(parser)` hook
adds model-specific flags (`opts.lua:56-73`), and the run dir is derived
from the non-default flag string + timestamp (`opts.lua:79-88`), so
every run directory is self-describing."""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mgtpu training script", allow_abbrev=False
    )
    # ------------- General options ---------------------
    p.add_argument("-cache", default="checkpoint/", help="save/log dir root")
    p.add_argument("-data", default="/path/to/dataset/folder", help="dataset folder, or 'synthetic'")
    # ------------- Data options ------------------------
    p.add_argument("-manualSeed", type=int, default=2)
    p.add_argument("-GPU", type=int, default=1, help="kept for CLI parity (unused: devices come from -nGPU)")
    p.add_argument("-nGPU", type=int, default=1,
                   help="number of devices in the data-parallel mesh (0 = "
                        "all; more than are present is an error)")
    p.add_argument("-nDonkeys", type=int, default=2, help="data loading threads (0 = sync)")
    p.add_argument("-imageSize", type=int, default=256)
    p.add_argument("-imageCrop", type=int, default=224)
    p.add_argument("-colorspace", default="bgr", choices=["gray", "rgb", "bgr"])
    p.add_argument("-dataAug", default="default", help="default | affine | rotate")
    # ------------- Training options --------------------
    p.add_argument("-nEpochs", type=int, default=20)
    p.add_argument("-epochSize", type=int, default=10000, help="iterations per epoch")
    p.add_argument("-epochNumber", type=int, default=1, help="epoch to start from (restarts)")
    p.add_argument("-batchSize", type=int, default=128)
    p.add_argument("-iterSize", type=int, default=1, help="micro-batches per optim step")
    # ------------- Testing/Eval options ----------------
    p.add_argument("-nEpochsTest", type=int, default=1)
    p.add_argument("-nEpochsEval", type=int, default=1)
    p.add_argument("-nEpochsSave", type=int, default=1)
    p.add_argument("-tenCrop", action="store_true",
                   help="10-crop testing for ilsvrc (latent in the reference)")
    # ------------- Optimization options ----------------
    p.add_argument("-LR", type=float, default=0.0, help="overrides the model trainRule if set")
    p.add_argument("-momentum", type=float, default=0.9)
    p.add_argument("-weightDecay", type=float, default=5e-4)
    # ------------- Model options -----------------------
    p.add_argument("-netType", default="alexnet")
    p.add_argument("-dataset", default="ilsvrc")
    p.add_argument("-retrain", default="none", help="checkpoint to resume from")
    p.add_argument("-allowPickleCkpt", action="store_true",
                   help="permit loading legacy round-1 pickle checkpoints "
                        "(unpickling executes code; trusted files only)")
    # ------------- Run options -------------------------
    p.add_argument("-train", action="store_true")
    p.add_argument("-eval", action="store_true")
    p.add_argument("-test", action="store_true")
    p.add_argument("-pipeline", default="standard")
    p.add_argument("-saliencyBatch", type=int, default=4,
                   help="saliency pipeline: occlusion stacks per forward")
    p.add_argument("-saliencyDumpStack", type=int, default=1,
                   help="1 (default): write the full 842-stack output "
                        "per sample to testOutput.h5 like the reference "
                        "(saliency/test.lua:163-168) — ~14 MB/sample "
                        "device->host. 0: compute probe points + "
                        "saliency on device, dump only "
                        "{points,saliency,input} (~100 KB/sample)")
    # ------------- JAX-rebuild additions ---------------
    p.add_argument("-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype for conv/matmul. float32 runs at "
                        "XLA's default matmul precision (TF32 on Ampere "
                        "and later GPUs, see mgtpu/nn.py Conv)")
    p.add_argument("-hostCast", type=int, default=1, choices=[0, 1],
                   help="1 (default): cast input batches to the compute "
                        "dtype on the host before device transfer — "
                        "halves H2D bytes under -dtype bfloat16 (the "
                        "first conv casts its input anyway). 0: transfer "
                        "float32 and cast on device")
    p.add_argument("-synthSize", type=int, default=2000, help="synthetic dataset size")
    p.add_argument("-synthDisjoint", action="store_true",
                   help="synthetic data: perturb each split's class "
                        "prototypes independently so held-out accuracy "
                        "measures generalization, not memorization "
                        "(mgtpu/data/cifar.py)")
    p.add_argument("-resetMomentum", action="store_true",
                   help="zero SGD momentum at each epoch start — the "
                        "reference rebuilt optimState every epoch "
                        "(train.lua:48-55); default keeps momentum "
                        "(documented improvement)")
    p.add_argument("-remat", action="store_true",
                   help="rematerialize activations in the backward pass "
                        "(jax.checkpoint): slower, fits larger batches")
    p.add_argument("-donkeyMode", default="thread", choices=["thread", "process"],
                   help="donkey pool concurrency: threads share loaders "
                        "under the GIL; processes rebuild loaders per "
                        "worker (the reference's per-donkey-state model; "
                        "use for decode-heavy datasets like ilsvrc)")
    p.add_argument("-profile", default="", metavar="DIR",
                   help="capture a jax profiler trace of train iterations "
                        "2..9 of the first epoch into DIR (view with "
                        "tensorboard/xprof)")
    p.add_argument("-spatial", type=int, default=1,
                   help="shard input HEIGHT over this many devices (the "
                        "'model' mesh axis) in addition to -nGPU data "
                        "parallelism; XLA inserts the conv halo "
                        "exchanges. Total devices = nGPU * spatial")
    p.add_argument("-tensor", type=int, default=1,
                   help="shard CHANNELS over this many devices (tensor "
                        "parallelism on a 'tensor' mesh axis): every "
                        "conv's output-channel slice, its BN, and the "
                        "matching SGD momentum live on one device, so "
                        "param/optimizer memory scales 1/N; XLA inserts "
                        "the channel collectives. Total devices = nGPU * "
                        "tensor; mutually exclusive with -spatial")
    p.add_argument("-zero1", action="store_true",
                   help="shard the SGD momentum buffer over the data "
                        "axis (ZeRO stage 1): optimizer memory scales "
                        "1/nGPU; XLA inserts the reduce-scatter/"
                        "all-gather. No effect on the update values; "
                        "mutually exclusive with -tensor (which already "
                        "shards momentum 1/N over 'tensor')")
    p.add_argument("-logGradNorm", action="store_true",
                   help="add per-iteration training diagnostics to the "
                        "metric stream: global grad L2 norm (pre-weight-"
                        "decay), global param L2 norm after the update, "
                        "and the max |param update| of the step — the "
                        "instrumentation for chasing loss spikes / "
                        "effective-LR blowups (opt-in: three extra "
                        "reductions per step)")
    p.add_argument("-synthClasses", type=int, default=1000, help="synthetic ilsvrc classes")
    p.add_argument("-stopAfter", type=int, default=0,
                   help="exit cleanly after this epoch without changing "
                        "-nEpochs (which the LR schedules read): bounded "
                        "partial runs, continued by -retrain/-epochNumber "
                        "resume")
    p.add_argument("-multihost", action="store_true",
                   help="join a multi-host job via jax.distributed: "
                        "set MGTPU_COORDINATOR host:port, "
                        "MGTPU_NUM_PROCESSES and MGTPU_PROCESS_ID on "
                        "every host; the mesh then spans all hosts' "
                        "devices")
    p.add_argument("-split", type=int, default=0,
                   help="ilsvrc: split a single directory-per-class tree "
                        "N%%/(100-N)%% into train/test (0 = expect "
                        "pre-split train/ + val/ dirs)")
    p.add_argument("-evalSplit", type=int, default=0,
                   help="hold out N samples per class from the TRAIN set "
                        "as a validation split feeding -eval (seeded by "
                        "-manualSeed; classification datasets — the mnist "
                        "tasks carry a real valid split already). 0 keeps "
                        "the reference behavior (-eval falls back to the "
                        "test split with a warning)")
    return p


def parse(argv: Optional[Sequence[str]] = None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()

    # stage 2: model-contributed flags (opts.lua:56-73)
    net_type = ""
    for i, a in enumerate(argv):
        if a == "-netType" and i + 1 < len(argv):
            net_type = argv[i + 1]
        elif a.startswith("-netType="):  # argparse's '=' form
            net_type = a.split("=", 1)[1]
    if net_type:
        from mgtpu.models import get_net

        get_net(net_type).arguments(parser)

    opt = parser.parse_args(argv)
    if not (opt.train or opt.eval or opt.test):
        parser.error("Must specify at least one running scheme: train, eval or test.")

    import jax.numpy as jnp

    opt.compute_dtype = jnp.bfloat16 if opt.dtype == "bfloat16" else None

    # run dir: cache/<dataset>/<flag-string>/<date> (opts.lua:79-88)
    defaults = {a.dest: a.default for a in parser._actions}
    skip = {"netType", "retrain", "cache", "data", "help"}
    parts = []
    for k in sorted(vars(opt)):
        if k in skip or k not in defaults or k == "compute_dtype":
            continue
        v = getattr(opt, k)
        if v != defaults.get(k) and "/" not in str(v):
            parts.append(f"{k}={v}")
    flag_str = ",".join(parts) if parts else "default"
    # dots instead of the reference's ':' (opts.lua:87 os.date) — ':'
    # in paths breaks NTFS clones and scp; a sub-second suffix keeps
    # same-second launches (parallel sweeps) from sharing a run dir
    stamp = time.strftime("%a%b%d%H.%M.%S%Y").replace(" ", "")
    stamp += f".{int(time.time() * 1e6) % 1_000_000:06d}"
    opt.save = os.path.join(opt.cache, opt.dataset, opt.netType.replace("/", "_"),
                            flag_str, stamp)
    return opt
