#!/usr/bin/env python3
"""Parent/change A/B of the PyTorch/CUDA port's earlier paths on one NVIDIA
card:

    python3 chip_ab.py PARENT_TREE CHANGE_TREE

Each tree is an unpacked checkout (for example `git archive <commit>`).
The script writes one set of inputs into a temporary directory (8
synthetic fast5 reads of 100 000 samples), then, in a fresh process per
tree in the order parent, change, change, parent, drives that tree's own
package (its kernels built from its own sources) through the calls a user
makes:

- the CRF loss `ops.flipflop.crf_flipflop_loss` forward and backward at
  T=800, B=256, L=512 (kernels 5-6 and their glue), CUDA events over 5
  warmed calls;
- for mLstm_flipflop (256/5/19) and mGru_flipflop (256/2/19): the training
  CLI twice, 8 iterations of 256 chunks x 4000 samples on
  mapped_remap_samref.hdf5 (steps/s in the loop, as the CLI reports it;
  the first run of the process pays its one-time costs), then the
  basecall CLI with its defaults on the reads with the checkpoint that
  the second run wrote, three calls (ksample/s of the second and third).

It prints one line `AB <tree> {json}` per run, removes what it wrote, and
exits non-zero if there is no card or a run fails.

    python3 chip_ab.py --basecall PARENT_TREE CHANGE_TREE

runs the basecall CLI alone, on one seeded size-256 checkpoint of each
model written once for both trees (no training in the process), three
measured calls after a first, in the order parent, change, change,
parent, parent, change.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

MODELS = (("mLstm_flipflop", 5), ("mGru_flipflop", 2))


def write_reads(path, n, length, seed):
    """A multi-read fast5 of n synthetic step-like signals."""
    from taiyaki_tpu_torch.data.hdf5 import Writer
    rng = np.random.default_rng(seed)
    with Writer(path) as f5:
        for i in range(n):
            rid = "read{:02d}".format(i)
            levels = rng.normal(500.0, 60.0, size=length // 8 + 1)
            dacs = np.repeat(levels, 8)[:length] \
                + rng.normal(0, 8.0, size=length)
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k, v in (("digitisation", 8192.0), ("offset", 4.0),
                         ("range", 1400.0), ("sampling_rate", 4000.0)):
                ch.attrs[k] = v
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = length
            raw.create_dataset("Signal", data=dacs.astype("i2"))


def crf_loss_ms(torch, dev):
    """ms of one CRF loss forward and backward at T=800, B=256, L=512."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    rng = np.random.default_rng(1)
    T, B, L = 800, 256, 512
    lp = torch.tensor(rng.normal(size=(T, B, 40)).astype(np.float32),
                      device=dev, requires_grad=True)
    seqlens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    seqs = torch.tensor(seqs, device=dev)
    seqlens = torch.tensor(seqlens, device=dev)

    def once():
        lp.grad = None
        flipflop.crf_flipflop_loss(lp, seqs, seqlens).sum().backward()
    once()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        once()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def measure(reads, work):
    """The numbers of the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from taiyaki_tpu_torch.cli import basecall, train_flipflop
    from taiyaki_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        sys.exit("chip_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build_all()
    out = {"crf_loss_ms": crf_loss_ms(torch, torch.device("cuda", 0))}
    mapped = os.path.join(os.getcwd(), "RESULTS", "training_ingredients",
                          "mapped_remap_samref.hdf5")
    for name, stride in MODELS:
        rates = []
        for k in range(2):
            outdir = os.path.join(work, "{}{}".format(name, k))
            stats = train_flipflop.main([
                "--size", "256", "--stride", str(stride), "--winlen", "19",
                "--chunk_len_min", "4000", "--chunk_len_max", "4000",
                "--min_sub_batch_size", "256", "--niteration", "8",
                "--warmup_batches", "2", "--save_every", "4",
                "--sample_nreads_before_filtering", "1000",
                "--reporting_sub_batches", "1", "--seed", "1", "--quiet",
                "--outdir", outdir,
                os.path.join("taiyaki_tpu_torch", "models", name + ".py"),
                mapped])
            rates.append(stats["iterations"] / stats["seconds"])
        out[name + "_train_steps_s"] = rates
        rates = []
        for i in range(3):
            st = basecall.main([
                "--output", os.path.join(work, "{}{}.fa".format(name, i)),
                "--quiet", reads,
                os.path.join(outdir, "model_final.checkpoint")])
            rates.append(st["nsample"] / st["seconds"] / 1e3)
        out[name + "_basecall_ksample_s"] = rates[1:]
    return out


def measure_basecall(reads, work, checkpoints):
    """ksample/s of the basecall CLI of the tree in the working directory
    on each checkpoint ({model: path}), three calls after a first."""
    sys.path.insert(0, os.getcwd())
    import torch
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        sys.exit("chip_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build_all()
    out = {}
    for name, ckpt in json.loads(checkpoints).items():
        rates = []
        for i in range(4):
            st = basecall.main([
                "--output", os.path.join(work, "{}{}.fa".format(name, i)),
                "--quiet", reads, ckpt])
            rates.append(st["nsample"] / st["seconds"] / 1e3)
        out[name + "_basecall_ksample_s"] = rates[1:]
    return out


def seeded_checkpoints(tmp, tree):
    """{model: path} of a size-256 checkpoint of each model with weights
    drawn from seed 1, written by the package of `tree` (on sys.path)."""
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.utils import helpers
    out = {}
    for name, stride in MODELS:
        kwargs = dict(insize=1, size=256, winlen=19, stride=stride)
        net, source, meta = helpers.new_model(
            os.path.join(tree, "taiyaki_tpu_torch", "models",
                         name + ".py"),
            model_metadata={"reverse": False, "standardize": True},
            **kwargs)
        load_jax_params(net, net.init(np.random.default_rng(1)))
        outdir = os.path.join(tmp, name)
        os.makedirs(outdir)
        out[name] = helpers.save_model(outdir, net, params_to_jax(net),
                                       source, kwargs, meta)
    return out


def main():
    if sys.argv[1:2] == ["--measure"]:
        print("AB " + json.dumps(measure(*sys.argv[2:4])), flush=True)
        return
    if sys.argv[1:2] == ["--measure-basecall"]:
        print("AB " + json.dumps(measure_basecall(*sys.argv[2:5])),
              flush=True)
        return
    basecall_only = sys.argv[1:2] == ["--basecall"]
    trees = sys.argv[2:] if basecall_only else sys.argv[1:]
    if len(trees) != 2:
        sys.exit(__doc__)
    parent, change = (os.path.abspath(d) for d in trees)
    order = ((parent, change, change, parent, parent, change)
             if basecall_only else (parent, change, change, parent))
    failed = False
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as tmp:
        reads = os.path.join(tmp, "reads")
        os.makedirs(reads)
        sys.path.insert(0, change)
        write_reads(os.path.join(reads, "r.fast5"), 8, 100000, 1)
        if basecall_only:
            extra = [json.dumps(seeded_checkpoints(tmp, change))]
        for k, tree in enumerate(order):
            work = os.path.join(tmp, "run{}".format(k))
            os.makedirs(work)
            cmd = ([sys.executable, os.path.abspath(__file__),
                    "--measure-basecall", reads, work] + extra
                   if basecall_only else
                   [sys.executable, os.path.abspath(__file__), "--measure",
                    reads, work])
            r = subprocess.run(cmd, cwd=tree, capture_output=True,
                               text=True)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("AB ")]
            if r.returncode != 0 or not lines:
                sys.stderr.write(r.stderr[-3000:])
                failed = True
                break
            print("AB {} {}".format(tree, lines[-1][3:]), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
