"""Generate a synthetic end-to-end training and evaluation dataset (port
of misc/synth_dataset.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.synth_dataset out_dir [--ntrain 400] \\
        [--nholdout 20] [--nbases 3000] [--mean_dwell 9] [--noise 0.15] \\
        [--seed 1]

One generative model (a square-wave level per base, Gaussian noise,
Poisson dwells) gives:

  <out>/train.hdf5      a mapped-signal v8 file of ntrain reads
  <out>/holdout.fast5   a multi-read fast5 of nholdout reads (signal only)
  <out>/holdout_refs.fa the holdout reads' true references

Train on train.hdf5 (`cli.train_flipflop`), call holdout.fast5
(`cli.basecall`) and score the calls against holdout_refs.fa
(`cli.align`).  The draws are the JAX tool's, in its order, from
`np.random.default_rng(seed)`: the same reads, references and signals.
The files are written through h5py where it is installed, else through
the port's data/hdf5.Writer.
"""

import argparse
import os

import numpy as np

from taiyaki_tpu_torch.alphabet import AlphabetInfo
from taiyaki_tpu_torch.data import hdf5, mapped_signal_files
from taiyaki_tpu_torch.data.signal_mapping import SignalMapping

LEVELS = np.array([-1.0, -0.3, 0.4, 1.1])
BASES = "ACGT"


def synth_read(rng, nbases, mean_dwell, noise=0.15):
    reference = rng.integers(0, 4, size=nbases).astype(np.int16)
    dwells = np.maximum(2, rng.poisson(mean_dwell, size=nbases))
    ref_to_sig = np.concatenate([[0], np.cumsum(dwells)]).astype(np.int32)
    siglen = int(ref_to_sig[-1])
    current = np.repeat(LEVELS[reference], dwells)
    current = current + rng.normal(0, noise, size=siglen)
    dacs = np.clip(current * 1000, -32000, 32000).astype(np.int16)
    return reference, ref_to_sig, dacs


def get_parser():
    ap = argparse.ArgumentParser(
        description="Generate a synthetic mapped-signal training set, "
                    "holdout reads and their references")
    ap.add_argument("out_dir")
    ap.add_argument("--ntrain", type=int, default=400)
    ap.add_argument("--nholdout", type=int, default=20)
    ap.add_argument("--nbases", type=int, default=3000)
    ap.add_argument("--mean_dwell", type=float, default=9.0)
    ap.add_argument("--noise", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=1)
    return ap


def main(argv=None):
    args = get_parser().parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    ai = AlphabetInfo(BASES, BASES)

    train_path = os.path.join(args.out_dir, "train.hdf5")
    with mapped_signal_files.MappedSignalWriter(train_path, ai) as msw:
        for i in range(args.ntrain):
            reference, ref_to_sig, dacs = synth_read(
                rng, args.nbases, args.mean_dwell, args.noise)
            sm = SignalMapping(
                ref_to_sig, reference, read_id="synthtrain-%05d" % i,
                Dacs=dacs, shift_frompA=0.0, scale_frompA=1000.0,
                range=1.0, offset=0.0, digitisation=1.0)
            msw.write_read(sm.get_read_dictionary())

    f5_path = os.path.join(args.out_dir, "holdout.fast5")
    fa_path = os.path.join(args.out_dir, "holdout_refs.fa")
    h5py = mapped_signal_files._h5py()
    f5 = hdf5.Writer(f5_path) if h5py is None else h5py.File(f5_path, "w")
    with f5, open(fa_path, "w") as fa:
        for i in range(args.nholdout):
            rid = "synthhold-%05d" % i
            reference, ref_to_sig, dacs = synth_read(
                rng, args.nbases, args.mean_dwell, args.noise)
            fa.write(">{}\n{}\n".format(
                rid, "".join(BASES[b] for b in reference)))
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            # the Dacs are drawn at scale_frompA=1000: pA = dacs / 1000 =
            # (dacs + offset) * range / digitisation, the fast5 rule
            ch.attrs["digitisation"] = 8192.0
            ch.attrs["offset"] = 0.0
            ch.attrs["range"] = 8.192
            ch.attrs["sampling_rate"] = 4000.0
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = len(dacs)
            raw.attrs["read_number"] = i
            raw.attrs["median_before"] = 0.0
            raw.create_dataset("Signal", data=dacs)

    print("wrote {} ({} reads), {} + {} ({} reads)".format(
        train_path, args.ntrain, f5_path, fa_path, args.nholdout))


if __name__ == "__main__":
    main()
