"""One training step of a size-16 mGru_flipflop under the JAX package's
mixed precision, the port's TAIYAKI_TPU_BF16_STREAMS=1 beside it, on the
CPU: is the port's mixed step as far from f32 as the JAX package's mixed
step is, or further?

One network is initialised once (seed 4) and its weights are carried into
the port with `convert.load_jax_params`.  One batch of B chunks is drawn
from the repo's mapped reads by the JAX sampler (seed 2, the last row
padded, as the CPU tests draw it).  Four steps run on it: the JAX step in
f32, the JAX mixed step (TAIYAKI_TPU_PALLAS_INTERPRET=1: the Pallas
kernels in interpret mode with the TPU's stream dtypes), the port's f32
step and the port's step under the switch.  For the loss and each
gradient it prints

    port-vs-jax-mixed   the port's mixed step from the JAX mixed step,
    jax-mixed-vs-f32    the JAX mixed step from the JAX f32 step,
    port-mixed-vs-f32   the port's mixed step from the port's f32 step,

each as a fraction of the reference gradient's largest |value| (the loss:
relative).  The port's rounding is what tests/test_torch_bf16_scores.py
allows a size-16 step against the JAX mixed step: half of the JAX route's
own distance from f32.  The last line is one JSON object with the three
largest distances and the verdict.

Run from the root of the repo (a T=2000 step in interpret mode takes
minutes):

    JAX_PLATFORMS=cpu python3 probes/mgru_bf16_scores.py --chunk 4000
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SWITCHES = ("TAIYAKI_TPU_BF16_STREAMS", "TAIYAKI_TPU_PALLAS_INTERPRET",
            "TAIYAKI_TPU_F32_GATES", "TAIYAKI_TPU_BF16_ACTS",
            "TAIYAKI_TPU_F32_GRADS", "TAIYAKI_TPU_F32_SCORES",
            "TAIYAKI_TPU_NO_SCORE_FUSE", "TAIYAKI_TPU_RECOMPUTE",
            "TAIYAKI_TPU_NO_RECOMPUTE")


def sample(chunk, n, seed=2):
    """n chunks of `chunk` samples of the repo's mapped reads, drawn by the
    JAX sampler, the last row padded (seqlen 0)."""
    import numpy as np
    from taiyaki_tpu import train as jtrain
    from taiyaki_tpu.data import chunk_selection as jcs
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    path = os.path.join(ROOT, "RESULTS", "training_ingredients",
                        "mapped_remap_samref.hdf5")
    with jmsf.MappedSignalReader(path) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = jcs.sample_filter_parameters(reads, 50, chunk, 3.0, 10.0, 0.5, 5,
                                      1.1)
    batch, _ = jtrain.sample_batch(reads, chunk, n,
                                   jtrain.max_seqlen_for_chunk(chunk, 5),
                                   alphabet, fp, seqlen_granularity=128)
    batch = jtrain.Batch(batch.signal, batch.seqs, batch.seqlens.copy(),
                         None)
    batch.seqlens[-1] = 0
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=4000,
                    help="samples a chunk (T = chunk / stride)")
    ap.add_argument("--batch", type=int, default=8,
                    help="chunks (a multiple of 8: the JAX kernels' path)")
    ap.add_argument("--stride", type=int, default=2)
    args = ap.parse_args(argv)
    for k in SWITCHES:
        os.environ.pop(k, None)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from taiyaki_tpu import train as jtrain
    from taiyaki_tpu.models import mGru_flipflop as jmodel
    from taiyaki_tpu_torch import train as ttrain
    from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
    from taiyaki_tpu_torch.models import mGru_flipflop as tmodel
    torch.set_num_threads(1)

    kwargs = dict(insize=1, size=16, winlen=19, stride=args.stride)
    jnet, tnet = jmodel.network(**kwargs), tmodel.network(**kwargs)
    params = jnet.init(np.random.default_rng(4))
    load_jax_params(tnet, params)
    batch = sample(args.chunk, args.batch)
    jbatch = jtrain.Batch(*(None if a is None else jnp.asarray(a)
                            for a in batch))
    tbatch = ttrain.batch_to_device(batch, torch.device("cpu"))
    loss_fn = jax.value_and_grad(jtrain.make_loss_fn(jnet))
    tstep = ttrain.make_grad_step(tnet)

    def jax_step():
        loss, grads = loss_fn(params, jbatch, 1.0)
        return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]

    def port_step():
        loss, grads = tstep(tbatch, 1.0)
        return float(loss), [g.numpy() for g in grads]

    steps = {}
    for name, env, fn in (("jax f32", {}, jax_step),
                          ("jax mixed",
                           {"TAIYAKI_TPU_PALLAS_INTERPRET": "1"}, jax_step),
                          ("port f32", {}, port_step),
                          ("port mixed", {"TAIYAKI_TPU_BF16_STREAMS": "1"},
                           port_step)):
        os.environ.update(env)
        t0 = time.time()
        steps[name] = fn()
        for k in env:
            os.environ.pop(k)
        print("{}: loss {!r} ({:.1f} s)".format(name, steps[name][0],
                                                time.time() - t0),
              flush=True)

    pairs = {"port-vs-jax-mixed": ("port mixed", "jax mixed"),
             "jax-mixed-vs-f32": ("jax mixed", "jax f32"),
             "port-mixed-vs-f32": ("port mixed", "port f32")}
    names = ["loss"] + list(leaf_names(tnet))
    table = {k: [] for k in pairs}
    for key, (a, b) in pairs.items():
        la, ga = steps[a]
        lb, gb = steps[b]
        table[key].append(abs(la - lb) / abs(lb))
        for x, y in zip(ga, gb):
            table[key].append(float(np.abs(x - y).max()
                                    / max(np.abs(y).max(), 1e-30)))
    T = args.chunk // args.stride
    print("mGru_flipflop size 16, stride {}, T={}, B={}; distances as "
          "fractions of the reference's largest |value|".format(
              args.stride, T, args.batch))
    print("{:<28} {:>18} {:>18} {:>18}".format("", *pairs))
    for i, name in enumerate(names):
        print("{:<28} {:>18.3e} {:>18.3e} {:>18.3e}".format(
            name, *(table[k][i] for k in pairs)))
    worst = {k: max(v[1:]) for k, v in table.items()}
    within = all(p <= 0.5 * r for p, r in zip(table["port-vs-jax-mixed"],
                                             table["jax-mixed-vs-f32"]))
    print(json.dumps({"T": T, "B": args.batch,
                      "largest": worst,
                      "loss": {k: v[0] for k, v in table.items()},
                      "port_within_half_of_jax_route": within}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
