"""Ranks of the port's data-parallel job on the CPU, for the tests of
tests/test_torch_multihost.py and tests/test_torch_hostsync.py: each
call of this script is one rank, joined through a file:// rendezvous.

    python tests/torch_dist_workers.py step INPUT RENDEZVOUS RANK WORLD OUTPUT
    python tests/torch_dist_workers.py sync CASE RENDEZVOUS RANK WORLD OUTPUT

Imports only PyTorch and the port (no JAX)."""

import os
import pickle
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from taiyaki_tpu_torch import train  # noqa: E402
from taiyaki_tpu_torch.convert import load_jax_params  # noqa: E402
from taiyaki_tpu_torch.parallel import mesh  # noqa: E402
from taiyaki_tpu_torch.utils import helpers, hostsync  # noqa: E402

CPU = torch.device("cpu")


def port_net(spec):
    """The port's network of `spec` with its (JAX-initialised) params."""
    net = helpers.new_model(spec["model"], **spec["kwargs"])[0]
    return load_jax_params(net, spec["params"])


def run_case(case, rank, group, net_of):
    """One case of a step: this rank's sub-batches through the gradient
    step on `group` (nvalid given where the case gives it, else reduced
    on the group), accumulated and applied once, and a second copy of the
    network through `train.make_train_step` where there is one
    sub-batch.  Returns the losses, the summed gradients, grad_maxs and
    the parameters after the update (leaf order)."""
    lr0, threshs = case["lr0"], case["threshs"]
    batches = [train.batch_to_device(train.Batch(*b), CPU)
               for b in case["batches"][rank]]
    nvalids = case.get("nvalid", [None] * len(batches))
    net = net_of()
    gstep = train.make_grad_step(net, group=group)
    losses, acc = [], None
    for b, n in zip(batches, nvalids):
        loss, grads = gstep(b, 1.0, 1.0, n)
        losses.append(float(loss))
        acc = train.accumulate_grads(acc, grads)
    out = dict(losses=losses, grads=[g.numpy().copy() for g in acc])
    if len(batches) == 1:
        # the fused step on a fresh copy: the same gradients, applied
        net = net_of()
        opt, _ = train.make_optimizer(train.leaf_params(net), 4e-3, 10, 2,
                                      lr0, 1e-4)
        loss, maxs = train.make_train_step(net, opt, group=group)(
            batches[0], 1.0, threshs, 1.0, nvalids[0])
        out["step_loss"] = float(loss)
    else:
        opt, _ = train.make_optimizer(train.leaf_params(net), 4e-3, 10, 2,
                                      lr0, 1e-4)
        maxs = train.make_apply_step(opt)(acc, float(len(batches)),
                                          threshs)
    out["maxs"] = maxs.numpy()
    out["params"] = [p.detach().numpy().copy()
                     for p in train.leaf_params(net)]
    return out


def step(inp, init, rank, world, outp):
    with open(inp, "rb") as fh:
        spec = pickle.load(fh)
    job = mesh.start(CPU, init, world, rank)
    try:
        res = {name: run_case(case, rank, job.group,
                              lambda: port_net(spec))
               for name, case in spec["cases"].items()}
        res["backend"] = job.backend
    finally:
        job.close()
    with open(outp, "wb") as fh:
        pickle.dump(res, fh)


def sync(case, init, rank, world, outp):
    """A case of the reducer (`utils.hostsync`): its results, or the error
    it raised and the seconds that took, pickled to `outp`."""
    job = mesh.start(CPU, init, world, rank)
    reducer = hostsync.start(timeout=60.0)
    res = {}
    try:
        if case == "max":
            res["max"] = reducer.reduce("0.0", [384, 512, 100][rank])
            res["total"] = reducer.total("0.0.n", rank + 1)
        elif case == "tags":
            vals = [[3, 700, 12, 128], [5, 6, 900, 128], [1, 1, 1, 1]][rank]
            res["max"] = [reducer.reduce("{}.0".format(i), v)
                          for i, v in enumerate(vals)]
        elif case == "thread":
            # the sampler's reductions on a thread of their own while the
            # main thread all-reduces on the gradient group, the two
            # interleaved differently on each rank
            got = []
            t = threading.Thread(target=lambda: got.extend(
                reducer.reduce("{}.0".format(i), 10 * rank + i)
                for i in range(20)))
            t.start()
            x = torch.full((4,), float(rank + 1))
            for _ in range(20):
                torch.distributed.all_reduce(x, group=job.group)
                time.sleep(0.001 * rank)
            t.join(timeout=60)
            res["max"] = got
            res["alive"] = t.is_alive()
        elif case == "mismatch":
            try:
                reducer.reduce("0.{}".format(rank), 1)
            except RuntimeError as e:
                res["error"] = str(e)
        elif case == "lost":
            reducer.reduce("0.0", rank)
            if rank == 1:            # a peer that dies mid-job
                with open(outp, "wb") as fh:
                    pickle.dump(res, fh)
                os._exit(0)
            t0 = time.monotonic()
            try:
                reducer.reduce("1.0", rank)
            except RuntimeError as e:
                res["error"], res["seconds"] = str(e), time.monotonic() - t0
            t0 = time.monotonic()
            try:
                reducer.reduce("2.0", rank)
            except RuntimeError as e:
                res["again"] = (str(e), time.monotonic() - t0)
    finally:
        if case != "lost":
            job.close()
    with open(outp, "wb") as fh:
        pickle.dump(res, fh)
    if case == "lost":
        os._exit(0)                  # the group's peer is gone


if __name__ == "__main__":
    torch.set_num_threads(1)
    what, arg, init, rank, world, outp = sys.argv[1:7]
    {"step": step, "sync": sync}[what](arg, init, int(rank), int(world),
                                       outp)
