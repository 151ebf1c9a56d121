"""Devices for data-parallel work, and the training process group (port
of taiyaki_tpu/parallel/mesh.py).

The JAX package drives every chip of a host from one process over a 1-D
('data',) mesh.  The port keeps that form only where one process splits
a batch itself: a mesh here is an ordered list of torch devices, and
basecall's --ndevices runs one replica of the network on each.  Training
runs one process per card instead, each a rank of a torch.distributed
job (`start`): every rank samples its own share of the global batch,
and the gradient step all-reduces a flattened bucket of gradients
(`train.make_grad_step`) over the job's gradient group.  That group is
NCCL where every rank has a card of its own and gloo otherwise (NCCL
refuses two ranks on one card; gloo all-reduces CUDA tensors through
the host), and always gloo on the CPU.
"""

import datetime
import os
import socket
from collections import namedtuple

import torch

# the JAX trainer's rendezvous variables (bin/train_flipflop.py), then
# torchrun's
COORDINATOR_VARS = ("TAIYAKI_COORDINATOR", "TAIYAKI_NUM_PROCS",
                    "TAIYAKI_PROC_ID")
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def data_mesh(devices=None):
    """An ordered list of torch devices: `devices`, or every visible
    card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def local_data_mesh():
    """Every card of this host (a process sees only its host's)."""
    return data_mesh()


def round_batch_to_mesh(batch_size, mesh):
    """Largest multiple of the mesh size <= batch_size, at least one row
    per device: a batch splits evenly over the mesh, and callers treat
    batch_size as a ceiling."""
    n = len(mesh)
    per = max(1, batch_size // n)
    return per * n


def rendezvous(environ=None):
    """(init_method, world_size, rank) of this process from the
    environment: tcp://$TAIYAKI_COORDINATOR with $TAIYAKI_NUM_PROCS and
    $TAIYAKI_PROC_ID where they are set, else torchrun's env:// variables.
    Raises ValueError, naming both sets, where neither is complete."""
    env = os.environ if environ is None else environ
    if all(k in env for k in COORDINATOR_VARS):
        return ("tcp://" + env["TAIYAKI_COORDINATOR"],
                int(env["TAIYAKI_NUM_PROCS"]), int(env["TAIYAKI_PROC_ID"]))
    if all(k in env for k in TORCHRUN_VARS):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    raise ValueError(
        "multi-process training needs {} (host:port of rank 0, the number "
        "of processes, this process's rank) or torchrun's {} in the "
        "environment".format(", ".join(COORDINATOR_VARS),
                             ", ".join(TORCHRUN_VARS)))


def _card_key(device):
    """What tells this process's card from another's: the host and, on a
    card, its UUID (its index where torch gives none)."""
    card = "cpu"
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        card = str(getattr(props, "uuid", device.index))
    return socket.gethostname(), device.type, card


class Job(namedtuple("Job", ("rank", "world_size", "device", "group",
                             "backend"))):
    """This process's place in a training job: its rank, the number of
    ranks, its device, and the group (and its backend) that the gradient
    step all-reduces over."""

    @property
    def is_lead(self):
        return self.rank == 0

    def broadcast(self, value):
        """Rank 0's `value` (any picklable object) on every rank."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def close(self):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def start(device, init_method=None, world_size=None, rank=None,
          timeout=600.0):
    """Join the job's process group on `device` (a torch.device); the
    rendezvous defaults to `rendezvous()`.  The default group is gloo;
    the gradient group is a NCCL group when every rank is on a card of
    its own, else the default group.  Returns a `Job`."""
    import torch.distributed as dist
    if init_method is None:
        init_method, world_size, rank = rendezvous()
    timeout = datetime.timedelta(seconds=timeout)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    keys = [None] * world_size
    dist.all_gather_object(keys, _card_key(device))
    if all(k[1] == "cuda" for k in keys) and len(set(keys)) == world_size:
        torch.cuda.set_device(device)
        return Job(rank, world_size, device,
                   dist.new_group(backend="nccl", timeout=timeout), "nccl")
    return Job(rank, world_size, device, dist.group.WORLD, "gloo")
