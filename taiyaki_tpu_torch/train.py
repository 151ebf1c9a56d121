"""Training: optimizer and schedules, batch preparation, loss and step
(port of taiyaki_tpu/train.py).

One step runs the network forward (the LSTM forward kernel with its
backward residuals), the CRF loss (lattice forward kernel; for a cat_mod
model the cat_mod loss, whose mod weights scale by the step's mod factor)
plus logZ/nblk of the canonical columns (logZ forward kernel), autograd's
backward (CRF backward, logZ posteriors and LSTM backward kernels; cuDNN
for the convolutions), a per-tensor clip by value and an AdamW update
whose learning rate, and with min_momentum its beta1, follow the JAX
package's optax schedules.

Everything runs on an explicit torch device; random draws come from
numpy (the global state for chunk sampling, as in the JAX package, and
explicit Generators elsewhere), so one seed draws the same data in both
packages.  Gradients, clip thresholds and `grad_maxs` follow the JAX
parameter pytree's leaf order (`convert.leaf_names`).
"""

import math
from collections import namedtuple

import numpy as np
import torch

from taiyaki_tpu_torch import flipflopfings
from taiyaki_tpu_torch.convert import flat_params, leaf_names, name_tree
from taiyaki_tpu_torch.data import chunk_selection
from taiyaki_tpu_torch.ops import flipflop as ffops
from taiyaki_tpu_torch.utils.helpers import OptaxState, optax_class


# -- optimizer ---------------------------------------------------------------

def _cosine_interpolate(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def make_schedule(lr_max, niteration, warmup_batches, lr_warmup, lr_min):
    """Learning rate of optimizer step `count` (0 for the first step), as
    optax computes it in the JAX package: cosine_onecycle_schedule, or with
    no warmup cosine_decay_schedule from lr_max down to lr_min."""
    if warmup_batches <= 0:
        alpha = lr_min / lr_max

        def schedule(count):
            count = min(float(count), float(niteration))
            decay = 0.5 * (1.0 + math.cos(math.pi * count / niteration))
            return lr_max * ((1.0 - alpha) * decay + alpha)
        return schedule

    div_factor = lr_max / lr_warmup
    final_div_factor = lr_warmup / lr_min
    bounds = [0, int(warmup_batches / niteration * niteration),
              int(niteration)]
    values = np.cumprod([lr_max / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count):
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                return float(_cosine_interpolate(values[k], values[k + 1],
                                                 pct))
        return float(values[-1])
    return schedule


def make_b1_schedule(b1, min_momentum, niteration, warmup_batches):
    """Adam beta1 of optimizer step `count`: fixed at b1, or with
    min_momentum annealed inversely to the learning rate (b1 down to
    min_momentum over the warmup and back over the decay)."""
    if min_momentum is None:
        return lambda count: b1
    m_max, m_min = b1, min_momentum
    warm = max(1, warmup_batches)
    decay_steps = max(1, niteration - warm)

    def schedule(count):
        if count < warm:
            frac = min(count / warm, 1.0)
            return m_max + (m_min - m_max) * 0.5 * (1.0 - math.cos(
                math.pi * frac))
        frac = min(max((count - warm) / decay_steps, 0.0), 1.0)
        return m_min + (m_max - m_min) * 0.5 * (1.0 - math.cos(
            math.pi * frac))
    return schedule


# the optax classes of the JAX trainer's optimizer state (optax 0.2), by
# the module its checkpoints name each under
_OPTAX_MODULES = {"ScaleByAdamState": "optax._src.transform",
                  "EmptyState": "optax._src.base",
                  "ScaleByScheduleState": "optax._src.transform",
                  "InjectStatefulHyperparamsState": "optax.schedules._inject",
                  "WrappedScheduleState": "optax.schedules._inject"}


def _optax(name, *fields):
    return optax_class(_OPTAX_MODULES[name], name)(*fields)


def _optax_names(state):
    """The class names of an optax state, nested as its tuples are."""
    if isinstance(state, OptaxState):
        return state.optax_name
    if type(state) is tuple:
        return tuple(_optax_names(x) for x in state)
    return type(state).__name__


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


class Optimizer:
    """torch.optim.AdamW over `params` (in leaf order) with the learning
    rate and beta1 of each step written into its param group from the
    schedules before the step, as optax's inject_hyperparams does.

    `count` is the schedules' step count and `adam_count` Adam's; both
    start at 0 and advance together, and both come from a checkpoint's
    optimizer state (`load_jax_state`), which `jax_state` writes back in
    the JAX trainer's optax layout: (ScaleByAdamState(count, mu, nu),
    EmptyState(), ScaleByScheduleState(count)), or with momentum cycling
    (`inject`) InjectStatefulHyperparamsState(count, hyperparams,
    {"b1", "learning_rate": WrappedScheduleState(count)},
    (ScaleByAdamState, EmptyState(), EmptyState()))."""

    def __init__(self, params, schedule, b1_schedule, b2, eps,
                 weight_decay, inject=False):
        self.params = list(params)
        self.schedule = schedule
        self.b1_schedule = b1_schedule
        self.b2, self.eps, self.weight_decay = b2, eps, weight_decay
        self.inject = inject
        self.count = self.adam_count = 0
        self.opt = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(b1_schedule(0), b2),
            eps=eps, weight_decay=weight_decay)

    def step(self, grads):
        """One update with `grads` (one tensor per parameter)."""
        for p, g in zip(self.params, grads):
            p.grad = g
        group = self.opt.param_groups[0]
        group["lr"] = self.schedule(self.count)
        group["betas"] = (self.b1_schedule(self.count), self.b2)
        self.opt.step()
        self.count += 1
        self.adam_count += 1

    def jax_state(self, net):
        """The state as the JAX trainer's optax optimizer keeps it (numpy
        leaves, `OptaxState`s), for `net`, whose parameters in leaf order
        are this optimizer's."""
        by_name = dict(zip(leaf_names(net), self.params))

        def moment(key):
            def leaf(name):
                p = by_name[name]
                v = self.opt.state.get(p, {}).get(key)
                v = torch.zeros_like(p) if v is None else v
                return v.detach().cpu().numpy().astype(np.float32)
            return _tree_map(name_tree(net), leaf)

        adam = _optax("ScaleByAdamState",
                      np.asarray(self.adam_count, np.int32),
                      moment("exp_avg"), moment("exp_avg_sq"))
        count = np.asarray(self.count, np.int32)
        if not self.inject:
            return (adam, _optax("EmptyState"),
                    _optax("ScaleByScheduleState", count))
        # the hyperparameters optax computed at the last update
        last = max(self.count - 1, 0)
        hyper = {k: np.asarray(v, np.float32) for k, v in (
            ("b1", self.b1_schedule(last)), ("b2", self.b2),
            ("eps", self.eps), ("eps_root", 0.0),
            ("learning_rate", self.schedule(last)),
            ("weight_decay", self.weight_decay))}
        return _optax("InjectStatefulHyperparamsState", count, hyper,
                      {k: _optax("WrappedScheduleState", count)
                       for k in ("b1", "learning_rate")},
                      (adam, _optax("EmptyState"), _optax("EmptyState")))

    def load_jax_state(self, net, state):
        """Take Adam's moments and both step counts from `state`, a JAX
        trainer's optax state in either layout of `jax_state` (as a
        checkpoint holds it), so that training and its schedules continue
        where it stopped.  Raises, naming its classes, on a layout that is
        not this optimizer's."""
        names = _optax_names(state)
        if not self.inject and names == ("ScaleByAdamState", "EmptyState",
                                         "ScaleByScheduleState"):
            adam, count = state[0], state[2][0]
        elif self.inject and names == "InjectStatefulHyperparamsState" \
                and _optax_names(state[3]) == ("ScaleByAdamState",
                                               "EmptyState", "EmptyState") \
                and set(state[2]) == {"b1", "learning_rate"}:
            adam, count = state[3][0], state[2]["learning_rate"][0]
        else:
            raise ValueError(
                "the checkpoint's optimizer state {} is not the layout of "
                "AdamW {} momentum cycling".format(
                    names, "with" if self.inject else "without"))
        mu, nu = (flat_params(t) for t in adam[1:3])
        want = leaf_names(net)
        if set(mu) != set(want) or set(nu) != set(want):
            raise ValueError("the checkpoint's optimizer moments do not "
                             "match the network's parameters")
        for name, p in zip(want, self.params):
            self.opt.state[p] = {
                "step": torch.tensor(float(adam[0])),
                "exp_avg": torch.as_tensor(np.asarray(
                    mu[name], np.float32)).reshape(p.shape).to(p.device),
                "exp_avg_sq": torch.as_tensor(np.asarray(
                    nu[name], np.float32)).reshape(p.shape).to(p.device)}
        self.adam_count, self.count = int(adam[0]), int(count)


def make_optimizer(params, lr_max, niteration, warmup_batches, lr_warmup,
                   lr_min, adam_betas=(0.9, 0.999), eps=1e-6,
                   weight_decay=0.01, min_momentum=None):
    """AdamW with the one-cycle cosine learning rate (and optionally
    momentum cycling) of the JAX package's make_optimizer.

    Returns:
        (Optimizer, schedule): schedule(count) is the learning rate of
        step `count`.
    """
    schedule = make_schedule(lr_max, niteration, warmup_batches, lr_warmup,
                             lr_min)
    b1_schedule = make_b1_schedule(adam_betas[0], min_momentum, niteration,
                                   warmup_batches)
    return (Optimizer(params, schedule, b1_schedule, adam_betas[1], eps,
                      weight_decay, inject=min_momentum is not None),
            schedule)


def linear_ramp(start, final, niter):
    """Per-iteration linear schedule (sharpening, mod factor)."""
    def value(curr_iter):
        return float(start + (final - start) * min(1.0, curr_iter / niter))
    return value


# -- gradient clipping -------------------------------------------------------

class GradientCapper:
    """Per-tensor clip by value at the rolling median + n MADs of recent
    per-tensor gradient maxima (inf until the window fills)."""

    def __init__(self, nparams, n_mads, window=1000):
        from taiyaki_tpu_torch.maths import RollingMAD
        self.rolling_mads = (None if n_mads is None
                             else RollingMAD(nparams, n_mads, window))
        self._threshs = np.full(nparams, np.inf, dtype=np.float32)

    @property
    def thresholds(self):
        return self._threshs

    def update(self, grad_maxs):
        """Feed this step's per-tensor |grad| maxima; returns the
        thresholds for the next step."""
        if self.rolling_mads is None:
            return self._threshs
        out = self.rolling_mads.update(grad_maxs)
        if out is not None:
            self._threshs = np.asarray(out, dtype=np.float32)
        return self._threshs


# -- batch preparation -------------------------------------------------------

Batch = namedtuple("Batch", ("signal", "seqs", "seqlens", "mod_cats"))


def chunk_len_buckets(chunk_len_min, chunk_len_max, stride, nbuckets=8):
    """Fixed set of chunk lengths (multiples of stride) spanning the
    range."""
    lo = max(stride, (chunk_len_min // stride) * stride)
    hi = max(lo, (chunk_len_max // stride) * stride)
    vals = np.unique(np.round(
        np.linspace(lo, hi, nbuckets) / stride).astype(np.int64) * stride)
    return [int(v) for v in vals]


def max_seqlen_for_chunk(chunk_len, stride, path_buffer=1.1):
    """Padded sequence length bound for a chunk length: a chunk passing the
    path-buffer filter has seq_len < chunk_len / (stride * path_buffer)."""
    return int(np.ceil(chunk_len / (stride * path_buffer)))


def bucket_seqlen(actual_max_seqlen, bound, granularity=128):
    """min(bound, ceil(actual/granularity)*granularity), at least
    granularity; granularity None or 0 returns bound."""
    if not granularity:
        return bound
    bucket = int(np.ceil(max(1, actual_max_seqlen) / granularity))
    return min(bound, max(granularity, bucket * granularity))


def sub_batch_size_for_chunk(min_sub_batch_size, chunk_len_max, chunk_len):
    """Sub-batch size inversely proportional to the chunk length."""
    return int(min_sub_batch_size * chunk_len_max / chunk_len + 0.5)


def prepare_batch(chunks, chunk_len, max_seqlen, alphabet_info,
                  reverse=False, can_labels=None, mod_labels=None):
    """Accepted chunks as padded numpy arrays; with a cat_mod head's
    label tables (can_labels, mod_labels) the sequences are coded from
    the canonical labels and mod_cats holds each position's category.

    Returns:
        Batch(signal [chunk_len, n, 1] f32, seqs [n, max_seqlen] i32,
              seqlens [n] i32, mod_cats [n, max_seqlen] i32 or None);
        chunks whose sequence is longer than max_seqlen are dropped.
    """
    chunks = [c for c in chunks if c.seq_len <= max_seqlen]
    n = len(chunks)
    signal = np.zeros((chunk_len, n, 1), dtype=np.float32)
    seqs = np.zeros((n, max_seqlen), dtype=np.int32)
    seqlens = np.zeros(n, dtype=np.int32)
    is_mod = mod_labels is not None
    mod_cats = np.zeros((n, max_seqlen), dtype=np.int32) if is_mod else None
    revop = np.flip if reverse else np.asarray
    for i, chunk in enumerate(chunks):
        signal[:, i, 0] = revop(chunk.current)
        labels = revop(chunk.sequence)
        seqlens[i] = len(labels)
        if is_mod:
            mod_cats[i, :len(labels)] = mod_labels[labels]
            labels = can_labels[labels]
        coded = flipflopfings.flipflop_code(np.ascontiguousarray(labels),
                                            alphabet_info.ncan_base)
        seqs[i, :len(coded)] = coded
    return Batch(signal, seqs, seqlens, mod_cats)


def sample_batch(read_data, batch_chunk_len, sub_batch_size, max_seqlen,
                 alphabet_info, filter_params, reverse=False,
                 standardize=True, can_labels=None, mod_labels=None,
                 select_strands_randomly=True, first_strand_index=0,
                 log=None, seqlen_granularity=None, seqlen_reduce=None):
    """Sample and filter chunks and assemble a Batch; with
    seqlen_granularity, sequences pad to the smallest multiple of it that
    fits the batch instead of to max_seqlen.  The bucket depends on the
    data each rank drew, so a multi-process job passes `seqlen_reduce`, a
    callable mapping this rank's longest sequence to the length every rank
    agrees on (the global max, `utils.hostsync`), and every rank pads to
    the same bucket.

    Returns:
        (Batch, rejection_counts)
    """
    chunk_batch, rejections = chunk_selection.sample_chunks(
        read_data, sub_batch_size, batch_chunk_len, filter_params,
        standardize=standardize,
        select_strands_randomly=select_strands_randomly,
        first_strand_index=first_strand_index)
    if len(chunk_batch) < sub_batch_size and log is not None:
        log.write("* Warning: only {} chunks passed filters (asked for "
                  "{}).\n".format(len(chunk_batch), sub_batch_size))
    if seqlen_granularity:
        actual = max((c.seq_len for c in chunk_batch), default=1)
        if seqlen_reduce is not None:
            actual = int(seqlen_reduce(actual))
        max_seqlen = bucket_seqlen(actual, max_seqlen, seqlen_granularity)
    batch = prepare_batch(chunk_batch, batch_chunk_len, max_seqlen,
                          alphabet_info, reverse=reverse,
                          can_labels=can_labels, mod_labels=mod_labels)
    return batch, rejections


def batch_to_device(batch, device):
    """A numpy Batch as tensors on `device`."""
    return Batch(*(None if a is None
                   else torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in batch))


# -- loss & step -------------------------------------------------------------

def make_loss_fn(net, is_cat_mod=False, can_mods_offsets=None,
                 mod_cat_weights=None):
    """Training loss of a batch on the device: CRF flip-flop loss (the
    cat_mod loss with weights mod_cat_weights x mod_factor for a cat_mod
    model) + logZ/nblk of the transition columns per row, summed over the
    rows with a sequence (rows with seqlens == 0 are padding and cost
    nothing) and divided by their count, or by `nvalid` where given (a
    rank's share of a global batch divides by the global count)."""
    if is_cat_mod:
        weights = np.asarray(mod_cat_weights, dtype=np.float32)

    def loss_fn(batch, sharpen, mod_factor=1.0, nvalid=None):
        outputs = net(batch.signal)
        nblk = outputs.shape[0]
        ntrans = outputs.shape[2]
        if is_cat_mod:
            ntrans -= int(can_mods_offsets[-1])
            lossvector = ffops.cat_mod_flipflop_loss(
                outputs, batch.seqs, batch.seqlens, batch.mod_cats,
                can_mods_offsets, weights * np.float32(mod_factor), sharpen)
        else:
            lossvector = ffops.crf_flipflop_loss(outputs, batch.seqs,
                                                 batch.seqlens, sharpen)
        logz = ffops.flipflop_logz(outputs[:, :, :ntrans]) / nblk
        real = batch.seqlens > 0
        lossvector = lossvector + torch.where(real, logz,
                                              torch.zeros_like(logz))
        if nvalid is None:
            nvalid = torch.clamp(real.sum(), min=1)
        else:
            nvalid = torch.tensor(max(int(nvalid), 1), device=real.device)
        return lossvector.sum() / nvalid

    return loss_fn


def leaf_params(net):
    """`net`'s parameters in the JAX parameter pytree's leaf order."""
    named = dict(net.named_parameters())
    return [named[name] for name in leaf_names(net)]


def make_grad_step(net, is_cat_mod=False, can_mods_offsets=None,
                   mod_cat_weights=None, group=None):
    """(loss, grads in leaf order) of one sub-batch.

    With a process `group` (a data-parallel job, `parallel.mesh.start`),
    the batch is this rank's share of the global one, as the JAX mesh
    step shards it: the loss is the local sum over rows with a sequence
    divided by the global count of such rows (`nvalid`, all-reduced on
    the group where not given), and the gradients and loss are summed
    over the group in one flattened all-reduce, so every rank returns the
    global batch's loss and gradients."""
    import torch.distributed as dist
    loss_fn = make_loss_fn(net, is_cat_mod, can_mods_offsets,
                           mod_cat_weights)
    params = leaf_params(net)

    def gstep(batch, sharpen, mod_factor=1.0, nvalid=None):
        if group is not None and nvalid is None:
            count = (batch.seqlens > 0).sum().reshape(1)
            dist.all_reduce(count, group=group)
            nvalid = int(count)
        loss = loss_fn(batch, sharpen, mod_factor, nvalid)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = loss.detach()
        if group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            parts = flat.split([g.numel() for g in grads] + [1])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            loss = parts[-1][0]
        return loss, grads

    return gstep


def accumulate_grads(acc, grads):
    """Running sum of gradient lists."""
    if acc is None:
        return [g.clone() for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


def make_apply_step(optimizer):
    """Average accumulated grads over n_sub, measure each tensor's max
    |grad|, clip by value at clip_threshs and take one optimizer step.
    Returns grad_maxs (a tensor, in leaf order)."""

    def astep(grads, n_sub, clip_threshs):
        grads = [g / n_sub for g in grads]
        grad_maxs = torch.stack([g.abs().max() for g in grads])
        clipped = [torch.clamp(g, -float(t), float(t))
                   for g, t in zip(grads, clip_threshs)]
        optimizer.step(clipped)
        return grad_maxs

    return astep


def make_train_step(net, optimizer, is_cat_mod=False, can_mods_offsets=None,
                    mod_cat_weights=None, group=None):
    """step(batch, sharpen, clip_threshs, mod_factor, nvalid) -> (loss,
    grad_maxs): forward, backward, clip and update in one call; with a
    process `group`, on the global batch's gradients (`make_grad_step`),
    which every rank's update then sees alike."""
    gstep = make_grad_step(net, is_cat_mod, can_mods_offsets,
                           mod_cat_weights, group)
    astep = make_apply_step(optimizer)

    def step(batch, sharpen, clip_threshs, mod_factor=1.0, nvalid=None):
        loss, grads = gstep(batch, sharpen, mod_factor, nvalid)
        return loss, astep(grads, 1.0, clip_threshs)

    return step
