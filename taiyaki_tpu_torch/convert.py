"""Weights across the two packages.

The JAX package keeps parameters as a numpy pytree of nested dicts and
lists (`net.init(rng)`, the `params` of a checkpoint); the port keeps them
in its modules, named so that the pytree's keys joined with "." are the
module's `state_dict` keys ("sublayers.3.layer.iW").
"""

from collections import OrderedDict

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, "{}{}.".format(prefix, k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, "{}{}.".format(prefix, i), out)
    else:
        out[prefix[:-1]] = tree
    return out


def params_from_jax(net, params):
    """The port's state for `net` from a JAX parameter pytree.

    Returns an OrderedDict of f32 CPU tensors with `net.state_dict()`'s
    keys and shapes; raises if the pytree does not fit `net`.
    """
    flat = flat_params(params)
    want = net.state_dict()
    if set(flat) != set(want):
        raise ValueError(
            "parameter pytree does not match the network: missing {}, "
            "unexpected {}".format(sorted(set(want) - set(flat)),
                                   sorted(set(flat) - set(want))))
    state = OrderedDict()
    for key, ref in want.items():
        val = torch.from_numpy(np.array(flat[key], dtype=np.float32))
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError("parameter {} has shape {}, the network wants "
                             "{}".format(key, tuple(val.shape),
                                         tuple(ref.shape)))
        state[key] = val
    return state


def load_jax_params(net, params):
    """Load a JAX parameter pytree into `net` (in place); returns `net`."""
    net.load_state_dict(params_from_jax(net, params))
    return net


def params_to_jax(net):
    """`net`'s weights as the JAX package's numpy pytree, for a checkpoint
    that both packages load."""
    if isinstance(net, nn.ModuleList):
        return [params_to_jax(m) for m in net]
    tree = {name: p.detach().cpu().numpy().astype(np.float32)
            for name, p in net.named_parameters(recurse=False)}
    for name, child in net.named_children():
        tree[name] = params_to_jax(child)
    return tree


def flat_params(tree):
    """A JAX parameter pytree (or one shaped like it) as {state_dict key:
    leaf}."""
    return _flatten(tree, "", OrderedDict())


def name_tree(net):
    """`net`'s parameter pytree with each leaf its state_dict key."""
    return _name_tree(net, "")


def _name_tree(net, prefix):
    if isinstance(net, nn.ModuleList):
        return [_name_tree(m, "{}{}.".format(prefix, i))
                for i, m in enumerate(net)]
    tree = {name: prefix + name
            for name, _ in net.named_parameters(recurse=False)}
    for name, child in net.named_children():
        tree[name] = _name_tree(child, prefix + name + ".")
    return tree


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def leaf_names(net):
    """`net`'s parameter names in the leaf order of the JAX parameter
    pytree (`jax.tree.leaves`: dict keys sorted, lists in order), the
    order of the JAX trainer's per-tensor clip thresholds and gradient
    maxima; an Lstm's parameters come as b, iW, sW."""
    return _leaves(name_tree(net), [])
