"""Mixture-of-experts FFN with expert parallelism.

Port of ``veles_tpu/ops/moe.py``: a top-1-routed expert FFN used in
place of the transformer's dense FFN, and an expert-parallel form over
``torch.distributed`` where each rank computes the share of E/n experts
for the whole batch and the combine is one all-reduce over the mesh's
``expert`` axis.

As in the reference, dispatch is mask-based with static shapes: every
expert runs over every token as one batched product, and a one-hot
mask keeps each token's chosen expert.  Nothing here reads the card on
the host (no ``nonzero``, no ``.item()``, no data-dependent size), so a
serving step or a captured train step stays sync-free.  Ties go to the
first expert (``argmax``), as ``jnp.argmax`` breaks them.  The
straight-through gate scales each token's output by its router
probability, so the router takes its gradient through that scale.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch.ops.functional import matmul, relu


def init_moe_params(stream, d_model, d_ff, n_experts, dtype="float32"):
    """Host (numpy) router and per-expert FFN weights, drawn from
    ``stream`` in the reference's order (router, w1, w2), expert-major
    leading axis."""

    def fill(shape, fan_in, fan_out):
        w = numpy.zeros(shape, dtype)
        s = (6.0 / (fan_in + fan_out)) ** 0.5
        stream.fill(w, -s, s)
        return w

    return {
        "router": fill((d_model, n_experts), d_model, n_experts),
        "w1": fill((n_experts, d_model, d_ff), d_model, d_ff),
        "b1": numpy.zeros((n_experts, d_ff), dtype),
        "w2": fill((n_experts, d_ff, d_model), d_ff, d_model),
        "b2": numpy.zeros((n_experts, d_model), dtype),
    }


def router_probs(params, x):
    """(tokens, E) softmax router probabilities; x (..., d_model) is
    flattened to tokens."""
    flat = x.reshape(-1, x.shape[-1])
    return torch.softmax(matmul(flat, params["router"]), dim=-1)


def _expert_ffn(w1, b1, w2, b2, x):
    """Every expert's FFN over all tokens x (T, d), one batched product
    over the expert axis of w1 (E, d, d_ff): (E, T, d).  x is expanded
    over that axis, so each expert is one entry of the batch whatever E
    is (``torch.matmul`` would fold a 2-D x into one product E·d_ff wide,
    whose weight gradient sums in another order for another E): an
    expert-parallel rank's share is the one-device share."""
    x = x.expand(w1.shape[0], *x.shape)
    h = relu(matmul(x, w1) + b1.unsqueeze(-2))
    return matmul(h, w2) + b2.unsqueeze(-2)


def load_balancing_loss(probs, onehot, token_mask=None):
    """Switch-Transformer auxiliary loss E·Σ_e f_e·P_e: f_e the fraction
    of tokens routed to expert e, P_e its mean router probability.  1.0
    at perfect balance, E when routing collapses onto one expert.
    ``token_mask`` (T,) restricts both to live tokens."""
    if token_mask is not None:
        m = token_mask[:, None].to(probs.dtype)
        denom = torch.clamp_min(m.sum(), 1.0)
        f = (onehot * m).sum(dim=0) / denom
        p = (probs * m).sum(dim=0) / denom
    else:
        f = onehot.mean(dim=0)
        p = probs.mean(dim=0)
    return probs.shape[-1] * torch.sum(f * p)


def _route(params, flat):
    """(probs (T, E), gate (T, 1), one-hot (T, E)) of top-1 routing."""
    probs = router_probs(params, flat)
    top = torch.argmax(probs, dim=-1)
    gate = probs.gather(-1, top[:, None])
    experts = torch.arange(probs.shape[-1], device=flat.device)
    return probs, gate, (top[:, None] == experts).to(flat.dtype)


def moe_ffn(params, x, return_aux=False, token_mask=None):
    """Top-1 routed MoE FFN on one device: every expert over every
    token, the masked combine keeping each token's chosen expert scaled
    by its gate.  ``return_aux=True`` also returns the load-balancing
    loss (over live tokens when ``token_mask`` is given)."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    probs, gate, onehot = _route(params, flat)
    expert_out = _expert_ffn(params["w1"], params["b1"], params["w2"],
                             params["b2"], flat)           # (E, T, d)
    out = (torch.einsum("etd,te->td", expert_out, onehot)
           * gate).reshape(shape)
    if return_aux:
        return out, load_balancing_loss(probs, onehot, token_mask)
    return out


EXPERT_KEYS = ("w1", "b1", "w2", "b2")


def _expert_range(n_experts, mesh, expert_axis):
    """(first expert, experts a rank) of this rank on ``expert_axis``."""
    n = mesh.shape[expert_axis]
    if n_experts % n:
        raise ValueError("n_experts %d %% mesh axis %d != 0"
                         % (n_experts, n))
    k = n_experts // n
    return mesh.index(expert_axis) * k, k


def expert_slice(params, mesh, expert_axis="expert"):
    """The tree a rank of ``mesh``'s ``expert_axis`` holds under expert
    parallelism, as the reference places it: the router whole, ``w1``,
    ``b1``, ``w2`` and ``b2`` cut to the rank's E/n experts (views of
    ``params``'; copy them to drop the whole tree)."""
    lo, k = _expert_range(params["router"].shape[-1], mesh, expert_axis)
    return dict(params, **{key: params[key][lo:lo + k]
                           for key in EXPERT_KEYS})


def moe_ffn_ep(params, x, mesh, expert_axis="expert"):
    """Expert-parallel MoE FFN: rank r of the mesh's ``expert_axis``
    (n ranks) computes experts [r·E/n, (r+1)·E/n) for the whole batch;
    their masked shares are summed with one counted all-reduce
    (``parallel.ep_all_reduce``) and scaled by the gate.  ``params`` is
    the whole tree (E experts, the rank's cut here) or the rank's own
    (:func:`expert_slice`: E/n experts, E read from the router).
    Numerically :func:`moe_ffn`, values and gradients: the experts'
    input gradient is summed over the group in the backward
    (``parallel.ep_input_grad_all_reduce``), and each rank's router
    gradient (through the gate) is the whole one."""
    from veles_tpu_torch import parallel
    n_experts = params["router"].shape[-1]
    lo, k = _expert_range(n_experts, mesh, expert_axis)
    held = params["w1"].shape[0]
    if held == n_experts:
        params = expert_slice(params, mesh, expert_axis)
    elif held != k:
        raise ValueError("the expert weights hold %d experts: neither all "
                         "%d nor a rank's %d" % (held, n_experts, k))
    group = mesh.group(expert_axis)
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    _, gate, onehot = _route(params, flat)
    expert_out = _expert_ffn(                               # (E/n, T, d)
        params["w1"], params["b1"], params["w2"], params["b2"],
        parallel.ep_input_grad_all_reduce(flat, group))
    local = torch.einsum("etd,te->td", expert_out, onehot[:, lo:lo + k])
    return (parallel.ep_all_reduce(local, group) * gate).reshape(shape)
