"""Pipeline parallelism (GPipe) for the uniform transformer block stack.

Port of ``veles_tpu/parallel/pipeline.py``.  The L decoder blocks are
stacked along a leading layer axis and split over the ranks of a 1-axis
``('stage',)`` mesh: stage s holds blocks [s·L/S, (s+1)·L/S) on its
device; the embedding, positions, final LN and head stay replicated on
every rank.  Microbatches stream through the stages with the reference's
GPipe schedule: at tick t stage 0 takes in microbatch t, each stage runs
its blocks on the microbatch it holds, the last stage writes microbatch
t − (S − 1) into its output slot, and the activations hop one stage on.
One all-reduce of the last stage's outputs (zeros elsewhere) gives every
rank the result, as the reference's ``psum`` does.

The reference takes its backward from JAX's transpose of the schedule.
Here the whole schedule is one ``torch.autograd.Function``: the forward
keeps each microbatch's stage graph (from a detached input), and the
backward runs the ticks in reverse with the same exchanges on every
rank — a per-hop autograd node would run only where a rank's graph
reaches it, and stage 0 never reads what it receives.  The replicated
loss gives the last stage the whole cotangent of the outputs as it is;
stage 0's input gradient is summed over the stages (zeros elsewhere),
the transpose of the replicated input, so every rank's embedding
gradient is the same.  A stage runs only on the ticks that hold one of
its microbatches (the reference's bubble ticks compute values it never
reads).

Stages hop through ``parallel.p2p_exchange`` (under gloo, card tensors
go through host copies) and sum through the counted all-reduces of
``veles_tpu_torch.parallel``.
"""

from __future__ import annotations

import numpy
import torch
import torch.distributed as dist

from veles_tpu_torch import parallel
from veles_tpu_torch.ops.transformer import (block_forward, embed_tokens,
                                             nll_from_hidden, tree_leaves,
                                             tree_map)


def make_pipeline_mesh(n_stages):
    """1-axis ``('stage',)`` mesh over the first ``n_stages`` ranks of
    the joined run (every rank of the run must call this); with no
    joined run, over this one process."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_stages > world:
        raise ValueError("need %d devices, have %d" % (n_stages, world))
    group = guard = backend = None
    if dist.is_initialized():
        group = parallel._group(range(n_stages), world)
        backend = dist.get_backend()
        guard = (group if backend == "gloo"
                 else dist.new_group(list(range(n_stages)), backend="gloo"))
    return parallel.Mesh(numpy.arange(n_stages), ("stage",), rank,
                         parallel._JOINED.get("device"), backend,
                         data_group=group, guard_group=guard)


class StageBlocks(dict):
    """One stage's slice of a stacked block tree (leaves (L/S, ...)),
    with ``n_layers``, the whole stack's depth — what
    :func:`place_blocks` returns and a pipelined trainer keeps."""

    def __init__(self, tree, n_layers):
        super().__init__(tree)
        self.n_layers = n_layers


def stack_blocks(blocks):
    """[per-block param dict] -> one tree with a leading (L,) layer
    axis."""
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def unstack_blocks(stacked, n_layers):
    """Inverse of :func:`stack_blocks`."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n_layers)]


def _stage(mesh):
    """(this rank's stage, the stage count); raises outside the mesh."""
    if "stage" not in mesh.coords:
        raise ValueError("process %d is outside the %d-stage mesh"
                         % (mesh.process_index, mesh.shape["stage"]))
    return mesh.coords["stage"], mesh.shape["stage"]


def place_blocks(stacked_blocks, mesh):
    """This rank's stage of a stacked block tree (do this ONCE before a
    training loop; :func:`pipeline_blocks` then takes it as it is)."""
    n_layers = tree_leaves(stacked_blocks)[0].shape[0]
    stage, n_stages = _stage(mesh)
    if n_layers % n_stages:
        raise ValueError("n_layers %d %% n_stages %d != 0"
                         % (n_layers, n_stages))
    k = n_layers // n_stages
    return StageBlocks(tree_map(lambda x: x[stage * k:(stage + 1) * k],
                                stacked_blocks), n_layers)


def _out_slot(t, n_stages):
    """The output slot the last stage writes at tick ``t``: its
    microbatch, t − (S − 1)."""
    return t - (n_stages - 1)


def _output_cotangent(grad, group):
    """The last stage's cotangent of the replicated outputs: the loss is
    replicated, so every rank holds the whole cotangent already and it
    goes on as it is (summing it over the stages would scale every block
    gradient by their count)."""
    return grad


def _share_input_grad(dx, group):
    """Stage 0's input gradient, summed over the stages with the others'
    zeros (the transpose of the replicated input): every rank then holds
    it, and the replicated embedding's gradient agrees across ranks."""
    parallel.stage_input_grad_all_reduce(dx, group)
    return dx


class _Schedule:
    """One call's GPipe schedule on this rank: the forward ticks (with
    each microbatch's stage graph kept for a backward) and the reverse
    ticks."""

    def __init__(self, mesh, stage_blocks, n_heads, block_size):
        self.stage, self.n_stages = _stage(mesh)
        self.group = mesh.group("stage")
        self.keys = stage_blocks
        self.n_local = tree_leaves(stage_blocks)[0].shape[0]
        self.n_heads, self.block_size = n_heads, block_size
        self.kept = {}

    def _body(self, leaves, h):
        """This stage's blocks over ``h`` in order (one ``unbind`` a
        leaf: its backward stacks the blocks' gradients in one go)."""
        rows = [leaf.unbind(0) for leaf in leaves]
        for i in range(self.n_local):
            views = iter([row[i] for row in rows])
            blk = tree_map(lambda _: next(views), self.keys)
            h = block_forward(blk, h, self.n_heads, self.block_size)
        return h

    def _hop(self, send, like, t, forward):
        """The tick's neighbour exchange: ``send`` goes one stage on
        (forward) or back, and a tensor like ``like`` comes in when the
        neighbour on the other side ran a microbatch at tick ``t``."""
        if self.n_stages == 1:
            return None
        step = 1 if forward else -1
        dst, src = self.stage + step, self.stage - step
        m = self.m
        sends = ([send] if send is not None and 0 <= dst < self.n_stages
                 else None)
        likes = ([like] if 0 <= src < self.n_stages and 0 <= t - src < m
                 else None)
        got = parallel.p2p_exchange(sends, dst, likes, src, self.group)
        return got[0] if got else None

    def forward(self, x, leaves, keep):
        """Outputs (m, mb, ...) of the schedule over microbatches ``x``,
        the same on every rank; ``keep`` keeps the stage graphs (and
        detached aliases of ``leaves``) for :meth:`backward`."""
        stage, n = self.stage, self.n_stages
        self.m = m = x.shape[0]
        if keep:
            self.leaves = [leaf.detach().requires_grad_(leaf.requires_grad)
                           for leaf in leaves]
        else:
            self.leaves = list(leaves)
        outs = torch.zeros_like(x)
        buf = None
        for t in range(m + n - 1):
            j, out = t - stage, None
            if 0 <= j < m:
                h_in = x[j] if stage == 0 else buf
                if keep:
                    h_in = h_in.detach().requires_grad_()
                    with torch.enable_grad():
                        out = self._body(self.leaves, h_in)
                    self.kept[j] = (h_in, out)
                else:
                    out = self._body(self.leaves, h_in)
                slot = _out_slot(t, n)
                if stage == n - 1 and 0 <= slot < m:
                    outs[slot] = out.detach()
            buf = self._hop(None if out is None else out.detach(), x[0], t,
                            forward=True)
        if n > 1:
            parallel.stage_output_all_reduce(outs, self.group)
        return outs

    def backward(self, grad):
        """(the input gradient, every block leaf's gradient) from the
        outputs' cotangent ``grad``, by the reverse ticks."""
        stage, n, m = self.stage, self.n_stages, self.m
        grad = _output_cotangent(grad, self.group)
        wrt = [i for i, leaf in enumerate(self.leaves) if leaf.requires_grad]
        acc = [None] * len(self.leaves)
        dx = torch.zeros_like(grad)
        gbuf = None
        for t in reversed(range(m + n - 1)):
            j, dh = t - stage, None
            if 0 <= j < m:
                h_in, out = self.kept.pop(j)
                if stage == n - 1:
                    slot = _out_slot(t, n)
                    g_out = (grad[slot] if 0 <= slot < m
                             else torch.zeros_like(out))
                else:
                    g_out = gbuf
                grads = torch.autograd.grad(
                    out, [h_in] + [self.leaves[i] for i in wrt], g_out,
                    allow_unused=True)
                dh = grads[0]
                for i, g in zip(wrt, grads[1:]):
                    if g is None:
                        g = torch.zeros_like(self.leaves[i])
                    acc[i] = g if acc[i] is None else acc[i] + g
                if stage == 0:
                    dx[j] = dh
            gbuf = self._hop(dh, grad[0], t, forward=False)
        if n > 1:
            dx = _share_input_grad(dx, self.group)
        self.leaves = None
        return dx, acc


class _GPipe(torch.autograd.Function):
    """The whole schedule as one autograd node: inputs the microbatches
    and this stage's flat block leaves, output the replicated block
    stack outputs."""

    @staticmethod
    def forward(ctx, schedule, x, *leaves):
        ctx.schedule = schedule
        return schedule.forward(x, leaves, keep=True)

    @staticmethod
    def backward(ctx, grad):
        dx, dleaves = ctx.schedule.backward(grad.contiguous())
        ctx.schedule = None
        return (None, dx) + tuple(dleaves)


def pipeline_blocks(stacked_blocks, h, mesh, n_heads, n_microbatches,
                    block_size=None):
    """Run the block stack over ``h`` (batch, seq, d) with the GPipe
    schedule on ``mesh``'s ``stage`` axis; returns the transformed
    activations on every rank, equal to the sequential loop up to
    roundoff (and, at one stage, the same arithmetic bit for bit).

    ``stacked_blocks``: the whole stack (leaves (L, ...), from
    :func:`stack_blocks`; this rank takes its stage) or this rank's
    stage (:func:`place_blocks`).  batch must divide by n_microbatches;
    L by the stage count."""
    if not isinstance(stacked_blocks, StageBlocks):
        stacked_blocks = place_blocks(stacked_blocks, mesh)
    batch = h.shape[0]
    if batch % n_microbatches:
        raise ValueError("batch %d %% n_microbatches %d != 0"
                         % (batch, n_microbatches))
    x = h.reshape((n_microbatches, batch // n_microbatches) + h.shape[1:])
    leaves = tree_leaves(stacked_blocks)
    schedule = _Schedule(mesh, stacked_blocks, n_heads, block_size)
    if torch.is_grad_enabled() and (h.requires_grad or any(
            leaf.requires_grad for leaf in leaves)):
        out = _GPipe.apply(schedule, x, *leaves)
    else:
        with torch.no_grad():
            out = schedule.forward(x, leaves, keep=False)
    return out.reshape(h.shape)


def pipeline_lm_loss(params, tokens, mask, n_heads, mesh, n_microbatches,
                     block_size=None):
    """``transformer.lm_loss`` with the block stack run by the GPipe
    pipeline; ``params["blocks"]`` is the stacked tree (whole, or this
    rank's stage).  The embedding and the loss tail are the helpers
    ``lm_loss`` composes; only the block stack is staged."""
    h = embed_tokens(params, tokens[:, :-1])
    h = pipeline_blocks(params["blocks"], h, mesh, n_heads,
                        n_microbatches, block_size)
    return nll_from_hidden(params, h, tokens[:, 1:], mask)
